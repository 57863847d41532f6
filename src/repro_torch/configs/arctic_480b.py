"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, 128 experts top-2 PLUS a dense residual MLP per layer
(dense-MoE hybrid). head_dim=128. [hf:Snowflake/snowflake-arctic-base]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
        head_dim=128, n_experts=128, top_k=2, dense_residual=True,
        mlp_type="swiglu")


def reduced_config() -> ModelConfig:
    return config().scaled(name="arctic-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=96, head_dim=16,
                           vocab_size=256, n_experts=4, top_k=2)
