"""qwen3-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk-norm, head_dim 128. [hf:Qwen/Qwen3-8B]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=12288, vocab_size=151936,
        head_dim=128, qk_norm=True, mlp_type="swiglu",
        rope_theta=1_000_000.0)


def reduced_config() -> ModelConfig:
    return config().scaled(name="qwen3-8b-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
                           vocab_size=256)
