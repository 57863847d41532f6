"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave (1 attn per 8-layer period),
MoE 16 experts top-2 on every second layer. Mamba d_state=16.
[arXiv:2403.19887]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
        n_experts=16, top_k=2, moe_every=2, attn_period=8, attn_index=4,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, mlp_type="swiglu")


def reduced_config() -> ModelConfig:
    return config().scaled(name="jamba-smoke", n_layers=4, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                           n_experts=4, top_k=2, attn_period=4, attn_index=2,
                           ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
