"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, sliding-window attention (4096). [arXiv:2401.04088]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
        n_experts=8, top_k=2, window=4096, mlp_type="swiglu")


def reduced_config() -> ModelConfig:
    return config().scaled(name="mixtral-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                           n_experts=4, top_k=2, window=32)
