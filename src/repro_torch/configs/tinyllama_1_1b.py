"""tinyllama-1.1b [dense]: 22L d=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
Llama-2 architecture. [arXiv:2401.02385]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000,
        mlp_type="swiglu")


def reduced_config() -> ModelConfig:
    return config().scaled(name="tinyllama-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
