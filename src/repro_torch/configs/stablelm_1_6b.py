"""stablelm-1.6b [dense]: 24L d=2048 32H (kv=32, MHA) d_ff=5632
vocab=100352, LayerNorm, partial rotary 25%.
[hf:stabilityai/stablelm-2-1_6b]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=5632, vocab_size=100352,
        norm_type="layernorm", rope_pct=0.25, mlp_type="swiglu")


def reduced_config() -> ModelConfig:
    return config().scaled(name="stablelm-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
