"""gemma-7b [dense]: 28L d=3072 16H (kv=16, MHA) d_ff=24576 vocab=256000,
GeGLU, head_dim=256, embedding scaling, (1+w) RMSNorm. [arXiv:2403.08295]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense", n_layers=28, d_model=3072,
        n_heads=16, n_kv_heads=16, d_ff=24576, vocab_size=256000,
        head_dim=256, mlp_type="geglu", norm_plus_one=True,
        embed_scale=True, tie_embeddings=True)


def reduced_config() -> ModelConfig:
    return config().scaled(name="gemma-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=4, d_ff=128, head_dim=32,
                           vocab_size=256)
