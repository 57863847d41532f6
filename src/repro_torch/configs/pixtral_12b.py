"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) d_ff=14336 vocab=131072,
head_dim=128 (mistral-nemo backbone); vision frontend is a STUB — the
input spec provides precomputed patch embeddings.
[hf:mistralai/Pixtral-12B-2409]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
        head_dim=128, mlp_type="swiglu", frontend="vision_stub",
        n_patches=256, rope_theta=1_000_000.0)


def reduced_config() -> ModelConfig:
    return config().scaled(name="pixtral-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
                           vocab_size=256, n_patches=8)
