"""mamba2-1.3b [ssm]: 48L d=2048, attention-free SSD, d_state=128,
vocab=50280. [arXiv:2405.21060]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, tie_embeddings=True)


def reduced_config() -> ModelConfig:
    return config().scaled(name="mamba2-smoke", n_layers=2, d_model=64,
                           vocab_size=256, ssm_state=16, ssm_head_dim=16,
                           ssm_chunk=32)
