"""whisper-base [audio]: enc-dec, 6+6L d=512 8H (MHA) d_ff=2048
vocab=51865; conv frontend is a STUB — the input spec provides
precomputed frame embeddings (1500 frames). Sinusoidal positions
(rope_pct=0), LayerNorm. [arXiv:2212.04356]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
        norm_type="layernorm", mlp_type="gelu", rope_pct=0.0,
        encoder_layers=6, encoder_seq=1500, frontend="audio_stub")


def reduced_config() -> ModelConfig:
    return config().scaled(name="whisper-smoke", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                           encoder_layers=2, encoder_seq=32)
