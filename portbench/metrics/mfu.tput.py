"""Device, whole step: the operations the compressed model needs for the
window's valid tokens (prompt tokens prefilled and tokens decoded, at
the kept tiles, top_k experts, live keys, the unembedding per generated
token; ``Costs.span_ops``) over the window's seconds times the bf16
peak (%)."""


def read(run):
    return run.mfu_pct()
