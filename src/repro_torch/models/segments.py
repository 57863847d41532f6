"""Segment-descriptor API: the layer stack as a list of per-kind segments.

A **segment** is a contiguous run of same-kind layers (same mixer, same
FFN flavor, same cross-attention presence). Every family's decoder is an
ordered tuple of segments, each executed as its OWN `lax.scan` over its
own stacked params / cache slices / packed-table xs:

  * dense / MoE / VLM  -> 1 segment  ("blocks":   attn + mlp-or-moe)
  * SSM (mamba2)       -> 1 segment  ("blocks":   ssm, no FFN)
  * enc-dec (whisper)  -> 1 segment  ("blocks":   attn + cross + mlp)
  * hybrid (jamba)     -> N segments ("seg00"...: the attn_period /
                          attn_index / moe_every sublayer pattern,
                          run-length-encoded into same-kind runs)

This is what converts family support from an enumerated matrix into a
compositional property: `build_stacked_tables` packs each segment
independently (its own shared MAXB), and the forward/decode/prefill
loops in models.transformer / models.decode iterate segments instead of
switching on cfg.family — ANY composition of attention / SSM / MoE /
cross-attention sublayers serves through the joint-sparse Pallas path.

`ServingCapabilities` (returned by ModelConfig.serving_capabilities())
is the single source of truth of what the serving stack supports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Tuple

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids import cycle
    from .config import ModelConfig


@dataclass(frozen=True)
class Segment:
    """One contiguous run of same-kind layers.

    name:   key of the stacked param subtree (params[name]) and, for
            multi-segment stacks, of the cache subtree.
    mixer:  "attn" | "ssm" — the sequence-mixing sublayer.
    length: number of layers in the run (leading axis of the stacked
            params / cache slices).
    ffn:    "mlp" | "moe" | "none" — the feed-forward sublayer.
    cross:  cross-attention sublayer between mixer and FFN (whisper
            decoder).
    cache:  key of the cache subtree. Single-segment stacks keep the
            historical "attn"/"ssm" keys so existing cache consumers
            (sharding rules, serving engine, tests) see the same tree;
            multi-segment stacks use the segment name.
    """
    name: str
    mixer: str
    length: int
    ffn: str = "none"
    cross: bool = False
    cache: str = "attn"


def _layer_kinds(cfg: "ModelConfig"):
    """(mixer, ffn, cross) per decoder layer, in stack order."""
    if cfg.family == "ssm":
        return [("ssm", "none", False)] * cfg.n_layers
    if cfg.family == "hybrid":
        kinds = []
        for i in range(cfg.n_layers):
            j = i % cfg.attn_period
            mixer = "attn" if j == cfg.attn_index else "ssm"
            ffn = ("moe" if cfg.n_experts
                   and j % cfg.moe_every == cfg.moe_every - 1 else "mlp")
            kinds.append((mixer, ffn, False))
        return kinds
    ffn = "moe" if cfg.n_experts else "mlp"
    return [("attn", ffn, cfg.is_encdec)] * cfg.n_layers


def decoder_layout(cfg: "ModelConfig") -> Tuple[Segment, ...]:
    """Run-length-encode the decoder's layer kinds into segments."""
    kinds = _layer_kinds(cfg)
    runs = []
    for kind in kinds:
        if runs and runs[-1][0] == kind:
            runs[-1][1] += 1
        else:
            runs.append([kind, 1])
    if len(runs) == 1:
        (mixer, ffn, cross), n = runs[0]
        return (Segment("blocks", mixer, n, ffn, cross,
                        cache="ssm" if mixer == "ssm" else "attn"),)
    segs = []
    for i, ((mixer, ffn, cross), n) in enumerate(runs):
        name = f"seg{i:02d}"
        segs.append(Segment(name, mixer, n, ffn, cross, cache=name))
    return tuple(segs)


def encoder_layout(cfg: "ModelConfig") -> Tuple[Segment, ...]:
    """Whisper encoder: one homogeneous non-causal attention segment.
    (The encoder runs once per request, not per decoded token, so it is
    not packed for serving — decode-step weight traffic never reads it.)
    """
    if not cfg.is_encdec:
        return ()
    return (Segment("enc_blocks", "attn", cfg.encoder_layers, "mlp",
                    cross=False, cache="enc"),)


def packable_projections(seg: Segment, cfg: "ModelConfig"):
    """dense_fn hook names of the projections a segment's stacked tables
    pack, in pack order. These are the `name` strings the model bodies
    pass to the hook (attention "wq".."wo", cross-attention
    "xattn/wq".."xattn/wo", MLP "w_gate"/"w_up"/"w_down", MoE experts
    "moe/*" — bare MLP names inside a MoE segment are the arctic dense
    residual). Routers/norms stay dense (tiny, accuracy-critical — same
    reasoning as the paper's dw-conv exclusion)."""
    names = []
    if seg.mixer == "attn":
        names += ["wq", "wk", "wv", "wo"]
        if seg.cross:
            names += ["xattn/wq", "xattn/wk", "xattn/wv", "xattn/wo"]
    else:
        names += ["in_proj", "out_proj"]
    mlp_names = (["w_gate", "w_up", "w_down"]
                 if cfg.mlp_type in ("swiglu", "geglu")
                 else ["w_up", "w_down"])
    if seg.ffn == "moe":
        names += [f"moe/{n}" for n in mlp_names]
        if cfg.dense_residual:
            names += mlp_names
    elif seg.ffn == "mlp":
        names += mlp_names
    return names


def projection_param_path(seg: Segment, name: str) -> str:
    """Full '/'-joined param-tree path of a packable projection (the
    exact-path key strip_packed_projections / reconstruct_stacked_params
    match on — exact paths, so a whisper decoder pack never touches the
    dense encoder's identically-suffixed copies)."""
    if name in ("wq", "wk", "wv", "wo"):
        return f"{seg.name}/attn/{name}"
    if name.startswith("xattn/") or name.startswith("moe/"):
        return f"{seg.name}/{name}"
    if name in ("in_proj", "out_proj"):
        return f"{seg.name}/ssm/{name}"
    # bare MLP names: the plain MLP sublayer, or the dense residual MLP
    # riding next to the experts (arctic)
    if seg.ffn == "moe":
        return f"{seg.name}/moe/dense_mlp/{name}"
    return f"{seg.name}/mlp/{name}"


@dataclass(frozen=True)
class ServingCapabilities:
    """What the serving stack can do for one config.

    segments:         decoder segment layout (stack order).
    stacked_tables:   joint-sparse stacked packs can ride every decoder
                      scan (True for every family since the segmented
                      refactor closed the matrix).
    chunked_prefill:  decode_chunk reproduces sequential decode — needs
                      full causal attention (a sliding-window ring
                      buffer overwrites slots within a chunk).
    parallel_prefill: at least one SSM segment can use the parallel SSD
                      chunk form (one stacked-weight read per chunk).
    prefill_modes:    serving.prefill policies available to the engine.
    packable:         "segment/hook" ids of every packable projection.
    """
    segments: Tuple[Segment, ...]
    stacked_tables: bool
    chunked_prefill: bool
    parallel_prefill: bool
    prefill_modes: Tuple[str, ...]
    packable: Tuple[str, ...]


def serving_capabilities(cfg: "ModelConfig") -> ServingCapabilities:
    segs = decoder_layout(cfg)
    chunked = cfg.window == 0
    parallel = chunked and any(s.mixer == "ssm" for s in segs)
    packable = tuple(f"{s.name}/{n}" for s in segs
                     for n in packable_projections(s, cfg))
    return ServingCapabilities(
        segments=segs,
        stacked_tables=True,
        chunked_prefill=chunked,
        parallel_prefill=parallel,
        prefill_modes=("chunked", "full") if chunked else ("full",),
        packable=packable)
