"""The frozen reference held to the port at reduced sizes (CPU): its
pruned INT8/FTA weights equal the port's packs once unpacked, byte for
byte, and its float32 logits match the port's plain path."""

import pytest
import torch
from conftest import reduced

from portbench.harness import program
from portbench.reference import compress, model, slices

CPU = torch.device("cpu")
CONFIGS = ["stablelm-1.6b", "mixtral-8x7b"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compressed_weights_equal_the_packs(config, dtype):
    from repro_torch.kernels import ops
    spec = reduced(config, dtype=dtype, d_model=96, d_ff=160)
    cfg, params, tables = program.build(spec, 17, CPU)
    st = tables.segments["blocks"]
    vs = spec["dbpim_value_sparsity"]
    n = 0
    for name in slices.weight_shapes(spec):
        hook = name.split("/", 1)[1] if not name.startswith("moe/") \
            else name
        k, nn, k_pad = st.static[hook]
        arr = st.arrays[hook]
        experts = range(spec["n_experts"]) if name.startswith("moe/") \
            else [None]
        for l in range(spec["n_layers"]):
            for e in experts:
                a = {f: (t[l] if e is None else t[l, e])
                     for f, t in arr.items()}
                got = ops.unpack_joint_sparse(ops.JointPacked(
                    a["w_blocks"], a["idx"], a["scales"], a["nblocks"], k,
                    nn, k_pad))
                w = slices.weight(spec, 17, name, l, CPU,
                                  -1 if e is None else e)
                assert torch.equal(got, compress.compress(w, vs)), \
                    (name, l, e)
                n += 1
    assert n == spec["n_layers"] * (4 + 3 * spec.get("n_experts", 1))


@pytest.mark.parametrize("config", CONFIGS)
def test_logits_match_the_ports_plain_path(config):
    from repro_torch.models import forward
    spec = reduced(config, dtype="float32")
    cfg, params, tables = program.build(spec, 23, CPU)
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(1, spec["vocab_size"], (S,), generator=g)
            for S in (24, 40)]
    ref = model.logits(spec, 23, seqs, [0, 0], CPU)
    for seq, r in zip(seqs, ref):
        with torch.no_grad():
            got = forward(params, seq[None].int(), cfg, tables=tables)[0]
        got = got[:-1]
        scale = r.abs().max()
        assert float((got - r).abs().max()) <= 1e-5 * float(scale), config


def test_control_reads_wider_than_the_program():
    """The float8 control moves the logits far more than the port's bf16
    serving does, on the same sequences (test size)."""
    from repro_torch.models import forward
    spec = reduced("stablelm-1.6b", n_layers=4)
    cfg, params, tables = program.build(spec, 29, CPU)
    seq = torch.randint(1, spec["vocab_size"], (48,),
                        generator=torch.Generator().manual_seed(1))
    ref, = model.logits(spec, 29, [seq], [0], CPU)
    ctl, = model.logits(spec, 29, [seq], [0], CPU, "fp8")
    with torch.no_grad():
        got = forward(params, seq[None].int(), cfg,
                      tables=tables)[0, :-1].float()
    assert (ctl - ref).abs().max() > 2 * (got - ref).abs().max()
