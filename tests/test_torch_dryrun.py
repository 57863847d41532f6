"""The port's dry run and roofline against the reference's.

``repro_torch.launch.dryrun.run_cell`` reckons a cell on meta tensors:
its ``jaxpr_cost`` (``runtime.op_cost`` over the train, prefill or decode
step, the train step's backward through the row kernels' cost hooks) is
held to the reference walker's ``jaxpr_cost.analyze`` of the reference's
steps on its test mesh, at every reduced config and a small shape:
weight_bytes, every weight_bytes_by_path row, pallas_flops and arg_bytes
equal exactly, dot_flops equal but for the named differences:

  * those ``tests/test_torch_cost.py`` records (the SSM's three-operand
    einsums, which the reference counts as dot_generals with no
    contracted dimension and the port computes as elementwise products,
    and the MoE combine "tkd,tk->td", which the port sums over the k
    choices in order), here over the prefill's and the train step's
    tokens and, in the train step, their gradients too. The SSM chunk
    forms of the full forward and its gradient are bounded, not
    computed: the gap is positive and under 10% of the reference's;
  * the train loss: the reference contracts the logits with a one-hot
    (2 * B * S * V dot flops, and as much again in its gradient), the
    port gathers the gold logit.

The reference's train step rematerializes each layer in its backward
(``cfg.remat``), which its walker charges as a second forward; the port
keeps the activations, so the reference side runs with ``remat=False``.
Its train step reshards microbatches with a sharding constraint that jax
0.9 refuses on an explicit-axes mesh, so both sides take one microbatch.

``memory_analysis.argument_size_in_bytes`` equals the bytes reckoned
from the reference's own specs on the pod meshes, at reduced configs and
at tinyllama-1.1b's full width. The roofline's ``analyze_record``,
``format_table`` and ``load_cells`` equal the reference's on the same
records once the reference's three constants are the port's, and a
record with ``collectives: null`` gets no collective term.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_dryrun.py
"""

import dataclasses
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.launch import roofline as jax_roofline
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_test_mesh as jax_test_mesh
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.inputs import train_batch_spec as jax_batch_spec
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models.config import SHAPES, ShapeSpec
from test_torch_cost import _combine_gap, _dot_gap

pytestmark = pytest.mark.port

ARCHS = list_archs()
SSM_ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")

#: the small shapes the reduced cells run at
SMALL = {"train": ShapeSpec("small_train", 16, 4, "train"),
         "prefill": ShapeSpec("small_prefill", 16, 2, "prefill"),
         "decode": ShapeSpec("small_decode", 32, 2, "decode")}


@pytest.fixture(scope="module")
def ref():
    """The reference walker module, runnable on jax 0.9: its ``jcore``
    swapped for a namespace with ``Var = jax.extend.core.Var`` (as
    ``tests/test_torch_cost.py`` does)."""
    import jax.extend.core
    from repro.runtime import jaxpr_cost
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxpr_cost, "jcore",
                   types.SimpleNamespace(Var=jax.extend.core.Var))
        yield jaxpr_cost


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for a
    512-device host platform; the variable is put back as it was, so no
    later backend or subprocess sees it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        import repro.launch.dryrun as mod
    return mod


def _port_cell(monkeypatch, tmp_path, cfg, spec, mesh_kind="single",
               variant=""):
    """run_cell on ``cfg`` at ``spec`` (the module's config lookup,
    SHAPES and microbatches swapped for the test's)."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    monkeypatch.setattr(dryrun, "SHAPES", {spec.name: spec})
    monkeypatch.setattr(dryrun, "MICROBATCHES", {})
    rec = dryrun.run_cell(cfg.name, spec.name, mesh_kind, out_dir=tmp_path,
                          verbose=False, variant=variant)
    assert rec["status"] == "ok", rec.get("error")
    return rec


def _jax_state(jcfg):
    params = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    return params, jax.eval_shape(jax_adamw_init, params)


def _jax_cell(jcfg, spec, mesh):
    """(step, abstract args, specs) of the reference's cell on ``mesh``."""
    params, opt = _jax_state(jcfg)
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        step, shard = jax_steps.build_train_step(jcfg, mesh)
        args = (params, opt, jax_batch_spec(jcfg, B, S))
    elif spec.kind == "prefill":
        step, shard = jax_steps.build_prefill_step(jcfg, mesh)
        batch = jax_batch_spec(jcfg, B, S)
        batch.pop("labels")
        args = (params, batch)
    else:
        step, shard = jax_steps.build_serve_step(jcfg, mesh)
        enc = (jax.ShapeDtypeStruct((B, jcfg.encoder_seq, jcfg.d_model),
                                    jnp.bfloat16) if jcfg.is_encdec else None)
        cache = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S,
                                                      enc_out=enc))
        args = (params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    return step, args, shard(*args)


def _named_gap(ref, cfg, spec):
    """The dot_flops the reference counts and the port does not, computed
    (SSM chunk forms aside)."""
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "decode":
        return _dot_gap(ref, cfg, "decode", B, 1)
    if spec.kind == "prefill":
        return _combine_gap(ref, cfg, B * S)
    # the loss's one-hot and its gradient; the combine and its two
    # gradient contractions
    return 4 * B * S * cfg.vocab_size + 3 * _combine_gap(ref, cfg, B * S)


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_cost_equals_reference(ref, monkeypatch, tmp_path, arch,
                                        kind):
    spec = SMALL[kind]
    cfg = get_config(arch, reduced=True)
    jcfg = jax_get_config(arch, reduced=True).scaled(remat=False)
    step, args, _ = _jax_cell(jcfg, spec, jax_test_mesh())
    theirs = ref.analyze(step, *args)
    mine = _port_cell(monkeypatch, tmp_path, cfg, spec)["jaxpr_cost"]
    rows = {k: int(v) for k, v in mine["weight_bytes_by_path"].items()}
    assert rows == {k: int(v)
                    for k, v in theirs["weight_bytes_by_path"].items()}
    for key in ("weight_bytes", "pallas_flops", "arg_bytes"):
        assert mine[key] == theirs[key], key
    assert sum(mine["weight_bytes_by_path"].values()) == mine["weight_bytes"]
    for key in ("flops", "bytes", "dot_flops"):
        assert mine[key] > 0, key
    gap = theirs["dot_flops"] - mine["dot_flops"]
    named = _named_gap(ref, cfg, spec)
    if arch in SSM_ARCHS and kind != "decode":
        assert named < gap < named + 0.1 * theirs["dot_flops"], (gap, named)
    else:
        assert gap == named, (gap, named)


def _shard_bytes(tree, specs, mesh_shape):
    """Bytes one device holds of a reference tree under its specs: each
    dim divided by the sizes of the axes its spec entry names."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = []
        for i, d in enumerate(leaf.shape):
            axes = spec[i] if i < len(spec) else None
            axes = () if axes is None else (
                (axes,) if isinstance(axes, str) else axes)
            shape.append(-(-d // math.prod(mesh_shape[a] for a in axes)))
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize
    return total


def _args_bytes_equal(jcfg, rec, spec):
    from jax.sharding import AbstractMesh
    sizes = tuple(rec["mesh_shape"].values())
    mesh = AbstractMesh(sizes, tuple(rec["mesh_shape"]))
    _, args, specs = _jax_cell(jcfg, spec, mesh)
    want = sum(_shard_bytes(a, s, rec["mesh_shape"])
               for a, s in zip(args, specs))
    assert rec["memory_analysis"] == {"argument_size_in_bytes": want}


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "jamba-v0.1-52b", "whisper-base"])
def test_argument_bytes_equal_reference_specs(monkeypatch, tmp_path, arch,
                                              kind):
    spec = dataclasses.replace(SMALL[kind], global_batch=32)
    cfg = get_config(arch, reduced=True)
    for mesh_kind in ("single", "multi"):
        rec = _port_cell(monkeypatch, tmp_path, cfg, spec, mesh_kind)
        _args_bytes_equal(jax_get_config(arch, reduced=True), rec, spec)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_full_width_cell(tmp_path, shape):
    """tinyllama-1.1b at full width on the single-pod mesh: an ok record
    with the reference's keys less XLA's, its argument bytes those of the
    reference's specs, written where the roofline reads it."""
    rec = dryrun.run_cell("tinyllama-1.1b", shape, "single",
                          out_dir=tmp_path, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collectives"] is None
    assert rec["collectives_reason"] == dryrun.COLLECTIVES_REASON
    for key in ("cost_analysis", "hlo_bytes", "collectives_once",
                "compile_s"):
        assert key not in rec
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes"}
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["jaxpr_cost"]["dot_flops"] > 0
    assert rec["lower_s"] <= rec["total_s"]
    if SHAPES[shape].kind == "train":
        assert rec["microbatches"] == dryrun.MICROBATCHES["tinyllama-1.1b"]
    _args_bytes_equal(jax_get_config("tinyllama-1.1b"), rec, SHAPES[shape])
    saved = json.loads((tmp_path / f"tinyllama-1.1b.{shape}.single.json")
                       .read_text())
    assert saved["memory_analysis"] == rec["memory_analysis"]
    cell = roofline.load_cells(str(tmp_path))[0]
    assert cell.status == "ok" and cell.collective_s == 0.0
    assert cell.bottleneck in ("compute", "memory")


def test_should_skip_equals_reference(jax_dryrun, tmp_path):
    for arch in ARCHS:
        for shape in SHAPES:
            assert dryrun.should_skip(arch, shape, get_config(arch)) == \
                jax_dryrun.should_skip(arch, shape, jax_get_config(arch))
    rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", "multi",
                          out_dir=tmp_path, verbose=False)
    assert rec["status"] == "skip"
    assert rec["reason"] == jax_dryrun.should_skip(
        "tinyllama-1.1b", "long_500k", jax_get_config("tinyllama-1.1b"))
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert dryrun.MICROBATCHES == jax_dryrun.MICROBATCHES


def test_variants_and_cli(monkeypatch, tmp_path, capsys):
    cfg = get_config("tinyllama-1.1b", reduced=True)
    plain = _port_cell(monkeypatch, tmp_path, cfg, SMALL["decode"])
    q = _port_cell(monkeypatch, tmp_path, cfg, SMALL["decode"],
                   variant="int8serve")
    jc, qc = plain["jaxpr_cost"], q["jaxpr_cost"]
    # INT8 projections in the step's arguments, dequantized in the step
    assert qc["arg_bytes"] < jc["arg_bytes"]
    assert q["memory_analysis"]["argument_size_in_bytes"] < \
        plain["memory_analysis"]["argument_size_in_bytes"]
    assert qc["dot_flops"] == jc["dot_flops"]
    assert (tmp_path / f"{cfg.name}.small_decode.single.int8serve.json") \
        .exists()
    d = _port_cell(monkeypatch, tmp_path, cfg, SMALL["train"],
                   variant="dotsremat")
    t = _port_cell(monkeypatch, tmp_path, cfg, SMALL["train"])
    assert d["jaxpr_cost"]["dot_flops"] == t["jaxpr_cost"]["dot_flops"]
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path / "cli")
    monkeypatch.setattr(dryrun, "SHAPES", {"small_decode": SMALL["decode"]})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", cfg.name, "--shape", "small_decode",
                     "--mesh", "multi"])
    assert e.value.code == 0
    assert "1 ok/skip, 0 errors" in capsys.readouterr().out
    assert (tmp_path / "cli" / f"{cfg.name}.small_decode.multi.json").exists()


# ------------------------------------------------------------ roofline --

def _records():
    """Reference-style records (collectives by kind, XLA's temp bytes), a
    skip, a variant, and one of each shape."""
    base = {"arch": "qwen3-8b", "mesh": "single",
            "mesh_shape": {"data": 16, "model": 16}, "status": "ok",
            "variant": "", "params": 8_000_000_000,
            "active_params": 8_000_000_000}
    recs = []
    for i, shape in enumerate(roofline.SHAPE_TOKENS):
        rec = dict(base, shape=shape)
        rec["jaxpr_cost"] = {"flops": 3e15 * (i + 1), "dot_flops": 2e15,
                             "bytes": 4e12 / (i + 1), "arg_bytes": 1e10,
                             "pallas_bytes": 1e11 * i}
        rec["collectives"] = {"all-reduce": 2e9 * i, "total": 2e9 * i}
        rec["memory_analysis"] = {"temp_size_in_bytes": 5e9,
                                  "argument_size_in_bytes": 2e10}
        recs.append(rec)
    recs.append(dict(base, arch="tinyllama-1.1b", shape="long_500k",
                     mesh="multi", status="skip", reason="x" * 80,
                     mesh_shape={"pod": 2, "data": 16, "model": 16}))
    recs.append(dict(recs[2], variant="int8serve"))
    return recs


@pytest.fixture
def jax_roof(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jax_roofline, name, getattr(roofline, name))
    return jax_roofline


def test_roofline_constants_are_the_cards():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.ICI_BW == 450e9
    assert roofline.SHAPE_TOKENS == jax_roofline.SHAPE_TOKENS
    assert "700 W" in roofline.__doc__ and "H100" in roofline.__doc__


def test_roofline_equals_reference(jax_roof, tmp_path):
    recs = _records()
    for rec in recs:
        assert dataclasses.asdict(roofline.analyze_record(rec)) == \
            dataclasses.asdict(jax_roof.analyze_record(rec))
        assert roofline.model_flops(rec) == jax_roof.model_flops(rec)
    for i, rec in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    for variants in (False, True):
        mine = roofline.load_cells(str(tmp_path), variants)
        theirs = jax_roof.load_cells(str(tmp_path), variants)
        assert [dataclasses.asdict(c) for c in mine] == \
            [dataclasses.asdict(c) for c in theirs]
        for mesh in ("single", "multi"):
            assert roofline.format_table(mine, mesh) == \
                jax_roof.format_table(theirs, mesh)


def test_roofline_null_collectives(jax_roof):
    rec = dict(_records()[2], collectives=None,
               collectives_reason=dryrun.COLLECTIVES_REASON)
    rec["memory_analysis"] = {"argument_size_in_bytes": 2e10}
    cell = roofline.analyze_record(rec)
    assert cell.collective_s == 0.0
    assert cell.reason == roofline.NO_COLLECTIVE_TERM \
        + dryrun.COLLECTIVES_REASON
    want = dict(rec, collectives={"total": 0.0})
    same = dataclasses.asdict(jax_roof.analyze_record(want))
    same["reason"] = cell.reason
    assert dataclasses.asdict(cell) == same
    assert cell.bottleneck in ("compute", "memory")
    mem = dict(rec, jaxpr_cost=dict(rec["jaxpr_cost"], flops=1.0,
                                    dot_flops=1.0))
    assert roofline.analyze_record(mem).bottleneck == "memory"
    line = roofline.format_table([cell]).splitlines()[-1]
    assert line.split()[1] == rec["shape"] and "SKIP" not in line
