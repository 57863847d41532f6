"""The port's mesh and sharding layer against the reference's.

``repro_torch.runtime.sharding``'s rules, ``launch.steps``' spec helpers
and mesh-bound serving builders, ``runtime.act_sharding``,
``launch.mesh``, ``models.config.SHAPES`` and the input specs against
``repro``'s. The reference side reckons its rules on
``jax.sharding.AbstractMesh`` meshes of the pod sizes over
``jax.eval_shape`` trees; the port on its own meshes over meta tensors of
the same paths, shapes and dtypes. Specs are equal leaf by leaf, as
tuples, for all ten archs at full width on (1, 1), (16, 16) and
(2, 16, 16): params (FSDP on and off, INT8 serving payloads), fp32 and
INT8 moments, batches and caches (contiguous, paged pool, SSM, enc-dec,
hybrid segments). The serving builders' steps are bitwise
``build_step``'s at reduced configs, and an engine under an explicit
one-card mesh streams what one without streams.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_sharding.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.launch import mesh as jax_mesh
from repro.launch import steps as jax_steps
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import inputs as jax_inputs
from repro.models.config import SHAPES as JAX_SHAPES
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime import act_sharding as jax_act
from repro.runtime import sharding as jax_shr
from repro.sparsity.sparse_linear import \
    quantize_params_for_serving as jax_quantize
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import SHAPES
from repro_torch.models.inputs import decode_token_spec, train_batch_spec
from repro_torch.models.segments import decoder_layout
from repro_torch.optim import adamw_init
from repro_torch.runtime import act_sharding
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.sharding import P
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.serving.faults import EngineCrash, FaultEvent, FaultPlan
from repro_torch.sparsity import quantize_params_for_serving
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

ARCHS = list_archs()

#: (sizes, axis names) of the test mesh and the two pod meshes
MESHES = {"test": ((1, 1), ("data", "model")),
          "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    """(the reference's abstract mesh, the port's mesh) of ``kind``."""
    sizes, names = MESHES[kind]
    return AbstractMesh(sizes, names), Mesh(sizes, names)


def _jax_flat(tree):
    """{path: leaf} of a reference tree, its paths joined as its rules
    join them; PartitionSpec leaves as tuples."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", k)) for k in p):
            (tuple(v) if isinstance(v, jax.sharding.PartitionSpec) else v)
            for p, v in leaves}


def _port_flat(tree):
    return {p: (tuple(v) if isinstance(v, P) else v)
            for p, v in shr.tree_leaves_with_path(tree)}


def _same_specs(mine, theirs, what):
    a, b = _port_flat(mine), _jax_flat(theirs)
    assert set(a) == set(b), (what, sorted(set(a) ^ set(b))[:8])
    bad = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert not bad, (what, dict(list(bad.items())[:8]))
    for v in a.values():
        assert isinstance(v, tuple)


def _same_leaves(mine, theirs, what):
    """The port's meta tree has the reference's paths, shapes and dtypes."""
    a, b = _port_flat(mine), _jax_flat(theirs)
    assert set(a) == set(b), (what, sorted(set(a) ^ set(b))[:8])
    for k, t in a.items():
        assert t.device.type == "meta", (what, k)
        want = tuple(b[k].shape)
        if k.endswith(("/pk", "/pv")):
            # the port's pool holds one spare page past n_pages, which
            # takes the writes the reference drops
            want = want[:1] + (want[1] + 1,) + want[2:]
        assert tuple(t.shape) == want, (what, k)
        assert str(t.dtype).removeprefix("torch.") == str(b[k].dtype), \
            (what, k)


@pytest.fixture(scope="module")
def trees():
    """{arch: (cfg, jax params, port meta params)} at full width."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        jp = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                            jax.random.PRNGKey(0))
        out[arch] = (jcfg, get_config(arch), jp,
                     init_params(get_config(arch), device="meta"))
    return out


# ------------------------------------------------------ config, meshes --

def test_shapes_equal_reference():
    assert list(SHAPES) == list(JAX_SHAPES)
    for k in SHAPES:
        assert dataclasses.asdict(SHAPES[k]) == \
            dataclasses.asdict(JAX_SHAPES[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        s = SHAPES[shape]
        _same_leaves(train_batch_spec(cfg, s.global_batch, s.seq_len),
                     jax_inputs.train_batch_spec(jcfg, s.global_batch,
                                                 s.seq_len), shape)
    for shape in ("decode_32k", "long_500k"):
        b = SHAPES[shape].global_batch
        _same_leaves(decode_token_spec(cfg, b),
                     jax_inputs.decode_token_spec(jcfg, b), shape)
    spec = train_batch_spec(cfg, 2, 8)
    assert ("frames" in spec) == cfg.is_encdec
    assert ("frontend" in spec) == (cfg.frontend == "vision_stub")


def test_meshes_equal_reference():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's pod meshes need 256 / 512 devices: reckon them
        # as abstract meshes of the same sizes and names
        mp.setattr(jax_mesh.jax, "make_mesh",
                   lambda shape, axes: AbstractMesh(shape, axes))
        pairs = [(make_production_mesh(), jax_mesh.make_production_mesh()),
                 (make_production_mesh(multi_pod=True),
                  jax_mesh.make_production_mesh(multi_pod=True))]
    pairs.append((make_test_mesh("cpu"), jax_mesh.make_test_mesh()))
    for mine, theirs in pairs:
        assert mine.axis_names == tuple(theirs.axis_names)
        assert list(mine.shape.items()) == list(dict(theirs.shape).items())
    assert make_production_mesh().devices == ()
    assert make_test_mesh("cpu").devices == (torch.device("cpu"),)


def test_mesh_context_runs_on_one_card_only():
    m = make_test_mesh("cpu")
    with m as entered:
        assert entered is m and m.device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="the port runs on one card"):
            with make_production_mesh():
                pass
    two = Mesh((2, 1), ("data", "model"), devices=("cpu", "cpu"))
    for bad in (two, make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="needs .* devices"):
            with bad:
                pass
        with pytest.raises(RuntimeError, match="the port runs on one card"):
            bad.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_test_mesh()               # the card is the default


# ------------------------------------------------------- param rules --

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(trees, arch):
    _, _, jp, mp_ = trees[arch]
    _same_leaves(mp_, jp, "params")
    for kind in MESHES:
        jm, m = _meshes(kind)
        for fsdp in (True, False):
            _same_specs(shr.param_specs(mp_, m, fsdp=fsdp),
                        jax_shr.param_specs(jp, jm, fsdp=fsdp),
                        (kind, fsdp))
        _same_specs(shr.param_specs(mp_, m, fsdp_min_elems=1 << 24),
                    jax_shr.param_specs(jp, jm, fsdp_min_elems=1 << 24),
                    (kind, "min elems"))
        assert steps._needs_fsdp(mp_, m) == jax_steps._needs_fsdp(jp, jm)
        _same_specs(steps._serving_param_specs(mp_, m),
                    jax_steps._serving_param_specs(jp, jm), (kind, "serve"))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_payload_specs_equal_reference(trees, arch):
    _, _, jp, mp_ = trees[arch]
    jq = jax.eval_shape(jax_quantize, jp)
    q = quantize_params_for_serving(mp_)
    _same_leaves(q, jq, "int8 params")
    for kind in MESHES:
        jm, m = _meshes(kind)
        specs = shr.param_specs(q, m)
        _same_specs(specs, jax_shr.param_specs(jq, jm), kind)
        for path, spec in shr.tree_leaves_with_path(specs):
            if path.endswith("/scale"):
                assert spec == P(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_moment_specs_equal_reference(trees, arch):
    _, _, jp, mp_ = trees[arch]
    for int8 in (False, True):
        jopt = jax.eval_shape(lambda p: jax_adamw_init(p, int8_state=int8),
                              jp)
        opt = adamw_init(mp_, int8_state=int8)
        for kind in MESHES:
            jm, m = _meshes(kind)
            jps = jax_shr.param_specs(jp, jm)
            ps = shr.param_specs(mp_, m)
            _same_specs(shr.opt_state_specs(mp_, ps, m),
                        jax_shr.opt_state_specs(jp, jps, jm), (kind, "zero1"))
            _same_specs(steps._moment_specs(mp_, ps, opt.m, m),
                        jax_steps._moment_specs(jp, jps, jopt.m, jm),
                        (kind, int8))


# ------------------------------------------------ batches and caches --

@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for kind in MESHES:
        jm, m = _meshes(kind)
        for s in SHAPES.values():
            _same_specs(
                shr.batch_specs(train_batch_spec(cfg, s.global_batch,
                                                 s.seq_len), m),
                jax_shr.batch_specs(jax_inputs.train_batch_spec(
                    jcfg, s.global_batch, s.seq_len), jm), (kind, s.name))
            _same_specs(
                shr.batch_specs(decode_token_spec(cfg, s.global_batch), m),
                jax_shr.batch_specs(jax_inputs.decode_token_spec(
                    jcfg, s.global_batch), jm), (kind, s.name, "token"))


def _pageable(cfg):
    """Whether the config's attention caches can be a paged pool: full
    causal attention in some segment."""
    return cfg.window == 0 and any(s.mixer != "ssm"
                                   for s in decoder_layout(cfg))


def _caches(jcfg, cfg, B, S, paged=False):
    """(the reference's abstract cache, the port's meta cache) of B slots
    of S positions, the paged pool with 16-position pages."""
    kw = dict(n_pages=B * S // 16, page_size=16) if paged else {}
    jenc = enc = None
    if cfg.is_encdec:
        jenc = jax.ShapeDtypeStruct((B, jcfg.encoder_seq, jcfg.d_model),
                                    jnp.bfloat16)
        enc = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
    jc = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S, enc_out=jenc,
                                               **kw))
    return jc, init_cache(cfg, B, S, device="meta", enc_out=enc, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    cells = [(128, 32768, False), (1, 524288, False), (3, 48, False)]
    if _pageable(cfg):
        cells.append((128, 4096, True))
    for B, S, paged in cells:
        jc, c = _caches(jcfg, cfg, B, S, paged)
        _same_leaves(c, jc, (B, S, paged))
        for kind in MESHES:
            jm, m = _meshes(kind)
            _same_specs(shr.cache_specs(c, cfg, m),
                        jax_shr.cache_specs(jc, jcfg, jm), (kind, B, S, paged))


def test_cache_specs_cover_every_layout():
    """The cases above reach each cache rule: contiguous k/v, the paged
    pool, SSM state and conv, enc-dec's enc_out, hybrid segments."""
    _, m = _meshes("single")
    seen = set()
    for arch in ("stablelm-1.6b", "mamba2-1.3b", "whisper-base",
                 "jamba-v0.1-52b"):
        cfg = get_config(arch)
        for paged in (False, True):
            if paged and not _pageable(cfg):
                continue
            _, c = _caches(jax_get_config(arch), cfg, 128, 4096, paged)
            for path, spec in shr.tree_leaves_with_path(
                    shr.cache_specs(c, cfg, m)):
                leaf = path.rsplit("/", 1)[-1]
                if any(spec):
                    seen.add((leaf, path.startswith("seg")))
    assert {("k", False), ("pk", False), ("state", False), ("conv", False),
            ("enc_out", False), ("k", True), ("state", True)} <= seen


def test_first_fit_and_local_shape():
    _, m = _meshes("multi")
    assert shr.first_fit((24, 32), [("model", None), (None, "model")], m) \
        == P(None, "model")
    assert shr.first_fit((3, 5), [("model",)], m) == P()
    assert shr.axis_size(m, ("pod", "data")) == 32
    assert shr.local_shape((64, 48, 7), P(("pod", "data"), "model"), m) == \
        (2, 3, 7)
    t = torch.empty((64, 48), dtype=torch.bfloat16, device="meta")
    assert shr.local_bytes({"w": t}, {"w": P("data", "model")}, m) == \
        4 * 3 * 2
    with pytest.raises(ValueError, match="does not fit"):
        shr.check_fits({"w": t}, {"w": P("model", None, None)}, m)
    with pytest.raises(ValueError, match="does not fit"):
        shr.check_fits({"w": t}, {"w": P("expert")}, m)
    named = shr.named({"w": P("data")}, m)
    assert named["w"].mesh is m and named["w"].spec == ("data",)


# ------------------------------------------- activation constraints --

def test_resolve_equals_reference():
    logical = (None, "dp", "tp", "data", "model", "pod", "expert")
    dims = (1, 2, 3, 8, 16, 24, 32, 48, 256, 512)
    for kind in MESHES:
        jm, m = _meshes(kind)
        for ax in logical:
            for d in dims:
                assert act_sharding._resolve(m, ax, d) == \
                    jax_act._resolve(jm, ax, d), (kind, ax, d)


def test_constrain_returns_the_same_object():
    x = torch.zeros(4, 8)
    assert act_sharding.constrain(x, "dp", "tp") is x
    assert act_sharding.constrain_any(x, ("dp", None), (None, "tp")) is x
    with make_test_mesh("cpu"):
        assert act_sharding.constrain(x, "dp", "tp") is x
        assert act_sharding.constrain(x, "dp") is x
        assert act_sharding.constrain_any(x, ("dp", None)) is x


# ---------------------------------------------- mesh-bound builders --

def _reduced(arch):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, cfg, jp, params


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "whisper-base"])
def test_builder_shardings_equal_reference(arch):
    jcfg, cfg, jp, params = _reduced(arch)
    jm = jax_mesh.make_test_mesh()
    m = make_test_mesh("cpu")
    B, S, C = 2, 32, 4
    for paged in (False, True):
        if paged and not _pageable(cfg):
            continue
        jc, c = _caches(jcfg, cfg, B, S, paged)
        jtok, jact = jnp.zeros((B, 1), jnp.int32), jnp.zeros((B,), bool)
        jtoks, jnv = jnp.zeros((B, C), jnp.int32), jnp.zeros((B,), jnp.int32)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        act = torch.zeros((B,), dtype=torch.bool)
        toks = torch.zeros((B, C), dtype=torch.int32)
        nv = torch.zeros((B,), dtype=torch.int32)
        extra, jextra = (), ()
        if paged:
            extra = (torch.full((B, S // 16), -1, dtype=torch.int32),)
            jextra = (jnp.full((B, S // 16), -1, jnp.int32),)
        cases = [("decode", steps.build_slot_decode_step, (tok, act),
                  (jtok, jact)),
                 ("prefill_chunk", steps.build_prefill_chunk_step,
                  (toks, nv), (jtoks, jnv))]
        if not paged:
            cases.append(("serve", None, (tok,), (jtok,)))
        for kind, builder, ins, jins in cases:
            _, jshard = jax_steps.build_step(jcfg, jm, kind, paged=paged)
            if builder is None:
                fn, shard = steps.build_serve_step(cfg, m)
            else:
                fn, shard = builder(cfg, m)
            mine = shard(params, c, *ins, *extra)
            theirs = jshard(jp, jc, *jins, *jextra)
            assert len(mine) == len(theirs), kind
            for a, b in zip(mine, theirs):
                _same_specs(a, b, (kind, paged))
            assert fn.call_kind == jax_steps.build_step(
                jcfg, jm, kind)[0].call_kind
            assert fn.arch == cfg.name
    bspec = jax_shr.batch_specs(jax_inputs.train_batch_spec(jcfg, 2, 8), jm)
    jopt = jax.eval_shape(jax_adamw_init, jp)
    _, jtrain = jax_steps.build_train_step(jcfg, jm)
    mine = steps.train_shardings(m)(params, adamw_init(params),
                                    train_batch_spec(cfg, 2, 8))
    theirs = jtrain(jp, jopt, jax_inputs.train_batch_spec(jcfg, 2, 8))
    for a, b in zip(mine, theirs):
        _same_specs(a, b, "train")
    _same_specs(mine[2], bspec, "train batch")
    _, jpre = jax_steps.build_prefill_step(jcfg, jm)
    pb, jpb = train_batch_spec(cfg, 2, 8), jax_inputs.train_batch_spec(
        jcfg, 2, 8)
    pb.pop("labels")
    jpb.pop("labels")
    for a, b in zip(steps.prefill_shardings(m)(params, pb), jpre(jp, jpb)):
        _same_specs(a, b, "prefill")


def _clone(tree):
    return jax.tree_util.tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b"])
def test_builder_steps_bitwise_build_step(arch):
    _, cfg, _, params = _reduced(arch)
    m = make_test_mesh("cpu")
    B, S, C = 2, 32, 4
    gen = torch.Generator().manual_seed(0)
    cache = init_cache(cfg, B, S, device="cpu")
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    if "attn" in cache and "pos" in cache["attn"]:
        cache["attn"]["pos"] = torch.zeros((B,), dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                         dtype=torch.int32)
    nv = torch.tensor([C, 2], dtype=torch.int32)
    tok = toks[:, :1].contiguous()
    act = torch.tensor([True, False])
    runs = [("prefill_chunk", steps.build_prefill_chunk_step, (toks, nv)),
            ("decode", steps.build_slot_decode_step, (tok, act))]
    for kind, builder, ins in runs:
        fn, _ = builder(cfg, m)
        ref = steps.build_step(cfg, kind)
        c1, c2 = _clone(cache), _clone(cache)
        out1, _ = fn(params, c1, *ins)
        out2, _ = ref(params, c2, *ins)
        assert torch.equal(out1, out2), kind
        for (p, a), (_, b) in zip(shr.tree_leaves_with_path(c1),
                                  shr.tree_leaves_with_path(c2)):
            assert torch.equal(a, b), (kind, p)
        cache = c1
    fn, _ = steps.build_serve_step(cfg, m)
    a, ca = fn(params, _clone(cache), tok)
    b, cb = steps.build_step(cfg, "serve")(params, _clone(cache), tok)
    assert torch.equal(a, b)


def test_train_and_prefill_steps_take_a_mesh():
    _, cfg, _, params = _reduced("tinyllama-1.1b")
    from repro_torch.models.inputs import make_train_batch
    batch = make_train_batch(cfg, 2, 8, device="cpu")
    m = make_test_mesh("cpu")
    pre = steps.build_prefill_step(cfg, mesh=m)(params, batch)
    assert torch.equal(pre, steps.build_prefill_step(cfg)(params, batch))
    p = steps.trainable(params)
    opt = adamw_init(p)
    a = steps.build_train_step(cfg, mesh=m)(p, opt, batch)
    b = steps.build_train_step(cfg)(p, opt, batch)
    assert torch.equal(a[2], b[2])
    for (path, x), (_, y) in zip(shr.tree_leaves_with_path(a[0]),
                                 shr.tree_leaves_with_path(b[0])):
        assert torch.equal(x, y), path
    meta = Mesh((1, 1), ("data", "model"), devices=("meta",))
    with pytest.raises(ValueError, match="not on the mesh's device"):
        steps.build_prefill_step(cfg, mesh=meta)(params, batch)
    with pytest.raises(RuntimeError, match="the port runs on one card"):
        steps.build_train_step(cfg, mesh=make_production_mesh())(
            p, opt, batch)


# ------------------------------------------------------------ engine --

def test_build_chunk_step_checks_the_mesh():
    from repro_torch.serving.prefill import build_chunk_step
    _, cfg, _, params = _reduced("tinyllama-1.1b")
    cache = init_cache(cfg, 2, 32, device="cpu")
    step = build_chunk_step(cfg, make_test_mesh("cpu"), params, cache, 2, 4)
    assert step.call_kind == "prefill_chunk_exact"
    assert step.arch == cfg.name
    assert step.buffer_argnums == frozenset((0, 1))
    meta = Mesh((1, 1), ("data", "model"), devices=("meta",))
    with pytest.raises(ValueError, match="not on the mesh's device"):
        build_chunk_step(cfg, meta, params, cache, 2, 4)
    with pytest.raises(RuntimeError, match="the port runs on one card"):
        build_chunk_step(cfg, make_production_mesh(), params, cache, 2, 4)


def test_engine_under_explicit_mesh_streams_the_same():
    _, cfg, _, params = _reduced("tinyllama-1.1b")
    spec = WorkloadSpec(n_requests=4, prompt_len=(3, 9), gen_len=(2, 5),
                        seed=0)
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4, device="cpu")
    plain = ServeEngine(cfg, params, **kw)
    meshed = ServeEngine(cfg, params, mesh=make_test_mesh("cpu"), **kw)
    assert meshed.mesh.shape == {"data": 1, "model": 1}
    a = plain.run(make_trace(spec, cfg.vocab_size))
    b = meshed.run(make_trace(spec, cfg.vocab_size))
    assert a == b and plain.outputs == meshed.outputs
    assert dict(plain.metrics.calls_by_kind) == \
        dict(meshed.metrics.calls_by_kind)
    assert meshed._decode.call_kind == "decode"
    assert meshed.prefill_kind == "prefill_chunk_exact"
    assert meshed._prefill._cache_size() == 1


def test_engine_refuses_foreign_and_multi_device_meshes():
    _, cfg, _, params = _reduced("tinyllama-1.1b")
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4, device="cpu")
    meta = Mesh((1, 1), ("data", "model"), devices=("meta",))
    with pytest.raises(ValueError, match="mesh on meta"):
        ServeEngine(cfg, params, mesh=meta, **kw)
    two = Mesh((2, 1), ("data", "model"), devices=("cpu", "cpu"))
    with pytest.raises(RuntimeError, match="the port runs on one card"):
        ServeEngine(cfg, params, mesh=two, **kw)
    with pytest.raises(RuntimeError, match="the port runs on one card"):
        ServeEngine(cfg, params, mesh=make_production_mesh(), **kw)
    with pytest.raises(ValueError, match="not on the mesh's device"):
        ServeEngine(cfg, jax.tree_util.tree_map(
            lambda t: t.to("meta"), params), **kw)


def test_restore_takes_a_mesh(tmp_path):
    _, cfg, _, params = _reduced("tinyllama-1.1b")
    spec = WorkloadSpec(n_requests=3, prompt_len=(3, 6), gen_len=(3, 4),
                        seed=1)
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4, device="cpu")
    trace = make_trace(spec, cfg.vocab_size)
    full = ServeEngine(cfg, params, **kw).run(trace)
    jpath, snapdir = str(tmp_path / "j.jsonl"), str(tmp_path / "snaps")
    plan = FaultPlan(events=(FaultEvent(tick=4, kind="engine_crash"),))
    with pytest.raises(EngineCrash):
        ServeEngine(cfg, params, journal=jpath, snapshot_dir=snapdir,
                    snapshot_every=2, fault_plan=plan, **kw).run(trace)
    meta = Mesh((1, 1), ("data", "model"), devices=("meta",))
    with pytest.raises(ValueError, match="mesh on meta"):
        ServeEngine.restore(cfg, params, snapshot_dir=snapdir,
                            journal_path=jpath, fault_plan=plan, mesh=meta,
                            device="cpu")
    r = ServeEngine.restore(cfg, params, snapshot_dir=snapdir,
                            journal_path=jpath, fault_plan=plan,
                            mesh=make_test_mesh("cpu"), device="cpu")
    assert r.mesh.devices == (torch.device("cpu"),)
    assert r.resume() == full
