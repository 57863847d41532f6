"""The port's training path against the JAX package on the CPU: loss_fn and
every gradient leaf (all ten reduced archs in float32),
cross_entropy with masked labels, cosine_with_warmup, adamw_update with
float32 and INT8 moments, build_train_step's loss curve (microbatches,
gradient compression) against the reference's value_and_grad + adamw
loop, compress_tree / EFCompressor, SyntheticLMDataset, the
CheckpointManager (async, keep, errors, checkpoints read across both
packages, resume == uninterrupted), run_resilient / ElasticMeshPlan, the
train CLI, and serving's forward staying out of autograd. The same
JAX-initialised params go to both packages through params_from_numpy;
inputs are numpy arrays made from a seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_train.py
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import ssm as jax_ssm
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_with_warmup as jax_cosine
from repro.runtime.compression import EFCompressor as JaxEF
from repro.runtime.compression import compress_tree as jax_compress_tree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_pipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import build_train_step, trainable
from repro_torch.models import forward, loss_fn, prefill, ssm
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_with_warmup)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import ElasticMeshPlan, run_resilient
from repro_torch.runtime.compression import EFCompressor, compress_tree
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

#: float32 gradients: the two packages' CPU matmuls block their K-sums
#: differently (and XLA fuses), so a leaf agrees to ~1e-6 of its peak;
#: 1e-4 of the leaf's max |ref| leaves room for the deeper sums of the
#: embedding and the SSD
GRAD_RTOL = 1e-4
#: a loss curve over three AdamW steps: the params move by lr each step
#: from gradients that agree to GRAD_RTOL
CURVE_RTOL = 1e-4
#: batch and sequence of the JAX comparisons (B divides into 4
#: microbatches; S a multiple of the reduced SSD chunk)
BATCH, SEQ = 8, 32


def _cfgs(arch):
    jcfg = jax_get_config(arch, reduced=True).scaled(dtype="float32")
    cfg = get_config(arch, reduced=True).scaled(dtype="float32")
    return jcfg, cfg


def _params(jcfg, seed=0):
    """(JAX params, the same as the port's trainable CPU tensors)."""
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, trainable(tp)


def _grad_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_grad_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _ulps(a, b):
    """Distance in float32 units in the last place, elementwise."""
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b",
                                  "mamba2-1.3b", "mixtral-8x7b",
                                  "arctic-480b", "jamba-v0.1-52b",
                                  "whisper-base", "qwen3-8b",
                                  "stablelm-1.6b", "pixtral-12b"])
def test_loss_and_every_gradient_match_jax(arch):
    """All ten reduced archs: tinyllama (RMSNorm, SwiGLU, GQA), gemma
    ((1 + w) norms, GeGLU, a scaled tied embedding), mamba2 (the SSD, the
    gated norm), mixtral (MoE dispatch, a window), arctic (the dense
    residual MLP beside the experts), jamba (attention, SSM and MoE
    segments), whisper (the encoder and cross-attention), qwen3 (qk-norm),
    stablelm (LayerNorm, partial RoPE) and pixtral (the patch frontend):
    the loss and every leaf's gradient of the port's autograd against
    jax.value_and_grad of the reference's loss_fn; every floating leaf
    gets a gradient."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = JaxDataset(jcfg, 2, SEQ, seed=3).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tl = loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    want = _grad_leaves(jax.tree_util.tree_map(np.asarray, jg))
    got = _grad_leaves(tp)
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.grad is not None, key
        ref = want[key]
        tol = GRAD_RTOL * float(np.abs(ref).max())
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=key)


def _ssd_recurrence(state, xq, bq, cq, dtq, A):
    """The SSD chunk as its per-token recurrence (decode's form):
    s_t = s_(t-1) exp(dt_t A) + dt_t x_t b_t^T, y_t = s_t c_t."""
    ys = []
    for t in range(dtq.shape[1]):
        dt = dtq[:, t]                                        # (B, H)
        state = (state * torch.exp(dt * A)[:, :, None, None]
                 + torch.einsum("bh,bhp,bn->bhpn", dt, xq[:, t], bq[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, cq[:, t]))
    return state, torch.stack(ys, dim=1)


def test_ssd_chunk_gradient_is_finite_past_exp_overflow():
    """A chunk whose decay passes ~88 (full-width mamba2 trains at seq 128
    in one chunk): exp(cum_i - cum_j) overflows above the diagonal. The
    reference's where(tri, exp(seg), 0) has a NaN gradient there (0 *
    inf); the port masks before the exp. Its forward equals the
    reference's, its gradient is finite and equals autograd of the
    per-token recurrence in float64 within 1e-4 of each leaf's peak."""
    rng = np.random.default_rng(9)
    B, Q, H, P, N = 2, 64, 3, 4, 5
    arrs = {"state": rng.standard_normal((B, H, P, N)),
            "xq": rng.standard_normal((B, Q, H, P)),
            "bq": rng.standard_normal((B, Q, N)),
            "cq": rng.standard_normal((B, Q, N)),
            "dtq": 1.5 + rng.random((B, Q, H)),
            "A": -np.exp(rng.standard_normal(H) * 0.1)}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    cum = np.cumsum(arrs["dtq"] * arrs["A"], axis=1)
    assert cum[:, 0].max() - cum[:, -1].min() > 89.0     # exp overflows
    gy = rng.standard_normal((B, Q, H, P)).astype(np.float32)
    gs = rng.standard_normal((B, H, P, N)).astype(np.float32)
    names = ("state", "xq", "bq", "cq", "dtq", "A")

    def jax_obj(*a):
        st, y = jax_ssm._ssd_chunk(*a)
        return jnp.sum(y * gy) + jnp.sum(st * gs)
    jref = jax_ssm._ssd_chunk(*(jnp.asarray(arrs[k]) for k in names))
    jgrads = jax.grad(jax_obj, argnums=tuple(range(6)))(
        *(jnp.asarray(arrs[k]) for k in names))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)

    leaves = {k: torch.from_numpy(arrs[k]).requires_grad_() for k in names}
    st, y = ssm._ssd_chunk(*(leaves[k] for k in names))
    for got, want in zip((st, y), jref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    (torch.sum(y * torch.from_numpy(gy))
     + torch.sum(st * torch.from_numpy(gs))).backward()
    wide = {k: torch.from_numpy(arrs[k]).double().requires_grad_()
            for k in names}
    st64, y64 = _ssd_recurrence(*(wide[k] for k in names))
    (torch.sum(y64 * torch.from_numpy(gy).double())
     + torch.sum(st64 * torch.from_numpy(gs).double())).backward()
    for k in names:
        got, want = leaves[k].grad.numpy(), wide[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_cross_entropy_matches_jax():
    """Masked labels (< 0) drop out of the mean; an all-masked batch
    divides by 1, not 0."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, -1] = -100
    for lab in (labels, np.full_like(labels, -1)):
        want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab)))
        got = float(cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cross_entropy_of_bf16_logits_computes_in_float32():
    logits = torch.randn(2, 5, 40, generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, 40, (2, 5), generator=torch.Generator())
    got = cross_entropy(logits.to(torch.bfloat16), labels)
    want = cross_entropy(logits.to(torch.bfloat16).float(), labels)
    assert got.dtype == torch.float32 and float(got) == float(want)


def test_cosine_with_warmup_matches_jax():
    """Every step of warmup, cosine and the floor past total_steps. The
    two libraries' float32 cos round apart by up to one ulp; 1 + cos
    cancels near the end of the cosine (t -> 1), where one ulp of cos is
    many ulps of the lr. So: within one float32 ulp of the lr through the
    warmup and the first half of the cosine, and everywhere within one
    ulp plus what one ulp of cos (2^-23 at most) moves the lr by,
    0.5 (base_lr - min_lr) 2^-23."""
    kw = dict(base_lr=1e-3, min_lr=1e-7, warmup_start=1e-5, warmup_steps=20,
              total_steps=120)
    steps = np.arange(0, 140)
    want = np.array([float(jax_cosine(int(s), **kw)) for s in steps],
                    np.float32)
    got = np.array([float(cosine_with_warmup(int(s), **kw)) for s in steps],
                   np.float32)
    first_half = steps <= 20 + 50
    assert _ulps(got[first_half], want[first_half]).max() <= 1
    ulp = np.spacing(np.abs(want))
    cos_ulp = 0.5 * (kw["base_lr"] - kw["min_lr"]) * 2.0 ** -23
    assert np.all(np.abs(got - want) <= ulp + cos_ulp)
    assert np.all(got[steps >= 120] == want[steps >= 120])
    t = cosine_with_warmup(torch.tensor(7, dtype=torch.int32), **kw)
    assert t.dtype == torch.float32 and t.shape == ()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_adamw_update_matches_jax(int8):
    """Three updates, each from the same params, moments and gradients on
    both sides (random gradients, none near 0): the INT8 moments' q bytes
    equal, their scales and every float32 moment and param within one ulp
    (the bias corrections' pow may round apart). Leaves: a 700-element
    matrix (3 INT8 blocks, the last padded), a 40-element vector (float32
    moments either way) and a scalar."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(0, 1, (20, 35)).astype(np.float32),
              "b": {"v": rng.normal(0, 1, (40,)).astype(np.float32),
                    "s": np.float32(0.5)}}
    jstate = jax_adamw_init(jax.tree_util.tree_map(jnp.asarray, params),
                            int8_state=int8)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 1, np.shape(p)).astype(np.float32),
            params)
        jp, jst = jax_adamw_update(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, lr=1e-3)
        tstate = AdamWState(
            step=torch.tensor(int(jstate.step), dtype=torch.int32),
            m=params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.m),
                                "cpu"),
            v=params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.v),
                                "cpu"))
        tp, tst = adamw_update(params_from_numpy(params, "cpu"),
                               params_from_numpy(grads, "cpu"), tstate,
                               lr=1e-3)
        assert int(tst.step) == int(jst.step) == step + 1
        for name, j, t in (("p", jp, tp), ("m", jst.m, tst.m),
                           ("v", jst.v, tst.v)):
            jl = _grad_leaves(jax.tree_util.tree_map(np.asarray, j))
            tl = _grad_leaves(t)
            assert set(jl) == set(tl), name
            for key in jl:
                a, b = tl[key].numpy(), jl[key]
                assert a.dtype == b.dtype and a.shape == b.shape, key
                if a.dtype == np.int8:
                    np.testing.assert_array_equal(a, b, err_msg=name + key)
                else:
                    assert _ulps(a, b).max() <= 1, (name, key)
        if int8:
            assert isinstance(tst.m["w"], dict) and "sqrt" in tst.v["w"]
            assert not isinstance(tst.m["b"]["v"], dict)
        params, jstate = jax.tree_util.tree_map(np.asarray, jp), jst


def _reference_curve(jcfg, jp, batches, microbatches, compression):
    """The reference's train step without a mesh: value_and_grad of its
    loss_fn, float32 accumulation over microbatches, compress_tree, the
    cosine schedule and adamw_update (as repro.launch.steps does)."""
    vg = jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=2)
    state = jax_adamw_init(jp)
    losses = []
    for b in batches:
        if microbatches > 1:
            n = b["tokens"].shape[0] // microbatches
            loss = jnp.zeros((), jnp.float32)
            acc = jax.tree_util.tree_map(
                lambda p: jnp.zeros(p.shape, jnp.float32), jp)
            for i in range(microbatches):
                mb = {k: jnp.asarray(v[i * n:(i + 1) * n])
                      for k, v in b.items()}
                l, g = vg(jp, mb, jcfg)
                loss, acc = loss + l, jax.tree_util.tree_map(jnp.add, acc, g)
            loss = loss / microbatches
            grads = jax.tree_util.tree_map(lambda g: g / microbatches, acc)
        else:
            loss, grads = vg(jp, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg)
        if compression:
            grads = jax_compress_tree(grads)
        jp, state = jax_adamw_update(jp, grads, state,
                                     lr=jax_cosine(state.step))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("microbatches,compression", [
    pytest.param(1, False, id="full-batch"),
    pytest.param(4, False, id="microbatches-4"),
    pytest.param(1, True, id="grad-compression")])
def test_train_step_loss_curve_matches_jax(microbatches, compression):
    """Three steps of build_train_step against the reference's
    value_and_grad + adamw loop on the same batches, reduced tinyllama in
    float32."""
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    jp, tp = _params(jcfg)
    ds = JaxDataset(jcfg, BATCH, SEQ, seed=0)
    batches = [ds.batch_at(s) for s in range(3)]
    want = _reference_curve(jcfg, jp, batches, microbatches, compression)
    step = build_train_step(cfg, microbatches=microbatches,
                            grad_compression=compression)
    state = adamw_init(tp)
    got = []
    for b in batches:
        tp, state, loss = step(tp, state, b)
        got.append(float(loss))
        assert not loss.requires_grad
        assert all(p.requires_grad for p in tree_leaves(tp))
    assert int(state.step) == 3
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)


def test_train_step_lowers_the_loss_and_microbatches_agree():
    """The port on its own: a few steps lower the loss, and one step at
    4 microbatches equals the full batch's loss within float32 sums."""
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    _, tp = _params(jcfg)
    ds = SyntheticLMDataset(cfg, BATCH, SEQ, seed=0)
    l1 = build_train_step(cfg)(tp, adamw_init(tp), ds.batch_at(0))[2]
    l4 = build_train_step(cfg, microbatches=4)(tp, adamw_init(tp),
                                               ds.batch_at(0))[2]
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    step, state, losses = build_train_step(cfg), adamw_init(tp), []
    for s in range(8):
        tp, state, loss = step(tp, state, ds.batch_at(s % 2))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError):
        build_train_step(cfg, microbatches=3)(tp, state, ds.batch_at(0))


def _grad_tree(rng):
    """Leaves under a block (kept as they are), a ragged multiple and a
    whole number of 256-element blocks, and an all-zero block."""
    return {"small": rng.normal(0, 1, (100,)).astype(np.float32),
            "ragged": rng.normal(0, 3, (7, 77)).astype(np.float32),
            "blocks": {"w": np.concatenate(
                [np.zeros(256, np.float32),
                 rng.normal(0, 1e-3, 512).astype(np.float32)])}}


def test_compress_tree_and_error_feedback_match_jax_bytewise():
    rng = np.random.default_rng(2)
    g = _grad_tree(rng)
    want = _grad_leaves(jax.tree_util.tree_map(
        np.asarray, jax_compress_tree(jax.tree_util.tree_map(jnp.asarray, g))))
    got = _grad_leaves(compress_tree(params_from_numpy(g, "cpu")))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    jef = JaxEF.init(jax.tree_util.tree_map(jnp.asarray, g))
    tef = EFCompressor.init(params_from_numpy(g, "cpu"))
    for _ in range(3):
        g = _grad_tree(rng)
        jc, jef = jef.compress(jax.tree_util.tree_map(jnp.asarray, g))
        tc, tef = tef.compress(params_from_numpy(g, "cpu"))
        for name, j, t in (("comp", jc, tc), ("res", jef.residual,
                                              tef.residual)):
            jl = _grad_leaves(jax.tree_util.tree_map(np.asarray, j))
            tl = _grad_leaves(t)
            for key in jl:
                np.testing.assert_array_equal(tl[key].numpy(), jl[key],
                                              name + key)


@pytest.mark.parametrize("arch,seed,hosts", [
    pytest.param("tinyllama-1.1b", 1, 1, id="tinyllama"),
    pytest.param("tinyllama-1.1b", 5, 2, id="tinyllama-2-hosts"),
    pytest.param("whisper-base", 0, 1, id="whisper-frames"),
    pytest.param("pixtral-12b", 0, 2, id="pixtral-patches-2-hosts")])
def test_dataset_batches_match_jax_bytewise(arch, seed, hosts):
    jcfg, cfg = _cfgs(arch)
    for host in range(hosts):
        jds = JaxDataset(jcfg, 4, 32, seed=seed, host_id=host, n_hosts=hosts)
        tds = SyntheticLMDataset(cfg, 4, 32, seed=seed, host_id=host,
                                 n_hosts=hosts)
        for step in (0, 3, 11):
            want, got = jds.batch_at(step), tds.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].tobytes() == want[k].tobytes(), (k, step)
    with pytest.raises(ValueError):
        SyntheticLMDataset(cfg, 3, 32, n_hosts=2)


def test_pipeline_streams_batch_at_from_its_start():
    _, cfg = _cfgs("tinyllama-1.1b")
    ds = SyntheticLMDataset(cfg, 2, 16, seed=4)
    pipe = make_pipeline(ds, start_step=5)
    try:
        for step in range(5, 9):
            b = next(pipe)
            np.testing.assert_array_equal(b["tokens"],
                                          ds.batch_at(step)["tokens"])
    finally:
        pipe.close()


def _train_state(int8):
    """(params, AdamWState) as the port's CPU tensors: bf16 and float32
    leaves, INT8 moments for the large ones with ``int8``, after one
    update so nothing is zero."""
    rng = np.random.default_rng(7)
    params = {"w": torch.from_numpy(rng.normal(0, 1, (24, 40)).astype(
                  np.float32)).to(torch.bfloat16),
              "n": {"scale": torch.from_numpy(
                  rng.normal(0, 1, (40,)).astype(np.float32))}}
    state = adamw_init(params, int8_state=int8)
    grads = {"w": torch.ones(24, 40, dtype=torch.bfloat16),
             "n": {"scale": torch.full((40,), 0.5)}}
    return adamw_update(params, grads, state, lr=1e-3)


def _same_tree(a, b):
    la, lb = _grad_leaves_any(a), _grad_leaves_any(b)
    assert set(la) == set(lb)
    for key in la:
        x, y = la[key], lb[key]
        x = x.view(torch.int16).numpy() if (
            isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16) else \
            np.asarray(x)
        y = y.view(torch.int16).numpy() if (
            isinstance(y, torch.Tensor) and y.dtype == torch.bfloat16) else \
            np.asarray(y)
        if y.dtype.name == "bfloat16":
            y = y.view(np.int16)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key


def _grad_leaves_any(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_grad_leaves_any(v, f"{prefix}/{k}"))
    return out


def test_checkpoint_manager_saves_async_keeps_and_resumes(tmp_path):
    """Every ``every`` steps, a host copy taken at the call (later updates
    in place do not reach it), ``keep`` newest steps, resume from the
    latest; a NamedTuple state is keyed by its fields."""
    params, state = _train_state(int8=True)
    mgr = CheckpointManager(str(tmp_path), keep=2, every=2)
    assert mgr.restore_or_none((params, state)) is None
    for step in range(1, 8):
        mgr.maybe_save(step, (params, state), extra={"loss": float(step)})
        if step == 6:
            at_6 = params["n"]["scale"].clone()
        params["n"]["scale"].add_(1.0)           # the loop goes on
    mgr.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_0000000004", "step_0000000006"]
    (rp, rs), step, extra = mgr.restore_or_none((params, state))
    assert step == 6 and extra == {"loss": 6.0}
    assert isinstance(rs, AdamWState) and isinstance(rs.m["w"], dict)
    np.testing.assert_array_equal(rp["n"]["scale"].numpy(), at_6.numpy())
    keys = [e["key"] for e in json.loads(
        (tmp_path / "step_0000000006" / "manifest.json").read_text())["keys"]]
    assert "1/.m/w/q" in keys and "1/.v/w/sqrt" in keys and "1/.step" in keys


def test_checkpoint_manager_surfaces_a_write_error_on_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    mgr = CheckpointManager(str(blocker / "ckpt"), every=1)
    mgr.maybe_save(1, {"w": torch.ones(3)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                   # raised once, then clear


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_training_checkpoints_read_across_packages(tmp_path, int8):
    """(params, AdamWState) written by the port loads in the reference
    into its own tree bit for bit (bf16 params, INT8 moments), and the
    reference's loads in the port."""
    params, state = _train_state(int8)
    save_checkpoint(str(tmp_path / "port"), 3, (params, state))
    jtree = (jax.tree_util.tree_map(
                 lambda t: jnp.zeros(t.shape, jnp.bfloat16
                                     if t.dtype == torch.bfloat16
                                     else jnp.float32), params),
             jax_adamw_init(jax.tree_util.tree_map(
                 lambda t: jnp.zeros(t.shape, jnp.float32), params),
                 int8_state=int8))
    restored, step, _ = jax_load_checkpoint(str(tmp_path / "port"), jtree)
    assert step == 3
    _same_tree((params, tuple(state)), (restored[0], tuple(restored[1])))
    jax_save_checkpoint(str(tmp_path / "ref"), 4, restored)
    back, step, _ = load_checkpoint(str(tmp_path / "ref"), (params, state))
    assert step == 4 and isinstance(back[1], AdamWState)
    _same_tree((params, tuple(state)), (back[0], tuple(back[1])))


def test_resume_after_step_k_equals_the_uninterrupted_run(tmp_path):
    """The train CLI (reduced tinyllama, bf16, on the CPU): 6 steps
    straight, against 3 steps with a checkpoint at 3 and a second run
    that resumes there; steps 3-5 give the same losses (rtol 1e-5, as
    tests/test_system.py holds the reference)."""
    args = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "4",
            "--seq", "32", "--device", "cpu", "--log-every", "100"]
    full = train_cli.main(args + ["--steps", "6"])
    d = str(tmp_path / "ckpt")
    first = train_cli.main(args + ["--steps", "3", "--ckpt-dir", d,
                                   "--ckpt-every", "3"])
    assert latest_step(d) == 3
    rest = train_cli.main(args + ["--steps", "6", "--ckpt-dir", d,
                                  "--ckpt-every", "3"])
    assert len(first) == 3 and len(rest) == 3 and latest_step(d) == 6
    np.testing.assert_allclose(first + rest, full, rtol=1e-5)


def test_train_cli_lowers_the_loss_with_dbpim_projection():
    """Fig. 4 stage 2 in the loop: the FTA projection every 10 steps, and
    the loss still falls (tests/test_system.py's check of the
    reference)."""
    losses = train_cli.main(["--arch", "tinyllama-1.1b", "--reduced",
                             "--steps", "20", "--batch", "8", "--seq", "64",
                             "--dbpim-every", "10", "--log-every", "100",
                             "--device", "cpu"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_cli_int8_optimizer_and_grad_compression():
    losses = train_cli.main(["--arch", "tinyllama-1.1b", "--reduced",
                             "--steps", "4", "--batch", "4", "--seq", "32",
                             "--int8-opt", "--grad-compression",
                             "--microbatches", "2", "--log-every", "100",
                             "--device", "cpu"])
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_run_resilient_restarts_and_degrades():
    """The reference's cases: two injected failures, three loop calls,
    the plan halved from the second failure on; the plan's floor."""
    calls, saved, plans = {"n": 0}, {"step": 0}, []

    def loop(start, plan):
        calls["n"] += 1
        plans.append(plan)
        for s in range(start, 50):
            if calls["n"] <= 2 and s == 10 + calls["n"]:
                raise RuntimeError("injected failure")
            saved["step"] = s + 1
        return 50

    seen = []
    final = run_resilient(loop, total_steps=50,
                          restore_step=lambda: saved["step"],
                          plan=ElasticMeshPlan(data_parallel=4,
                                               model_parallel=2),
                          on_failure=seen.append)
    assert final == 50 and calls["n"] == 3 and len(seen) == 2
    assert [(p.data_parallel, p.model_parallel) for p in plans] == [
        (4, 2), (4, 2), (2, 2)]
    d = ElasticMeshPlan(2, 2).degrade()
    assert (d.data_parallel, d.model_parallel) == (1, 2)
    with pytest.raises(RuntimeError):
        d.degrade()

    def always(start, plan):
        raise ValueError("down")
    with pytest.raises(RuntimeError, match="exceeded 2 failures"):
        run_resilient(always, total_steps=5, restore_step=lambda: 0,
                      max_failures=2)


def test_serving_forward_stays_out_of_autograd():
    """Trainable params through the serving callers (decode.prefill, a
    forward under no_grad) give tensors that record no graph; the same
    forward with grad on records one."""
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    _, tp = _params(jcfg)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    assert not prefill(tp, toks, cfg).requires_grad
    with torch.no_grad():
        assert not forward(tp, toks, cfg).requires_grad
    assert forward(tp, toks, cfg).requires_grad
