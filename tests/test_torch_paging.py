"""The port's paged KV cache, held against the JAX package: the page
allocator decides as the reference's on seeded operation sequences; the
paged ``decode_attention`` / ``prefill_attention`` agree with the
reference's own on the same pool and page table, and bitwise with the
port's contiguous path on the gathered view; the page-table surgery of
``reset_slots`` and the paged ``corrupt_cache`` touch the pages the
reference's touch; and the port's engine, on reduced fp32 tinyllama,
serves an ample pool bitwise the contiguous engine with one compiled
signature per step kind, preempts under a tight pool and resumes bitwise,
judges oversized requests against paged capacity, adds the reference's
page-wait floor to its queue estimate, restores a paged kill-chaos run
bitwise and refuses windowed archs and a mismatched snapshot geometry."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import decode as jax_decode
from repro.serving import faults as jax_faults
from repro.serving import paging as jax_paging
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import (init_cache, init_params, reset_slots,
                                reset_slots_)
from repro_torch.models import attention as attn
from repro_torch.serving import (EngineCrash, FaultEvent, FaultPlan,
                                 Request, ServeEngine, WorkloadSpec,
                                 make_trace)
from repro_torch.serving import faults, paging
from repro_torch.serving.snapshot import SnapshotError, restore_engine_state

pytestmark = pytest.mark.port

SPEC = WorkloadSpec(n_requests=10, arrival_rate=1.0, prompt_len=(3, 10),
                    gen_len=(3, 6), dist="uniform", seed=7)
ENGINE_KW = dict(n_slots=3, max_len=24, prefill_chunk=4)
PAGE_SIZE = 4
TIGHT_PAGES = 8        # < n_slots * max_len / page_size = 18
SNAPSHOT_EVERY = 6
CRASH_TICKS = (8, 13)  # both past the first snapshot tick


# ------------------------------------------------------- the allocator --

def _ops(seed, n=400):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        s, op = int(rng.integers(0, 4)), rng.random()
        if op < 0.5:
            yield "grow", s, int(rng.integers(0, 8))
        elif op < 0.8:
            yield "release", s, None
        elif op < 0.9:
            yield "roundtrip", s, None
        else:
            yield "pages_for", s, int(rng.integers(0, 40))


@pytest.mark.parametrize("seed", [0, 1, 13, 21])
def test_allocator_decides_as_the_reference(seed):
    """Seeded grow / release / snapshot round trips: every return value,
    table, slot_pages, version and free count equal the reference's."""
    kw = dict(n_pages=12, n_slots=4, max_pages_per_slot=6, page_size=4)
    mine, ref = paging.PageAllocator(**kw), jax_paging.PageAllocator(**kw)
    for op, s, arg in _ops(seed):
        if op == "grow":
            assert mine.can_grow(s, arg) == ref.can_grow(s, arg)
            assert mine.grow(s, arg) == ref.grow(s, arg)
        elif op == "release":
            assert mine.release(s) == ref.release(s)
        elif op == "roundtrip":
            mine.load_slot_pages(mine.slot_pages())
            ref.load_slot_pages(ref.slot_pages())
        else:
            assert mine.pages_for(arg) == ref.pages_for(arg)
        mine.check()
        assert np.array_equal(mine.table(), ref.table())
        assert mine.slot_pages() == ref.slot_pages()
        assert (mine.version, mine.free_pages, mine.used_pages,
                mine.owned(s)) == (ref.version, ref.free_pages,
                                   ref.used_pages, ref.owned(s))


@pytest.mark.parametrize("tables", [[[0, 1], [1]], [[0], [9]], [[0]],
                                    [[0, 1, 2, 3, 0], []]],
                         ids=["shared", "out_of_range", "slot_count",
                              "over_cap"])
def test_allocator_refuses_corrupt_tables_as_the_reference(tables):
    kw = dict(n_pages=4, n_slots=2, max_pages_per_slot=4, page_size=4)
    for mod in (paging, jax_paging):
        with pytest.raises(mod.PageAllocError):
            mod.PageAllocator(**kw).load_slot_pages(tables)
    with pytest.raises(ValueError):
        paging.PageAllocator(0, 2, 4, 4)


# ------------------------------------------- attention over the pool --

B, NP, PS, MP = 3, 9, 4, 4


def _layer(seed):
    """One attention layer's weights, the reference's page pool, a page
    table (slot 2 owns one page, the rest of its row unallocated) and
    per-slot positions, from numpy seeds; the JAX and torch configs."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True).scaled(
        dtype="float32")
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    rng = np.random.default_rng(seed)
    D, H, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.normal(0, D ** -0.5, (D, cfg.q_dim)),
         "wk": rng.normal(0, D ** -0.5, (D, cfg.kv_dim)),
         "wv": rng.normal(0, D ** -0.5, (D, cfg.kv_dim)),
         "wo": rng.normal(0, cfg.q_dim ** -0.5, (cfg.q_dim, D))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    pool = rng.normal(size=(2, NP, PS, H, hd)).astype(np.float32)
    ptab = np.array([[4, 0, 7, 2], [1, 8, 3, 6], [5, -1, -1, -1]], np.int32)
    pos = np.array([9, 14, 2], np.int32)
    return jcfg, cfg, p, pool, ptab, pos, rng


def _port_pool(pool):
    """The reference's pool with the port's spare page appended."""
    spare = np.zeros(pool.shape[:1] + (1,) + pool.shape[2:], pool.dtype)
    return torch.from_numpy(np.concatenate([pool, spare], axis=1))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "write_mask"])
def test_paged_decode_attention_matches_the_reference(seed, masked):
    jcfg, cfg, p, pool, ptab, pos, rng = _layer(seed)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    wm = np.array([True, not masked, True])
    out_j, k_j, v_j = jax_attn.decode_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pool[0]), jnp.asarray(pool[1]), jnp.asarray(pos), jcfg,
        ptab=jnp.asarray(ptab), write_mask=jnp.asarray(wm))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    pk, pv = _port_pool(pool)
    out, k, v = attn.decode_attention(
        tp, torch.from_numpy(x), pk, pv, torch.from_numpy(pos), cfg,
        ptab=torch.from_numpy(ptab), write_mask=torch.from_numpy(wm))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(k[:NP].numpy(), np.asarray(k_j), atol=2e-5)
    np.testing.assert_allclose(v[:NP].numpy(), np.asarray(v_j), atol=2e-5)
    # in place with ``active``: the same pools and outputs, bitwise
    pk2, pv2 = pk.clone(), pv.clone()
    out2, k2, v2 = attn.decode_attention(
        tp, torch.from_numpy(x), pk2, pv2, torch.from_numpy(pos), cfg,
        ptab=torch.from_numpy(ptab), active=torch.from_numpy(wm))
    assert k2 is pk2 and torch.equal(k2[:NP], k[:NP])
    assert torch.equal(v2[:NP], v[:NP]) and torch.equal(out2, out)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_prefill_attention_matches_the_reference(seed):
    jcfg, cfg, p, pool, ptab, pos, rng = _layer(seed)
    C = 4
    pos = np.array([4, 8, 0], np.int32)
    n_valid = np.array([4, 2, 3], np.int32)
    x = rng.normal(size=(B, C, cfg.d_model)).astype(np.float32)
    out_j, k_j, v_j = jax_attn.prefill_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pool[0]), jnp.asarray(pool[1]), jnp.asarray(pos),
        jnp.asarray(n_valid), jcfg, ptab=jnp.asarray(ptab))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    pk, pv = _port_pool(pool)
    args = (tp, torch.from_numpy(x))
    rest = (torch.from_numpy(pos), torch.from_numpy(n_valid), cfg)
    out, k, v = attn.prefill_attention(*args, pk, pv, *rest,
                                       ptab=torch.from_numpy(ptab))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(k[:NP].numpy(), np.asarray(k_j), atol=2e-5)
    np.testing.assert_allclose(v[:NP].numpy(), np.asarray(v_j), atol=2e-5)
    pk2, pv2 = pk.clone(), pv.clone()
    out2, k2, _ = attn.prefill_attention(*args, pk2, pv2, *rest,
                                         inplace=True,
                                         ptab=torch.from_numpy(ptab))
    assert k2 is pk2 and torch.equal(k2[:NP], k[:NP])
    assert torch.equal(out2, out)


def test_paged_attention_is_bitwise_the_contiguous_one():
    """The gathered view handed to the contiguous path gives the same
    output bits, decode and chunk (every written page allocated)."""
    _, cfg, p, pool, ptab, pos, rng = _layer(3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    pk, pv = _port_pool(pool)
    t = torch.from_numpy(ptab)
    view = [attn._paged_view(c, t, cfg.n_kv_heads, cfg.hd) for c in (pk, pv)]
    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(
        np.float32))
    out_p, _, _ = attn.decode_attention(tp, x, pk.clone(), pv.clone(),
                                        torch.from_numpy(pos), cfg, ptab=t)
    out_c, _, _ = attn.decode_attention(tp, x, view[0], view[1],
                                        torch.from_numpy(pos), cfg)
    assert torch.equal(out_p, out_c)
    xc = torch.from_numpy(rng.normal(size=(B, 4, cfg.d_model)).astype(
        np.float32))
    cpos, nv = torch.tensor([4, 8, 0]), torch.tensor([4, 2, 3])
    out_p, _, _ = attn.prefill_attention(tp, xc, pk.clone(), pv.clone(),
                                         cpos, nv, cfg, ptab=t)
    out_c, _, _ = attn.prefill_attention(tp, xc, view[0], view[1], cpos, nv,
                                         cfg)
    assert torch.equal(out_p, out_c)


def test_reset_and_corrupt_touch_the_reference_pages():
    """reset_slots zeroes exactly the pages the masked slots' rows name
    (functional and in place), and a paged corrupt_cache poisons the whole
    pool, spare page aside, as the reference's merge_slots does."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True).scaled(
        dtype="float32")
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    rng = np.random.default_rng(5)
    jc = jax_decode.init_cache(jcfg, B, 16, n_pages=NP, page_size=PS)
    shape = jc["attn"]["pk"].shape
    pools = {k: rng.normal(size=shape).astype(np.float32)
             for k in ("pk", "pv")}
    jc["attn"] = {k: jnp.asarray(v) for k, v in pools.items()}
    jc["pos"] = jnp.asarray([3, 5, 1], jnp.int32)
    c = init_cache(cfg, B, 16, device="cpu", n_pages=NP, page_size=PS)
    assert c["attn"]["pk"].shape == (shape[0], NP + 1) + shape[2:]
    for k in ("pk", "pv"):
        c["attn"][k][:, :NP] = torch.from_numpy(pools[k])
    c["pos"] = torch.tensor([3, 5, 1], dtype=torch.int32)
    ptab = np.array([[4, 0, -1, -1], [1, 8, 3, -1], [5, 2, -1, -1]],
                    np.int32)
    mask = np.array([True, False, True])
    ref = jax_decode.reset_slots(jc, jnp.asarray(mask), jcfg,
                                 ptab=jnp.asarray(ptab))
    mine = reset_slots(c, torch.from_numpy(mask), cfg,
                       ptab=torch.from_numpy(ptab))
    reset_slots_(c, torch.from_numpy(mask), cfg, ptab=torch.from_numpy(ptab))
    for k in ("pk", "pv"):
        want = np.asarray(ref["attn"][k])
        assert np.array_equal(mine["attn"][k][:, :NP].numpy(), want)
        assert np.array_equal(c["attn"][k][:, :NP].numpy(), want)
    assert np.array_equal(c["pos"].numpy(), np.asarray(ref["pos"]))
    spare = c["attn"]["pk"][:, NP].clone()
    poisoned = jax_faults.corrupt_cache(ref, [1], B, jcfg)
    faults.corrupt_cache(c, [1], B)
    for k in ("pk", "pv"):
        assert np.array_equal(np.isnan(np.asarray(poisoned["attn"][k])),
                              torch.isnan(c["attn"][k][:, :NP]).numpy())
    assert torch.equal(c["attn"]["pk"][:, NP], spare)


# ---------------------------------------------------------- the engine --

@pytest.fixture(scope="module")
def served():
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    params = init_params(cfg, device="cpu")
    trace = make_trace(SPEC, cfg.vocab_size)
    ref_out = ServeEngine(cfg, params, device="cpu", **ENGINE_KW).run(trace)
    return cfg, params, trace, ref_out


def _signatures(engine):
    return engine.sentinel.counts()


def test_ample_pool_is_bitwise_contiguous_with_one_signature(served):
    cfg, params, trace, ref_out = served
    engine = ServeEngine(cfg, params, paged=True, page_size=PAGE_SIZE,
                         device="cpu", **ENGINE_KW)
    assert engine.run(trace) == ref_out
    s = engine.metrics.summary()
    assert s["n_preemptions"] == 0 and s["page_alloc_failures"] == 0
    assert s["pages_total"] == 18 and s["pages_used_max"] > 0
    assert set(_signatures(engine).values()) == {1}, _signatures(engine)
    engine.page_alloc.check()


def test_tight_pool_preempts_and_resumes_bitwise(served):
    cfg, params, trace, ref_out = served
    engine = ServeEngine(cfg, params, paged=True, page_size=PAGE_SIZE,
                         n_pages=TIGHT_PAGES, device="cpu", **ENGINE_KW)
    out = engine.run(trace)
    s = engine.metrics.summary()
    assert s["n_preemptions"] >= 1 and s["page_alloc_failures"] >= 1
    assert out == ref_out
    assert s["pages_used_max"] <= TIGHT_PAGES
    assert engine.page_alloc.free_pages == TIGHT_PAGES
    assert set(_signatures(engine).values()) == {1}


def test_oversized_judged_against_paged_capacity(served):
    cfg, params, _, _ = served
    engine = ServeEngine(cfg, params, paged=True, page_size=PAGE_SIZE,
                         n_pages=2, device="cpu", **ENGINE_KW)
    big = Request(rid=0, prompt=tuple(range(1, 10)), gen_len=4)  # 13 > 8
    assert not engine.submit(big)
    assert engine.rejected[0] == "oversized"
    assert engine.submit(Request(rid=1, prompt=(1, 2, 3), gen_len=2))
    strict = ServeEngine(cfg, params, paged=True, page_size=PAGE_SIZE,
                         n_pages=2, strict=True, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="page pool"):
        strict.submit(big)
    with pytest.raises(ValueError, match="max_len % page_size"):
        ServeEngine(cfg, params, paged=True, page_size=5, device="cpu",
                    **ENGINE_KW)


@pytest.mark.parametrize("mode,chunk", [("chunked", 4), ("chunked", 1),
                                        ("full", 4)])
def test_page_wait_floor_as_the_reference(mode, chunk):
    """The queue estimate of the port's and the reference's
    ``_min_ticks_to_done``, called unbound on stubs with allocators in the
    same states: equal for every prompt and generation length, queued or
    not, paged or not."""
    def stub(mod, paged):
        return types.SimpleNamespace(
            prefill_chunk=chunk, prefill_mode=mode, paged=paged,
            page_alloc=mod.PageAllocator(5, 3, 6, PAGE_SIZE))
    for paged in (False, True):
        mine, ref = stub(paging, paged), stub(jax_paging, paged)
        for grab in (0, 2, 2, 1):
            for a in (mine, ref):
                a.page_alloc.grow(len(a.page_alloc.slot_pages()[0]) and 1,
                                  grab)
            for p in range(0, 30):
                for g in range(0, 6):
                    for queued in (False, True):
                        assert ServeEngine._min_ticks_to_done(
                            mine, p, g, queued) == \
                            JaxEngine._min_ticks_to_done(ref, p, g, queued)
        assert mine.page_alloc.slot_pages() == ref.page_alloc.slot_pages()


def test_paged_kill_chaos_is_bitwise(served, tmp_path):
    """Paged, oversubscribed and killed at two ticks: restore rebuilds the
    page tables, admission ages and the preempted deque from the snapshot
    and the journal tail, and every stream ends bitwise the contiguous
    run's, within the replay bound."""
    cfg, params, trace, ref_out = served
    jpath, snapdir = str(tmp_path / "j.jsonl"), str(tmp_path / "snaps")
    plan = FaultPlan(events=tuple(
        FaultEvent(tick=t, kind="engine_crash") for t in CRASH_TICKS))
    engine = ServeEngine(cfg, params, journal=jpath, snapshot_dir=snapdir,
                         snapshot_every=SNAPSHOT_EVERY, fault_plan=plan,
                         paged=True, page_size=PAGE_SIZE,
                         n_pages=TIGHT_PAGES, device="cpu", **ENGINE_KW)
    crashes, outputs, preempted = 0, None, 0
    try:
        outputs = engine.run(trace)
    except EngineCrash as e:
        crashes, last_tick = 1, e.tick
    while outputs is None:
        engine = ServeEngine.restore(cfg, params, snapshot_dir=snapdir,
                                     journal_path=jpath, fault_plan=plan,
                                     device="cpu")
        assert engine.paged and engine.page_size == PAGE_SIZE
        assert engine.n_pages == TIGHT_PAGES
        engine.page_alloc.check()
        assert engine.tick_count > last_tick
        st = engine.restore_stats
        assert st["replayed_prefill_tokens"] \
            <= SNAPSHOT_EVERY * max(st["slots_restored"], 1)
        try:
            outputs = engine.resume()
        except EngineCrash as e:
            crashes, last_tick = crashes + 1, e.tick
        preempted = max(preempted, engine.metrics.summary()["n_preemptions"])
        assert max(_signatures(engine).values()) <= 1
    assert crashes == len(CRASH_TICKS)
    assert preempted >= 1
    assert outputs == ref_out


def test_paged_snapshot_geometry_mismatch_refused(served, tmp_path):
    from repro_torch.checkpoint import latest_step
    cfg, params, trace, _ = served
    snapdir = str(tmp_path / "snaps")
    engine = ServeEngine(cfg, params, snapshot_dir=snapdir,
                         snapshot_every=SNAPSHOT_EVERY, paged=True,
                         page_size=PAGE_SIZE, n_pages=TIGHT_PAGES,
                         device="cpu", **ENGINE_KW)
    engine.run(trace)
    step = latest_step(snapdir)
    contiguous = ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
    with pytest.raises(SnapshotError, match="paged"):
        restore_engine_state(contiguous, snapdir, step)
    other = ServeEngine(cfg, params, paged=True, page_size=PAGE_SIZE,
                        n_pages=TIGHT_PAGES + 1, device="cpu", **ENGINE_KW)
    with pytest.raises(SnapshotError, match="n_pages"):
        restore_engine_state(other, snapdir, step)


def test_windowed_arch_refuses_paging():
    cfg = get_config("mixtral-8x7b", reduced=True).scaled(dtype="float32")
    assert cfg.window
    with pytest.raises(ValueError, match="sliding-window"):
        init_cache(cfg, 2, 16, device="cpu", n_pages=4, page_size=4)
    with pytest.raises(ValueError, match="sliding-window"):
        ServeEngine(cfg, init_params(cfg, device="cpu"), paged=True,
                    page_size=4, n_slots=2, max_len=16, device="cpu")


def test_serve_cli_paged(capsys):
    """--paged --page-size --n-pages: a tight pool serves the streams of
    the contiguous CLI run and prints the pool's line."""
    from repro_torch.launch import serve
    base = ["--arch", "tinyllama-1.1b", "--reduced", "--dbpim-mode", "joint",
            "--device", "cpu", "--requests", "6", "--max-len", "24",
            "--gen-len", "4", "--prompt-len", "3", "10", "--prefill-chunk",
            "4", "--arrival-rate", "1.0", "--batch", "3"]
    contiguous = serve.main(base)
    capsys.readouterr()
    paged = serve.main(base + ["--paged", "--page-size", "4", "--n-pages",
                               "7"])
    assert paged == contiguous
    assert "page pool: 7 x 4-token pages" in capsys.readouterr().out
