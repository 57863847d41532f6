"""The port's checkpoints and engine snapshots, held against the JAX
package: a checkpoint written by either package loads through the other's
``load_checkpoint`` (bf16 bit for bit), the reference's
``read_snapshot_meta`` and ``load_checkpoint`` read a port snapshot, stray
``.tmp-*`` directories are swept and gc keeps ``snapshot_keep`` steps; and
the port's engine, on reduced fp32 tinyllama, journals and snapshots
passively, restores a kill-chaos run bitwise (the reference test's crash
ticks and cadence, within its replay bound, one compiled signature per
step kind), restores mamba2's exact chunks bitwise through the SSM state
leaves, journals a duplicate rid, carries its journal's path in
``EngineStuckError`` and refuses a snapshot of another geometry."""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.serving import snapshot as jax_snapshot
from repro.serving.journal import fold_records as jax_fold
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.obs import Tracer
from repro_torch.serving import (EngineCrash, EngineStuckError, FaultEvent,
                                 FaultPlan, ServeEngine, WorkloadSpec,
                                 make_trace)
from repro_torch.serving.journal import fold_records, read_journal
from repro_torch.serving.snapshot import (SnapshotError, read_snapshot_meta,
                                          restore_engine_state)

pytestmark = pytest.mark.port

SPEC = WorkloadSpec(n_requests=4, arrival_rate=0.5, prompt_len=(3, 10),
                    gen_len=(4, 6), dist="uniform", seed=11)
ENGINE_KW = dict(n_slots=2, max_len=24, prefill_chunk=4)
SNAPSHOT_EVERY = 3
CRASH_TICKS = (5, 9)


# ---------------------------------------------------------- checkpoints --

def _tree(seed):
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(3, 4, 5)).astype(np.float32)
    return {"cache": {"attn": {"k": torch.from_numpy(bf).to(torch.bfloat16),
                               "pos": torch.arange(4, dtype=torch.int32)},
                      "state": torch.from_numpy(rng.normal(size=(2, 6)))},
            "steps": [torch.tensor(7), torch.from_numpy(
                rng.integers(0, 9, (3,)).astype(np.int64))]}


def _bits(t):
    """The bits of a torch tensor or numpy array, as numpy."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if t.dtype == ml_dtypes.bfloat16:
        return t.view(np.uint16)
    return np.asarray(t)


def _flat(tree):
    return ckpt._flatten(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_checkpoint_loads_through_the_reference(tmp_path, seed):
    tree = _tree(seed)
    ckpt.save_checkpoint(str(tmp_path), 5, tree, extra={"note": "x"})
    like = jax.tree_util.tree_map(lambda t: _bits(t), tree)
    got, step, extra = jax_ckpt.load_checkpoint(str(tmp_path), like)
    assert (step, extra) == (5, {"note": "x"})
    assert got["cache"]["attn"]["k"].dtype == ml_dtypes.bfloat16
    mine = _flat(tree)
    for key, leaf in _flat(got).items():
        assert np.array_equal(_bits(leaf), _bits(mine[key])), key
    man = json.loads((tmp_path / "step_0000000005" / "manifest.json")
                     .read_text())
    assert [e["key"] for e in man["keys"]] == sorted(mine)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_checkpoint_loads_through_the_port(tmp_path, seed):
    rng = np.random.default_rng(seed)
    tree = {"cache": {"k": rng.normal(size=(2, 3)).astype(
                          ml_dtypes.bfloat16),
                      "pos": np.arange(3, dtype=np.int32)},
            "w": rng.normal(size=(4,)).astype(np.float32)}
    jax_ckpt.save_checkpoint(str(tmp_path), 2, tree)
    got, step, _ = ckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 2 and got["cache"]["k"].dtype == torch.bfloat16
    for key, leaf in _flat(tree).items():
        assert np.array_equal(_bits(_flat(got)[key]), _bits(leaf)), key
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.load_checkpoint(str(tmp_path), {"w": tree["w"]})


def test_stray_tmp_dirs_swept_and_gc_keeps_the_newest(tmp_path):
    stray = tmp_path / ".tmp-99-12345"
    stray.mkdir()
    (stray / "leaf00000.npy").write_bytes(b"half-written")
    assert ckpt.latest_step(str(tmp_path)) is None
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), step, _tree(step), keep=2)
    assert not stray.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_0000000003", "step_0000000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), _tree(0))


# ------------------------------------------------------------- engines --

@pytest.fixture(scope="module")
def served():
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    params = init_params(cfg, device="cpu")
    trace = make_trace(SPEC, cfg.vocab_size)
    engine = ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
    return cfg, params, trace, engine.run(trace), engine


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_reference_reads_a_port_snapshot(served, tmp_path, paged):
    """read_snapshot_meta of the JAX package reads a port snapshot (version
    2), and its load_checkpoint loads the cache leaves into the reference's
    own cache of the same geometry (the paged pool without the port's
    spare page)."""
    cfg, params, trace, _, _ = served
    snapdir = str(tmp_path / "snaps")
    kw = dict(paged=True, page_size=4, n_pages=9) if paged else {}
    engine = ServeEngine(cfg, params, snapshot_dir=snapdir,
                         snapshot_every=SNAPSHOT_EVERY, device="cpu",
                         **ENGINE_KW, **kw)
    engine.run(trace)
    step, extra = jax_snapshot.read_snapshot_meta(snapdir)
    assert (step, extra) == read_snapshot_meta(snapdir)
    assert extra["version"] == 2 and extra["engine"]["paged"] is paged
    assert extra["engine"]["arch"] == cfg.name
    if paged:
        assert len(extra["paging"]["slot_pages"]) == ENGINE_KW["n_slots"]
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True).scaled(
        dtype="float32")
    like = jax_init_cache(jcfg, ENGINE_KW["n_slots"], ENGINE_KW["max_len"],
                          n_pages=9 if paged else None,
                          page_size=4 if paged else None)
    like["pos"] = np.zeros((ENGINE_KW["n_slots"],), np.int32)
    if "pos" in like["attn"]:
        like["attn"]["pos"] = like["pos"]
    tree, _, _ = jax_ckpt.load_checkpoint(snapdir, {"cache": like}, step)
    for key, leaf in _flat(tree).items():
        assert np.asarray(leaf).shape == np.asarray(_flat(
            {"cache": like})[key]).shape, key


def test_journal_and_snapshots_are_passive(served, tmp_path):
    cfg, params, trace, ref_out, ref_engine = served
    jpath = str(tmp_path / "j.jsonl")
    engine = ServeEngine(cfg, params, journal=jpath,
                         snapshot_dir=str(tmp_path / "snaps"),
                         snapshot_every=SNAPSHOT_EVERY, device="cpu",
                         **ENGINE_KW)
    assert engine.run(trace) == ref_out
    s, r = engine.metrics.summary(), ref_engine.metrics.summary()
    assert s["device_calls"] == r["device_calls"]
    assert s["calls_by_kind"] == r["calls_by_kind"]
    recs, _, torn = read_journal(jpath)
    assert not torn
    fold = fold_records(recs)
    assert fold == jax_fold(recs)
    assert set(fold["done"]) == set(ref_out) and fold["tokens"] == ref_out
    assert ckpt.latest_step(str(tmp_path / "snaps")) is not None


def _kill_chaos(cfg, params, trace, tmp_path, crash_ticks, every, **kw):
    """Serve ``trace`` killed at ``crash_ticks``, restoring from the
    snapshots and the journal after each crash. Returns the outputs and
    every restored engine."""
    jpath, snapdir = str(tmp_path / "j.jsonl"), str(tmp_path / "snaps")
    plan = FaultPlan(events=tuple(
        FaultEvent(tick=t, kind="engine_crash") for t in crash_ticks))
    engine = ServeEngine(cfg, params, journal=jpath, snapshot_dir=snapdir,
                         snapshot_every=every, fault_plan=plan, device="cpu",
                         **kw)
    restored, outputs = [], None
    try:
        outputs = engine.run(trace)
    except EngineCrash as e:
        last = e.tick
    while outputs is None:
        engine = ServeEngine.restore(cfg, params, snapshot_dir=snapdir,
                                     journal_path=jpath, fault_plan=plan,
                                     device="cpu")
        assert engine.tick_count > last       # the crash never fires again
        restored.append(engine)
        try:
            outputs = engine.resume()
        except EngineCrash as e:
            last = e.tick
    recs, _, torn = read_journal(jpath)
    assert not torn and fold_records(recs)["tokens"] == outputs
    return outputs, restored


def test_kill_chaos_restart_is_bitwise(served, tmp_path):
    cfg, params, trace, ref_out, _ = served
    out, restored = _kill_chaos(cfg, params, trace, tmp_path, CRASH_TICKS,
                                SNAPSHOT_EVERY, **ENGINE_KW)
    assert len(restored) == len(CRASH_TICKS)
    assert out == ref_out
    for engine in restored:
        st = engine.restore_stats
        assert st["replayed_prefill_tokens"] \
            <= SNAPSHOT_EVERY * max(st["slots_restored"], 1)
        assert max(engine.sentinel.counts().values()) <= 1
    kinds = restored[0].metrics.summary()["calls_by_kind"]
    assert any(k.endswith("+restore") for k in kinds), kinds


def test_mamba2_exact_kill_chaos_is_bitwise(tmp_path):
    """The SSM state leaves ride the snapshot: mamba2's exact chunks,
    killed and restored, give the uninterrupted streams."""
    cfg = get_config("mamba2-1.3b", reduced=True).scaled(
        dtype="float32", prefill_exact=True)
    params = init_params(cfg, device="cpu")
    trace = make_trace(SPEC, cfg.vocab_size)
    ref_out = ServeEngine(cfg, params, device="cpu", **ENGINE_KW).run(trace)
    out, restored = _kill_chaos(cfg, params, trace, tmp_path, CRASH_TICKS,
                                SNAPSHOT_EVERY, **ENGINE_KW)
    assert len(restored) == len(CRASH_TICKS) and out == ref_out


def test_restore_tolerates_a_stray_tmp_dir(served, tmp_path):
    cfg, params, trace, ref_out, _ = served
    jpath, snapdir = str(tmp_path / "j.jsonl"), tmp_path / "snaps"
    ServeEngine(cfg, params, journal=jpath, snapshot_dir=str(snapdir),
                snapshot_every=SNAPSHOT_EVERY, device="cpu",
                **ENGINE_KW).run(trace)
    good = ckpt.latest_step(str(snapdir))
    stray = snapdir / ".tmp-99-12345"
    stray.mkdir()
    (stray / "leaf00000.npy").write_bytes(b"half-written garbage")
    assert ckpt.latest_step(str(snapdir)) == good
    restored = ServeEngine.restore(cfg, params, snapshot_dir=str(snapdir),
                                   journal_path=jpath, device="cpu")
    assert restored.restore_stats["from_step"] == good
    assert restored.resume() == ref_out
    restored.save_snapshot()
    assert not stray.exists()
    assert len(list(snapdir.glob("step_*"))) == restored.snapshot_keep


def test_duplicate_rid_rejected_and_journaled(served, tmp_path):
    cfg, params, trace, _, _ = served
    jpath = str(tmp_path / "j.jsonl")
    engine = ServeEngine(cfg, params, journal=jpath, device="cpu",
                         **ENGINE_KW)
    assert engine.submit(trace[0]) and not engine.submit(trace[0])
    assert engine.duplicate_rids == [trace[0].rid] and len(engine.queue) == 1
    assert engine.metrics.requests[trace[0].rid].outcome != "rejected"
    engine.journal.commit()
    recs, _, _ = read_journal(jpath)
    assert [r["kind"] for r in recs] == ["submit", "reject"]
    assert recs[1]["reason"] == "duplicate_rid"
    strict = ServeEngine(cfg, params, strict=True, device="cpu", **ENGINE_KW)
    strict.submit(trace[0])
    with pytest.raises(ValueError, match="duplicate"):
        strict.submit(trace[0])


def test_stuck_error_carries_the_journal_path(served, tmp_path):
    cfg, params, trace, _, _ = served
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    engine = ServeEngine(cfg, params, max_ticks=2, journal=jpath,
                         tracer=Tracer(arch=cfg.name, path=tpath),
                         device="cpu", **ENGINE_KW)
    with pytest.raises(EngineStuckError) as ei:
        engine.run(trace)
    assert ei.value.journal_path == jpath and os.path.exists(jpath)
    assert ei.value.trace_path == tpath and os.path.exists(tpath)
    recs, _, torn = read_journal(jpath)
    assert recs and not torn


def test_snapshot_of_another_geometry_refused(served, tmp_path):
    cfg, params, trace, _, _ = served
    snapdir = str(tmp_path / "snaps")
    ServeEngine(cfg, params, snapshot_dir=snapdir,
                snapshot_every=SNAPSHOT_EVERY, device="cpu",
                **ENGINE_KW).run(trace)
    step = ckpt.latest_step(snapdir)
    wider = ServeEngine(cfg, params, device="cpu",
                        **{**ENGINE_KW, "n_slots": 3})
    with pytest.raises(SnapshotError, match="n_slots"):
        restore_engine_state(wider, snapdir, step)
    paged = ServeEngine(cfg, params, paged=True, page_size=4, device="cpu",
                        **ENGINE_KW)
    with pytest.raises(SnapshotError, match="paged"):
        restore_engine_state(paged, snapdir, step)
    with pytest.raises(ValueError, match="snapshot_dir"):
        ServeEngine(cfg, params, snapshot_every=2, device="cpu", **ENGINE_KW)


def test_serve_cli_journals_snapshots_and_restores(tmp_path, capsys):
    """The CLI's --journal / --snapshot-dir / --snapshot-every run, then
    --restore from what it left: the restored engine resumes with nothing
    left to do and returns the same streams."""
    from repro_torch.launch import serve
    base = ["--arch", "tinyllama-1.1b", "--reduced", "--dbpim-mode", "joint",
            "--device", "cpu", "--requests", "3", "--max-len", "24",
            "--gen-len", "3", "--prompt-len", "2", "9", "--prefill-chunk",
            "4", "--journal", str(tmp_path / "j.jsonl"), "--snapshot-dir",
            str(tmp_path / "snaps")]
    out = serve.main(base + ["--snapshot-every", "2"])
    assert "snapshots:" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path / "snaps")) is not None
    again = serve.main(base + ["--restore"])
    assert again == out
    assert "restored from snapshot step" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(base[:-2] + ["--restore"])
