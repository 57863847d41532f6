"""Engine snapshot / restore: periodic durable state + journal-tail replay.

Port of ``repro.serving.snapshot`` in the reference's format (version 2,
the same manifest ``extra`` and cache leaf keys and shapes), so that the
reference's ``read_snapshot_meta`` reads a port snapshot. Two things
differ because the port's steps are CUDA graphs over fixed addresses:
restore copies the loaded arrays into the fresh engine's cache tensors
where they lie (a new cache would be a new compiled signature), and a
paged pool's spare page (``models.attention.init_paged_cache``) is left
out of the snapshot, so its "pk" / "pv" leaves keep the reference's shape
(L, n_pages, page_size, Hkv, hd).

A snapshot is one atomic checkpoint (checkpoint.checkpoint: tmp dir +
fsync + ``os.replace`` publish, so a kill mid-snapshot leaves the
previous good step untouched) holding BOTH halves of engine state:

  * the DEVICE half — the full slot-cache pytree (KV/SSM state +
    per-slot positions + shared enc_out), saved as the checkpoint tree;
  * the HOST half — manifest ``extra``: per-slot state machine rows,
    the admission queue, outputs so far, skip counts, the slot audit
    log, the full metrics state, and the engine's construction config.

The snapshot also records ``journal_offset`` — the journal's durable
byte offset at save time — which is the seam the two durability layers
compose at: everything at or before the offset is already reflected in
the snapshot; everything after it is the TAIL that restore replays.

Restore (``restore_engine_state``, driven by ``ServeEngine.restore``):

  1. load the latest (or requested) snapshot; copy the cache back into
     the engine's cache tensors;
  2. read the journal tail past ``journal_offset`` and fold it
     (journal.fold_records): post-snapshot submits extend the queue,
     admits move requests into slots, tokens extend outputs, done/shed/
     reject settle terminal states — metrics are re-applied in record
     order so counters stay cumulative across the crash;
  3. rebuild each occupied slot as PREFILLING over its durable record
     ``prompt + all journaled tokens`` with the cursor at the snapshot's
     cache-token count — the fault-recovery replay path. Because chunked
     prefill is bit-identical to sequential decode (``prefill_exact`` on
     the SSM parallel path), finishing that re-prefill emits exactly the NEXT
     token of the stream, bitwise: a killed-and-restored run is
     indistinguishable from an uninterrupted one, token for token.
     Slots admitted after the snapshot have no trusted cache and
     re-prefill from zero (their slices are mask-reset first).

Cadence is the replay-work dial: a slot decodes at most one token per
tick, so the journal-evidenced work a restore re-enters is bounded by
(ticks since last snapshot) per slot — ``snapshot_every * n_slots``
total, the bound the kill-chaos bench guards. The final re-entered
token of each record is NOT redone work (its argmax yields the next NEW
token — the uninterrupted engine spends a decode call on the same
position), which is why ``replayed_prefill_tokens`` counts
``evidenced - cursor``, not record length.

What is deliberately NOT restored: ``first_logits`` (a debugging
convenience for guards, meaningful only within one process's run) and
the per-tick metrics series for ticks between the snapshot and the
crash (the dead process's memory; counters — tokens, calls, faults —
stay exact because token counters are re-applied from the journal,
while the lost ticks' DEVICE-call rows died with the process).
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpoint import (latest_step, load_checkpoint,
                                               save_checkpoint)

#: v2 added the paged-engine fields: ``engine.paged/page_size/n_pages``
#: plus the ``paging`` block (per-slot page ownership + the preempted
#: re-admission deque). v1 snapshots stay restorable: the new fields
#: default to the contiguous engine.
SNAPSHOT_VERSION = 2
_READABLE_VERSIONS = (1, 2)

#: engine construction knobs stored in (and restored from) the manifest
ENGINE_KEYS = ("n_slots", "max_len", "prefill_chunk", "prefill_mode",
               "schedule", "spf_age_cap", "max_ticks", "strict",
               "queue_cap", "max_step_retries", "max_replays",
               "snapshot_every", "snapshot_keep")


class SnapshotError(RuntimeError):
    """Snapshot/engine mismatch or a structurally bad snapshot."""


def _saved(key, leaf):
    """The part of a cache leaf a snapshot holds: a paged pool without its
    spare page, any other leaf whole."""
    return leaf[:, :-1] if key in ("pk", "pv") else leaf


def _host_cache(tree, key=None):
    """The cache as a tree of CPU tensors, in the reference's shapes."""
    if isinstance(tree, dict):
        return {k: _host_cache(v, k) for k, v in tree.items()}
    return _saved(key, tree).detach().to("cpu", copy=True)


def _copy_into(cache, loaded, key=None):
    """Copy a loaded cache tree into ``cache``'s tensors where they lie."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            _copy_into(v, loaded[k], k)
        return
    _saved(key, cache).copy_(loaded)


def _slot_rows(engine) -> List[dict]:
    from repro_torch.serving.engine import SlotState
    rows = []
    for slot in engine.slots:
        if slot.state is SlotState.FREE:
            rows.append({"state": "free"})
            continue
        emitted = engine.outputs.get(slot.rid, [])
        if slot.state is SlotState.DECODING:
            # the cache holds the prompt and every emitted token but the
            # newest (pending_token): the decode that emits token m
            # consumed token m-1, writing position P+m-2
            cache_tokens = len(slot.durable) + len(emitted) - 1
        else:
            cache_tokens = slot.cursor
        rows.append({
            "state": slot.state.value, "rid": int(slot.rid),
            "durable": [int(t) for t in slot.durable],
            "cursor": int(slot.cursor),
            "cache_tokens": int(cache_tokens),
            "gen_len": int(slot.gen_len),
            "pending_token": int(slot.pending_token),
            "deadline": (None if slot.deadline is None
                         else float(slot.deadline)),
            "fault_count": int(slot.fault_count),
            "replay": bool(slot.replay),
            "admit_seq": int(slot.admit_seq),
        })
    return rows


def save_snapshot(engine) -> str:
    """Write one atomic engine snapshot at step = completed tick count.
    Host-side state rides the manifest ``extra``; the cache tree is the
    checkpoint tree. Returns the published step directory."""
    if engine.snapshot_dir is None:
        raise SnapshotError("engine has no snapshot_dir configured")
    extra = {
        "version": SNAPSHOT_VERSION,
        "tick": int(engine.tick_count),
        "journal_offset": (engine.journal.offset
                           if engine.journal is not None else None),
        "engine": {"arch": engine.cfg.name, "paged": bool(engine.paged),
                   **{k: getattr(engine, k) for k in ENGINE_KEYS}},
        "slots": _slot_rows(engine),
        "queue": [{"rid": int(r.rid),
                   "prompt": [int(t) for t in r.prompt],
                   "gen_len": int(r.gen_len),
                   "arrival": float(r.arrival),
                   "deadline": (None if r.deadline is None
                                else float(r.deadline))}
                  for r in engine.queue],
        "skips": {str(k): int(v) for k, v in engine.skips.items()},
        "outputs": {str(k): [int(t) for t in v]
                    for k, v in engine.outputs.items()},
        "rejected": {str(k): v for k, v in engine.rejected.items()},
        "duplicate_rids": [int(r) for r in engine.duplicate_rids],
        "has_deadlines": bool(engine._has_deadlines),
        "slot_log": [[iv.slot, iv.rid, iv.admit_tick, iv.release_tick]
                     for iv in engine.slot_log],
        "metrics": engine.metrics.state_dict(),
    }
    if engine.paged:
        extra["engine"]["page_size"] = int(engine.page_size)
        extra["engine"]["n_pages"] = int(engine.n_pages)
        extra["paging"] = {
            # page ownership at snapshot time: a trusted slot's positions
            # in the pool live in exactly these pages, in position order
            "slot_pages": engine.page_alloc.slot_pages(),
            # the FIFO re-admission deque; the emitted tokens are in
            # ``outputs``, so rid + durable record rebuild each entry
            "preempted": [{"rid": int(p.rid),
                           "durable": [int(t) for t in p.durable],
                           "gen_len": int(p.gen_len),
                           "deadline": (None if p.deadline is None
                                        else float(p.deadline)),
                           "fault_count": int(p.fault_count)}
                          for p in engine.preempted],
        }
    return save_checkpoint(engine.snapshot_dir, engine.tick_count,
                           {"cache": _host_cache(engine.cache)}, extra=extra,
                           keep=engine.snapshot_keep)


def read_snapshot_meta(snapshot_dir: str,
                       step: Optional[int] = None) -> Tuple[int, dict]:
    """Manifest ``extra`` of the latest (or given) snapshot, without
    touching the cache arrays: ServeEngine.restore reads this first to
    construct the replacement engine with matching geometry."""
    if step is None:
        step = latest_step(snapshot_dir)
        if step is None:
            raise FileNotFoundError(f"no snapshots in {snapshot_dir}")
    man = Path(snapshot_dir) / f"step_{step:010d}" / "manifest.json"
    extra = json.loads(man.read_text())["extra"]
    if extra.get("version") not in _READABLE_VERSIONS:
        raise SnapshotError(f"unknown snapshot version "
                            f"{extra.get('version')!r}")
    return step, extra


def _request_from(d: dict):
    from repro_torch.serving.workload import Request
    return Request(rid=int(d["rid"]), prompt=tuple(d["prompt"]),
                   gen_len=int(d["gen_len"]), arrival=float(d["arrival"]),
                   deadline=(None if d.get("deadline") is None
                             else float(d["deadline"])))


def restore_engine_state(engine, snapshot_dir: str, step: int, *,
                         journal_path: Optional[str] = None,
                         journal_fsync: bool = True) -> dict:
    """Rebuild ``engine`` (freshly constructed, idle) from snapshot
    ``step`` plus the journal tail. Returns the restore stats dict (also
    left on ``engine.restore_stats``). See module docstring for the
    replay math."""
    from repro_torch.serving.engine import (SlotInterval, SlotState,
                                            _Preempted, _Slot)
    from repro_torch.serving.journal import (Journal, fold_records,
                                             read_journal)

    # geometry gate before touching cache arrays: a paged<->contiguous
    # mismatch would otherwise die inside load_checkpoint on leaf-key
    # inequality instead of saying what is actually wrong
    step, extra = read_snapshot_meta(snapshot_dir, step)
    eng_meta = extra["engine"]
    if eng_meta["arch"] != engine.cfg.name:
        raise SnapshotError(f"snapshot arch {eng_meta['arch']!r} != "
                            f"engine arch {engine.cfg.name!r}")
    for k in ("n_slots", "max_len", "prefill_chunk", "prefill_mode"):
        if eng_meta[k] != getattr(engine, k):
            raise SnapshotError(
                f"snapshot {k}={eng_meta[k]!r} != engine "
                f"{getattr(engine, k)!r} — restore needs identical "
                f"geometry for the cache layout to be meaningful")
    if bool(eng_meta.get("paged", False)) != engine.paged:
        raise SnapshotError(
            f"snapshot paged={eng_meta.get('paged', False)!r} != engine "
            f"paged={engine.paged!r} — the cache representations are "
            f"not interchangeable")
    if engine.paged:
        for k in ("page_size", "n_pages"):
            if int(eng_meta[k]) != getattr(engine, k):
                raise SnapshotError(
                    f"snapshot {k}={eng_meta[k]!r} != engine "
                    f"{getattr(engine, k)!r} — page ids in the snapshot "
                    f"table index a pool of this exact geometry")
    tree, step, extra = load_checkpoint(snapshot_dir,
                                        {"cache": engine.cache}, step)
    # in place: the compiled steps hold the cache by its addresses
    _copy_into(engine.cache, tree["cache"])

    # -- journal tail (records the snapshot does NOT already reflect) --
    tail: List[dict] = []
    if journal_path is not None and Path(journal_path).exists():
        start = int(extra.get("journal_offset") or 0)
        tail, _, _ = read_journal(journal_path, start=start)
    fold = fold_records(tail)

    # -- queue: snapshot queue + tail submits − tail admits/sheds ------
    queue_reqs = {int(q["rid"]): _request_from(q) for q in extra["queue"]}
    requests_by_rid = dict(queue_reqs)
    for rid, rec in fold["submits"].items():
        req = _request_from(rec)
        queue_reqs[req.rid] = req
        requests_by_rid[req.rid] = req
    for rid in list(queue_reqs):
        if rid in fold["admitted"] or rid in fold["shed"]:
            del queue_reqs[rid]
    engine.queue = deque(sorted(queue_reqs.values(),
                                key=lambda r: (r.arrival, r.rid)))
    # skip counts: snapshot values for still-queued rids (spf picks
    # between snapshot and crash are the dead process's memory — the
    # cap-bound restarts from the snapshot's counts)
    engine.skips = {int(k): int(v) for k, v in extra["skips"].items()
                    if int(k) in queue_reqs}
    for rid in queue_reqs:
        engine.skips.setdefault(rid, 0)

    # -- outputs / terminal maps ---------------------------------------
    outputs = {int(k): [int(t) for t in v]
               for k, v in extra["outputs"].items()}
    for rid, toks in fold["tokens"].items():
        outputs.setdefault(int(rid), []).extend(int(t) for t in toks)
    for rid in fold["admitted"]:
        outputs.setdefault(int(rid), [])
    engine.outputs = outputs
    engine.rejected = {int(k): str(v)
                       for k, v in extra["rejected"].items()}
    engine.duplicate_rids = [int(r) for r in extra["duplicate_rids"]]
    for rid, rec in fold["rejected"].items():
        if rec["reason"] == "duplicate_rid":
            engine.duplicate_rids.append(int(rid))
        else:
            engine.rejected[int(rid)] = rec["reason"]
    engine._has_deadlines = bool(extra["has_deadlines"]) or any(
        r.get("deadline") is not None for r in fold["submits"].values())

    # -- metrics: snapshot state + tail re-applied in record order -----
    engine.metrics.load_state_dict(extra["metrics"])
    m = engine.metrics
    for rec in tail:
        kind, rid, tick = rec["kind"], rec.get("rid"), rec["tick"]
        if kind == "submit":
            m.on_submit(rid, len(rec["prompt"]), rec["gen_len"],
                        rec["arrival"], deadline=rec["deadline"])
        elif kind == "admit":
            m.on_admit(rid, tick, skips=rec.get("skips", 0))
        elif kind == "token":
            if m.requests[rid].first_token_tick is None:
                m.on_first_token(rid, tick)
            m.on_token(rid)
        elif kind == "done":
            m.on_done(rid, tick)
        elif kind == "shed":
            m.on_shed(rid, tick, rec["reason"])
        elif kind == "reject":
            m.on_reject(rid, rec["prompt_len"], rec["gen_len"],
                        rec["arrival"], rec["reason"],
                        deadline=rec["deadline"])
        elif kind == "preempt":
            m.on_preempt(rid, tick)

    # -- slot audit log + live occupancy through the tail --------------
    engine.slot_log = [SlotInterval(slot=int(s), rid=int(r),
                                    admit_tick=int(a),
                                    release_tick=(None if rel is None
                                                  else int(rel)))
                       for s, r, a, rel in extra["slot_log"]]
    engine._open_interval = {iv.slot: iv for iv in engine.slot_log
                             if iv.release_tick is None}
    slot_meta = extra["slots"]
    assign = {s: int(row["rid"]) for s, row in enumerate(slot_meta)
              if row["state"] != "free"}
    for rec in tail:
        if rec["kind"] == "admit":
            s = int(rec["slot"])
            assign[s] = int(rec["rid"])
            iv = SlotInterval(slot=s, rid=int(rec["rid"]),
                              admit_tick=int(rec["tick"]))
            engine.slot_log.append(iv)
            engine._open_interval[s] = iv
        elif rec["kind"] == "preempt":
            s = int(rec["slot"])
            if assign.get(s) == int(rec["rid"]):
                del assign[s]
            iv = engine._open_interval.pop(s, None)
            if iv is not None:
                iv.release_tick = int(rec["tick"]) + 1
        elif rec["kind"] in ("done", "shed"):
            rid = rec.get("rid")
            s = next((s for s, r in assign.items() if r == rid), None)
            if s is not None:
                del assign[s]
                iv = engine._open_interval.pop(s, None)
                if iv is not None:
                    # intervals closed by the dead process are not
                    # re-emitted to the tracer: a same-process tracer
                    # already has them, and duplicates would overlap
                    iv.release_tick = int(rec["tick"]) + 1

    # -- reattach the journal BEFORE rebuilding slots (the torn-tail
    # edge below may need to append) -----------------------------------
    if journal_path is not None:
        engine.journal = Journal(journal_path, resume=True,
                                 fsync=journal_fsync)

    # -- rebuild occupied slots on the fault-recovery replay path -------
    # admission age must survive restore in paged mode: page pressure
    # preempts YOUNGEST-first, so a restored engine that forgot who is
    # older would evict different victims than the uninterrupted one
    seq_base = max((int(r.get("admit_seq", -1)) for r in slot_meta
                    if r["state"] != "free"), default=-1) + 1
    tail_admit_order = {}
    for i, rec in enumerate(tail):
        if rec["kind"] == "admit":
            tail_admit_order[int(rec["rid"])] = i
    snap_pages = (extra.get("paging", {}).get("slot_pages")
                  if engine.paged else None)
    snap_rows_by_rid = {int(r["rid"]): r for r in slot_meta
                        if r["state"] != "free"}
    snap_pre = (extra.get("paging", {}).get("preempted") or [])
    snap_pre_by_rid = {int(r["rid"]): r for r in snap_pre}
    pages_by_slot = [[] for _ in range(engine.n_slots)]
    reset_mask = np.zeros((engine.n_slots,), bool)
    replayed = fresh = restored = 0
    max_seq = seq_base - 1
    for s in range(engine.n_slots):
        rid = assign.get(s)
        if rid is None:
            engine.slots[s] = _Slot()
            continue
        row = slot_meta[s]
        if row["state"] != "free" and int(row["rid"]) == rid \
                and rid not in fold["admitted"]:
            # same occupant since the snapshot, never preempted in the
            # tail (a tail re-admit means its snapshot pages were
            # surrendered — the saved cache slice is stale)
            durable = np.asarray(row["durable"], np.int32)
            gen_len = int(row["gen_len"])
            deadline = row["deadline"]
            fault_count = int(row["fault_count"])
            cursor = int(row["cache_tokens"])
            admit_seq = int(row.get("admit_seq", s))
            if snap_pages is not None:
                # the snapshot cache's positions 0..cursor-1 live in
                # exactly these pool pages, in position order
                pages_by_slot[s] = [int(p) for p in snap_pages[s]]
        else:                              # admitted after the snapshot:
            prow = snap_rows_by_rid.get(rid) or snap_pre_by_rid.get(rid)
            if prow is not None:
                # preempted (pre- or post-snapshot), re-admitted in the
                # tail: the durable record rides the snapshot rows, not
                # the queue
                durable = np.asarray(prow["durable"], np.int32)
                gen_len = int(prow["gen_len"])
                deadline = prow["deadline"]
                fault_count = int(prow.get("fault_count", 0))
            else:                          # no trusted cache, start over
                req = requests_by_rid[rid]
                durable = np.asarray(req.prompt, np.int32)
                gen_len, deadline = req.gen_len, req.deadline
                fault_count = 0
            cursor = 0
            # pages re-grow on demand at the next tick's _page_growth
            admit_seq = seq_base + tail_admit_order.get(rid, 0)
        max_seq = max(max_seq, admit_seq)
        emitted = outputs.get(rid, [])
        if len(emitted) >= gen_len:
            # every token was journaled but the done record was lost in
            # the torn tail: settle the request instead of re-prefilling
            end_tick = max(fold["last_tick"], int(extra["tick"]))
            m.on_done(rid, end_tick)
            if engine.journal is not None:
                engine.journal.append("done", end_tick, rid=rid)
            iv = engine._open_interval.pop(s, None)
            if iv is not None:
                iv.release_tick = end_tick + 1
            engine.slots[s] = _Slot()
            pages_by_slot[s] = []          # settled: pages back to free
            continue
        record = (np.concatenate([durable,
                                  np.asarray(emitted, np.int32)])
                  if emitted else durable)
        if cursor == 0:
            reset_mask[s] = True
            fresh += len(record)
        elif emitted:
            # journal-evidenced progress the dead engine had already
            # made past the snapshot cache: re-entering it is the redone
            # work snapshot cadence bounds. The final record token is
            # excluded — its argmax produces the next NEW token, work
            # the uninterrupted engine does too.
            evidenced = len(durable) + len(emitted) - 1
            replayed += max(0, evidenced - cursor)
        engine.slots[s] = _Slot(
            state=SlotState.PREFILLING, rid=rid, prompt=record,
            durable=durable, cursor=cursor, gen_len=gen_len,
            deadline=deadline, fault_count=fault_count,
            replay=bool(emitted), restore=True, admit_seq=admit_seq)
        restored += 1
    if engine.paged:
        engine.page_alloc.load_slot_pages(pages_by_slot)
        engine._admit_seq = max_seq + 1
        # re-admission deque: snapshot entries still waiting (their tail
        # admit/terminal clears them), then tail preempts in record
        # order — FIFO age survives the crash
        terminal = set(fold["done"]) | set(fold["shed"])
        pre = []
        for prow in snap_pre:
            rid = int(prow["rid"])
            if rid in fold["admitted"] or rid in terminal:
                continue
            pre.append(prow)
        for rid in fold["preempted"]:
            rid = int(rid)
            if rid in terminal:
                continue
            prow = snap_rows_by_rid.get(rid) or snap_pre_by_rid.get(rid)
            if prow is None:               # submitted after the snapshot
                req = requests_by_rid[rid]
                prow = {"rid": rid, "durable": list(req.prompt),
                        "gen_len": req.gen_len, "deadline": req.deadline,
                        "fault_count": 0}
            pre.append(prow)
        engine.preempted = deque(
            _Preempted(rid=int(p["rid"]),
                       durable=np.asarray(p["durable"], np.int32),
                       gen_len=int(p["gen_len"]),
                       deadline=(None if p.get("deadline") is None
                                 else float(p["deadline"])),
                       fault_count=int(p.get("fault_count", 0)))
            for p in pre)
        for p in engine.preempted:
            engine.outputs.setdefault(p.rid, [])
        engine.page_alloc.check()
    if reset_mask.any():
        engine.cache = engine._reset_call(reset_mask)

    engine.tick_count = max(int(extra["tick"]), fold["last_tick"] + 1)
    stats = {"from_step": int(step),
             "resume_tick": int(engine.tick_count),
             "slots_restored": int(restored),
             "replayed_prefill_tokens": int(replayed),
             "fresh_prefill_tokens": int(fresh),
             "journal_tail_records": len(tail)}
    engine.restore_stats = stats
    if engine.tracer is not None:
        engine.tracer.event("restore", engine.tick_count, **stats)
    return stats
