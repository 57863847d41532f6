"""Write-ahead request journal: append-only, CRC-framed JSONL.

Port of ``repro.serving.journal``, byte for byte in its frames: the same
canonical JSON, the same CRC, the same prefix trust, so each package reads
the other's journals. Every field is a plain Python ``int``, ``float``,
``str``, list or None before framing (``append`` checks it): a torch or
numpy scalar never reaches ``json.dumps``.

The engine's durable record (``_Slot.durable`` + ``engine.outputs``) lives
in memory, so a process crash would lose every in-flight and queued
request. The journal makes that record durable: every request-visible
transition is appended as one CRC-framed JSON line and the whole tick's
batch is fsync'd ONCE at tick end — a crash can lose at most the
not-yet-committed tail of the current tick, and everything it loses is
re-derived bitwise on restart (argmax decoding is deterministic, and
chunked prefill == sequential decode).

Frame format — one record per line::

    <crc32 hex, 8 chars> <canonical JSON payload>\\n

The CRC is over the payload bytes. Recovery (`read_journal`) stops at
the FIRST bad frame — torn tail, flipped bit, truncated line — and
reports the byte offset of the last good frame, which `Journal(path,
resume=True)` truncates the file to before appending. Prefix semantics
are deliberate: a record is only trusted if every record before it is
intact, so replay state can never be built from a gap.

Record kinds (``kind`` field; every record carries ``tick``):

  ==========  ==========================================================
  kind        fields
  ==========  ==========================================================
  submit      rid, prompt (token list), gen_len, arrival, deadline
  admit       rid, slot, skips — also a PREEMPTED request re-entering a
              slot (its tokens so far are the token records; the replay
              record is prompt + tokens)
  token       rid, token — one generated token, in emission order
  done        rid — the request completed its stream
  shed        rid, reason — dropped after acceptance (deadline,
              fault_budget)
  reject      rid, reason, prompt_len, gen_len, arrival, deadline —
              refused at submit (oversized, queue_full, duplicate_rid)
  preempt     rid, slot — evicted under page pressure (paged engine);
              the slot's pages were surrendered and the request waits
              for re-admission with its emitted tokens intact
  ==========  ==========================================================

Journaling is PASSIVE: with ``journal=None`` (the engine default) the
outputs and device-call count are bitwise/count-identical — the journal
only ever observes host-side decisions, exactly like the tracer.

Restore folds the journal tail (records past the snapshot's committed
offset) over the snapshot state: `fold_records` returns the net effect
— who was admitted where, every token emitted, who finished/was shed —
and serving.snapshot applies it to a fresh engine.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional, Tuple

RECORD_KINDS = ("submit", "admit", "token", "done", "shed", "reject",
                "preempt")


class JournalError(RuntimeError):
    """A structural problem with a journal file or record."""


def _check_plain(name: str, val):
    """A record field is None, a bool, int, float or str, or a list of
    them: a tensor or numpy scalar would frame differently, or not at
    all."""
    if isinstance(val, list):
        for v in val:
            _check_plain(name, v)
    elif val is not None and type(val) not in (bool, int, float, str):
        raise JournalError(f"journal field {name!r} is a "
                           f"{type(val).__name__}, not a plain Python value")


def frame(record: dict) -> bytes:
    """One CRC-framed line for ``record`` (canonical JSON, sorted keys,
    so the same record always frames to the same bytes)."""
    payload = json.dumps(record, sort_keys=True,
                         separators=(",", ":")).encode()
    if b"\n" in payload:
        raise JournalError("journal payload contains a newline")
    return b"%08x " % (zlib.crc32(payload) & 0xFFFFFFFF) + payload + b"\n"


def _parse_frame(line: bytes) -> Optional[dict]:
    """Decode one framed line; None if the frame is bad in any way."""
    sp = line.find(b" ")
    if sp != 8:
        return None
    try:
        crc = int(line[:sp], 16)
    except ValueError:
        return None
    payload = line[sp + 1:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        return None
    try:
        rec = json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def read_journal(path: str, start: int = 0
                 ) -> Tuple[List[dict], int, bool]:
    """Read committed records from byte offset ``start``.

    Returns ``(records, end_offset, torn)``: every record up to the
    first bad frame, the ABSOLUTE byte offset just past the last good
    frame, and whether anything (a torn tail, a corrupt frame) was left
    unread. Truncating the file to ``end_offset`` recovers a clean
    journal."""
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read()
    records: List[dict] = []
    pos = 0
    while True:
        nl = buf.find(b"\n", pos)
        if nl < 0:                         # partial final frame (or EOF)
            break
        rec = _parse_frame(buf[pos:nl])
        if rec is None:                    # first bad frame: stop trusting
            break
        records.append(rec)
        pos = nl + 1
    return records, start + pos, pos < len(buf)


class Journal:
    """Append-only write-ahead log with one fsync per commit.

    ``append`` buffers records host-side; ``commit`` writes the whole
    batch in one syscall, flushes, and fsyncs — the engine calls it once
    per tick, so durability costs one fsync per tick regardless of how
    many requests moved. ``offset`` is the number of DURABLE bytes
    (snapshots record it so restore knows exactly which records the
    snapshot already reflects).

    ``resume=True`` recovers an existing file: the torn tail (if any) is
    truncated at the first bad frame and appending continues from the
    last good record — the restart path. The default (``resume=False``)
    starts a fresh journal, truncating whatever was there."""

    def __init__(self, path: str, *, resume: bool = False,
                 fsync: bool = True):
        self.path = str(path)
        self.fsync = fsync
        self._pending: List[dict] = []
        self.records_recovered = 0
        if resume and os.path.exists(self.path):
            recs, end, torn = read_journal(self.path)
            if torn:
                with open(self.path, "r+b") as f:
                    f.truncate(end)
            self.records_recovered = len(recs)
            self._offset = end
        else:
            open(self.path, "wb").close()
            self._offset = 0
        self._fh = open(self.path, "ab")

    @property
    def offset(self) -> int:
        """Byte offset of the last COMMITTED (durable) frame."""
        return self._offset

    @property
    def pending(self) -> int:
        return len(self._pending)

    def append(self, kind: str, tick: int, **fields):
        """Buffer one record; durable only after the next commit(). Every
        field must be a plain Python value (JournalError otherwise)."""
        if kind not in RECORD_KINDS:
            raise JournalError(f"kind {kind!r} not in {RECORD_KINDS}")
        for name, val in fields.items():
            _check_plain(name, val)
        self._pending.append({"kind": kind, "tick": int(tick), **fields})

    def commit(self) -> int:
        """Write + fsync every buffered record in one batch; returns the
        number of records made durable (0 = nothing buffered, no I/O)."""
        if not self._pending:
            return 0
        buf = b"".join(frame(r) for r in self._pending)
        n = len(self._pending)
        self._pending.clear()
        self._fh.write(buf)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._offset += len(buf)
        return n

    def close(self):
        self.commit()
        self._fh.close()


def fold_records(records: List[dict]) -> dict:
    """Fold a journal tail into its net effect on engine state.

    Returns a dict the restore path (serving.snapshot) applies on top of
    the snapshot:

      * ``submits``    — rid -> submit record (requests that entered the
        queue after the snapshot);
      * ``admits``     — slot -> the LAST admit record placed there
        (earlier occupants must have terminated; their terminal records
        are also in the tail);
      * ``admitted``   — rid -> admit record, every admission in order;
      * ``tokens``     — rid -> [token, ...] emitted after the snapshot,
        with ``token_ticks`` carrying each token's tick (first-token
        metrics);
      * ``done`` / ``shed`` / ``rejected`` — terminal outcomes
        (rid -> record);
      * ``preempted``  — rid -> the LAST preempt record for requests
        still waiting for re-admission at the tail's end (a later admit
        clears the entry; insertion order == re-admission order). Their
        slot's ``admits`` entry is cleared too — a preempted slot holds
        nothing;
      * ``last_tick``  — highest tick any record carries (-1 if empty):
        the restored engine resumes at ``last_tick + 1``.
    """
    out = {"submits": {}, "admits": {}, "admitted": {}, "tokens": {},
           "token_ticks": {}, "done": {}, "shed": {}, "rejected": {},
           "preempted": {}, "last_tick": -1}
    for rec in records:
        kind = rec["kind"]
        out["last_tick"] = max(out["last_tick"], rec["tick"])
        rid = rec.get("rid")
        if kind == "submit":
            out["submits"][rid] = rec
        elif kind == "admit":
            out["admits"][rec["slot"]] = rec
            out["admitted"][rid] = rec
            out["preempted"].pop(rid, None)   # re-admitted
        elif kind == "preempt":
            out["preempted"][rid] = rec
            cur = out["admits"].get(rec["slot"])
            if cur is not None and cur.get("rid") == rid:
                del out["admits"][rec["slot"]]
        elif kind == "token":
            out["tokens"].setdefault(rid, []).append(rec["token"])
            out["token_ticks"].setdefault(rid, []).append(rec["tick"])
        elif kind == "done":
            out["done"][rid] = rec
        elif kind == "shed":
            out["shed"][rid] = rec
        elif kind == "reject":
            out["rejected"][rid] = rec
    return out
