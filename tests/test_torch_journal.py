"""The port's write-ahead journal, held against the JAX package's:
``frame`` gives the same bytes for every record kind, each package's
``read_journal`` reads the other's files, recovery trusts the prefix up to
a flipped bit and truncates a torn tail on resume, and ``fold_records``
folds seeded record sequences as the reference's does."""

import numpy as np
import pytest
import torch

from repro.serving import journal as jax_journal
from repro_torch.serving import journal

pytestmark = pytest.mark.port

#: one record of each kind, with the fields the engine journals
KIND_RECORDS = [
    {"kind": "submit", "tick": 0, "rid": 1, "prompt": [3, 1, 4],
     "gen_len": 4, "arrival": 0.0, "deadline": None},
    {"kind": "submit", "tick": 2, "rid": 9, "prompt": [5], "gen_len": 2,
     "arrival": 1.5, "deadline": 12.0},
    {"kind": "admit", "tick": 1, "rid": 1, "slot": 0, "skips": 2},
    {"kind": "token", "tick": 2, "rid": 1, "token": 7},
    {"kind": "done", "tick": 4, "rid": 1},
    {"kind": "shed", "tick": 6, "rid": 3, "reason": "fault_budget"},
    {"kind": "reject", "tick": 0, "rid": 4, "reason": "oversized",
     "prompt_len": 30, "gen_len": 8, "arrival": 0.0, "deadline": None},
    {"kind": "preempt", "tick": 7, "rid": 2, "slot": 1},
]


def _records(seed, n=60):
    """A seeded sequence of plausible engine records: submits, then
    admits, tokens, preemptions and terminal records in tick order."""
    rng = np.random.default_rng(seed)
    recs, tick = [], 0
    waiting, running, next_rid = [], {}, 0
    for _ in range(n):
        tick += int(rng.integers(0, 2))
        op = rng.random()
        if op < 0.25 or not (waiting or running):
            recs.append({"kind": "submit", "tick": tick, "rid": next_rid,
                         "prompt": [int(t) for t in
                                    rng.integers(1, 50, rng.integers(1, 6))],
                         "gen_len": int(rng.integers(1, 6)),
                         "arrival": float(tick), "deadline": None})
            waiting.append(next_rid)
            next_rid += 1
        elif op < 0.4 and waiting:
            rid = waiting.pop(0)
            slot = int(rng.integers(0, 3))
            running[rid] = slot
            recs.append({"kind": "admit", "tick": tick, "rid": rid,
                         "slot": slot, "skips": int(rng.integers(0, 3))})
        elif op < 0.75 and running:
            rid = list(running)[int(rng.integers(0, len(running)))]
            recs.append({"kind": "token", "tick": tick, "rid": rid,
                         "token": int(rng.integers(0, 100))})
        elif op < 0.85 and running:
            rid = list(running)[0]
            recs.append({"kind": "preempt", "tick": tick, "rid": rid,
                         "slot": running.pop(rid)})
            waiting.insert(0, rid)
        elif running:
            rid = list(running)[-1]
            running.pop(rid)
            kind = "done" if op < 0.95 else "shed"
            rec = {"kind": kind, "tick": tick, "rid": rid}
            if kind == "shed":
                rec["reason"] = "deadline"
            recs.append(rec)
        else:
            rid = waiting.pop()
            recs.append({"kind": "reject", "tick": tick, "rid": rid + 1000,
                         "reason": "queue_full", "prompt_len": 3,
                         "gen_len": 2, "arrival": float(tick),
                         "deadline": None})
    return recs


def _write(mod, path, records):
    j = mod.Journal(str(path))
    for r in records:
        j.append(r["kind"], r["tick"], **{k: v for k, v in r.items()
                                          if k not in ("kind", "tick")})
    j.close()
    return j.offset


@pytest.mark.parametrize("rec", KIND_RECORDS,
                         ids=[f"{r['kind']}{i}" for i, r in
                              enumerate(KIND_RECORDS)])
def test_frame_bytes_equal_the_reference(rec):
    assert journal.frame(rec) == jax_journal.frame(rec)


@pytest.mark.parametrize("writer,reader", [(journal, jax_journal),
                                           (jax_journal, journal)],
                         ids=["port_to_jax", "jax_to_port"])
def test_each_package_reads_the_others_journal(tmp_path, writer, reader):
    recs = KIND_RECORDS + _records(3)
    p = tmp_path / "j.jsonl"
    end = _write(writer, p, recs)
    got, off, torn = reader.read_journal(str(p))
    assert got == recs and off == end == p.stat().st_size and not torn
    other = tmp_path / "k.jsonl"
    _write(reader, other, recs)
    assert other.read_bytes() == p.read_bytes()


def test_prefix_trust_on_a_flipped_bit(tmp_path):
    """A flipped bit in the second frame hides it and everything after it,
    in both packages alike."""
    p = tmp_path / "j.jsonl"
    _write(journal, p, KIND_RECORDS)
    raw = bytearray(p.read_bytes())
    at = raw.index(b"\n") + 1 + 15
    raw[at] ^= 0x01
    p.write_bytes(bytes(raw))
    got = journal.read_journal(str(p))
    assert got == jax_journal.read_journal(str(p))
    recs, off, torn = got
    assert recs == KIND_RECORDS[:1] and torn
    assert off == raw.index(b"\n") + 1


def test_torn_tail_truncated_on_resume(tmp_path):
    p = tmp_path / "j.jsonl"
    _write(journal, p, KIND_RECORDS)
    good = p.stat().st_size
    with open(p, "ab") as f:                    # half a frame: a torn write
        f.write(journal.frame({"kind": "token", "tick": 9, "rid": 1,
                               "token": 2})[:-9])
    assert journal.read_journal(str(p)) == (KIND_RECORDS, good, True)
    j = journal.Journal(str(p), resume=True)
    assert j.records_recovered == len(KIND_RECORDS)
    assert p.stat().st_size == good and j.offset == good
    j.append("token", 9, rid=1, token=2)
    assert j.pending == 1 and j.commit() == 1 and j.commit() == 0
    j.close()
    recs, _, torn = jax_journal.read_journal(str(p))
    assert not torn
    assert recs[-1] == {"kind": "token", "tick": 9, "rid": 1, "token": 2}


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_fold_records_equals_the_reference(seed):
    recs = _records(seed)
    assert journal.fold_records(recs) == jax_journal.fold_records(recs)
    for cut in (0, len(recs) // 3, len(recs) // 2):
        tail = recs[cut:]
        assert journal.fold_records(tail) == jax_journal.fold_records(tail)


@pytest.mark.parametrize("bad", [np.int64(3), torch.tensor(3), np.float32(1),
                                 [1, np.int32(2)]],
                         ids=["numpy_int", "tensor", "numpy_float", "list"])
def test_append_refuses_values_that_are_not_plain_python(tmp_path, bad):
    j = journal.Journal(str(tmp_path / "j.jsonl"))
    with pytest.raises(journal.JournalError, match="plain Python"):
        j.append("token", 0, rid=1, token=bad)
    with pytest.raises(journal.JournalError, match="not in"):
        j.append("crash", 0)
    j.close()
