"""Deterministic fault injection for the serving engine.

Port of ``repro.serving.faults``. The engine's fault contract
(serving.engine) is: **the blast radius of any single fault is at most
one tick, and recovery is bitwise-verifiable**. This module is the
harness that holds the engine to it: a seeded :class:`FaultPlan`
schedules adverse events at exact engine ticks, so a faulted run and a
fault-free run of the SAME trace can be compared token for token. Same
seed + same parameters => the same schedule, event for event, as the
reference's; the plan is stateless at inject time (the engine passes the
attempt number in), so one plan can drive many runs.

Four fault kinds:

  * ``step_exception`` — the device call raises. Injected BEFORE dispatch,
    so the engine's bounded retry re-issues the call against intact
    buffers; an event with ``repeat > max_step_retries`` models a
    persistent failure and quarantines every slot of the call.
  * ``nan_logits`` — one slot's logits come back non-finite. Injected on
    the host after the call; the engine's finite guard must fail ONLY
    that slot.
  * ``cache_corruption`` — one slot's KV/SSM cache slices are poisoned
    with NaN at the start of a tick. There is no direct detector: the
    poison surfaces as non-finite logits at the next device call that
    reads it (detection by propagation).
  * ``engine_crash`` — the whole process dies between ticks
    (:class:`EngineCrash`). Never sampled by :meth:`FaultPlan.generate`
    (see ``INJECTABLE_KINDS``); restarting from it is the durability
    slice's work.

``corrupt_cache`` poisons the cache IN PLACE, where the engine's compiled
steps read it: on the card each step is a CUDA graph over fixed
addresses, so a poisoned copy would be a tree no graph ever reads. The
slices it writes are the reference's (``merge_slots``' per-slot select):
every floating leaf's slot rows, batch on axis 1, as
``models.decode.reset_slots_`` walks them; ``pos``, integer leaves and the
shared ``enc_out`` stay intact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

#: kinds the engine absorbs in place (retry / quarantine / replay) — the
#: only kinds FaultPlan.generate samples
INJECTABLE_KINDS = ("step_exception", "nan_logits", "cache_corruption")
#: all valid event kinds; "engine_crash" kills the process between ticks
FAULT_KINDS = INJECTABLE_KINDS + ("engine_crash",)
#: which engine device call an event may target
FAULT_CALLS = ("decode", "prefill", "any")


class InjectedFault(RuntimeError):
    """Raised by FaultPlan.check_step in place of a device-call failure."""


class EngineCrash(RuntimeError):
    """Simulated whole-process kill (fault kind "engine_crash"), raised by
    the engine between ticks. The engine object is not usable afterwards."""

    def __init__(self, msg: str, *, tick: int):
        super().__init__(msg)
        self.tick = tick


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``tick`` is the engine tick it fires on. ``call`` scopes
    step_exception / nan_logits events to a device-call kind ("decode",
    "prefill", or "any"); cache_corruption ignores it. ``slot`` targets
    nan_logits / cache_corruption; an event aimed at a slot that is idle
    that tick is a no-op (the plan never peeks at the engine). ``repeat``
    is how many consecutive attempts of the same tick's call a
    step_exception fails: 1 is a transient blip one retry absorbs, more
    than the engine's ``max_step_retries`` a persistent outage.
    ``engine_crash`` events use only ``tick``."""
    tick: int
    kind: str
    call: str = "any"
    slot: int = 0
    repeat: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind {self.kind!r} not in {FAULT_KINDS}")
        if self.call not in FAULT_CALLS:
            raise ValueError(f"call {self.call!r} not in {FAULT_CALLS}")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule. Build one from events, or sample
    one with :meth:`generate`. ``FaultPlan.none()`` is the no-overhead
    control: an engine driven with it gives exactly the outputs, device
    calls and kernel launches of an engine with no plan."""
    events: Tuple[FaultEvent, ...] = ()

    @classmethod
    def none(cls) -> "FaultPlan":
        return cls(events=())

    @classmethod
    def generate(cls, seed: int, n_ticks: int, rate: float, n_slots: int,
                 kinds: Tuple[str, ...] = INJECTABLE_KINDS) -> "FaultPlan":
        """Sample a schedule: each tick independently hosts one fault with
        probability ``rate``, uniform over ``kinds``, slots, and the two
        call kinds. The reference's sampler draw for draw, so the same
        arguments give the reference's plan."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for tick in range(n_ticks):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            call = ("decode", "prefill")[int(rng.integers(2))]
            slot = int(rng.integers(n_slots))
            events.append(FaultEvent(tick=tick, kind=kind, call=call,
                                     slot=slot))
        return cls(events=tuple(events))

    # ------------------------------------------------------------ queries

    def _at(self, tick: int, kind: str) -> List[FaultEvent]:
        return [e for e in self.events if e.tick == tick and e.kind == kind]

    def check_step(self, tick: int, call: str, attempt: int):
        """Raise InjectedFault if a step_exception event targets this
        tick's ``call`` and has failures left for this ``attempt``
        (0-based)."""
        for e in self._at(tick, "step_exception"):
            if e.call in ("any", call) and attempt < e.repeat:
                raise InjectedFault(
                    f"injected step fault: tick={tick} call={call} "
                    f"attempt={attempt}/{e.repeat}")

    def logit_slots(self, tick: int, call: str) -> List[int]:
        """Slots whose logits this tick's ``call`` should NaN-poison."""
        return [e.slot for e in self._at(tick, "nan_logits")
                if e.call in ("any", call)]

    def cache_slots(self, tick: int) -> List[int]:
        """Slots whose cache slices to poison at the start of ``tick``."""
        return [e.slot for e in self._at(tick, "cache_corruption")]

    def crash_at(self, tick: int) -> bool:
        """True if the process should die after completing ``tick``."""
        return bool(self._at(tick, "engine_crash"))


def corrupt_logits(logits: np.ndarray, slots: List[int]) -> np.ndarray:
    """NaN-poison the given batch rows of a host-side logits array."""
    out = np.array(logits, copy=True)
    for s in slots:
        out[s] = np.nan
    return out


def corrupt_cache(cache, slots: List[int], n_slots: int):
    """NaN-poison, in place, every floating cache leaf's slices for
    ``slots`` (batch on axis 1); ``pos``, integer leaves and ``enc_out``
    are left as they are. Returns ``cache``.

    A paged pool ("pk" / "pv") has no batch axis, and the reference's
    ``merge_slots`` passes the poisoned pool through whole: every page is
    poisoned, as there (the spare page past the reference's pool, which no
    step reads, is left as it is)."""
    mask = torch.zeros((n_slots,), dtype=torch.bool)
    mask[list(slots)] = True

    def visit(key, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(k, v)
        elif key in ("pk", "pv"):
            tree[:, :-1].fill_(float("nan"))
        elif key not in ("enc_out", "pos") and tree.is_floating_point():
            shape = [1] * tree.ndim
            shape[1] = n_slots
            tree.masked_fill_(mask.to(tree.device).reshape(shape),
                              float("nan"))

    visit(None, cache)
    return cache
