"""Deterministic fault injection and the structured failure types of the
serving engine (the port's own copy of ``repro.runtime.faults``, numpy
only).

A serving engine must degrade per request, not per process: a non-finite
logit in one decode row (FP8 E4M3's NaN code point and saturation are the
format's operational sharp edge), a bit-rotted host spill, or a transient
allocator stall costs exactly the affected request. This module holds the
two halves of testing that:

  * ``FaultPlan``: a seeded, deterministic fault schedule the Server
    consults through hook points that do nothing by default. It poisons
    the logits of a chosen (engine step, slot) with NaN inside the step
    (upstream of the engine's own isfinite check, so detection runs the
    real path), corrupts or drops a host spill payload byte-exactly
    (caught by the spill CRC at resume), and blanks the page allocator
    for chosen engine ticks. Every injection is recorded, so a test can
    assert that exactly the injected requests failed.
  * ``ServingError``: the drain-level failure (starvation, max_steps)
    carrying the requests that did finish plus per-request diagnostics
    for everything still pending.
  * ``PoolCorruptionError``: raised by ``Server.audit()`` when a pool
    ownership invariant breaks, with the violation list and a state dump.

No module here imports ``serve``: the dependency points one way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["FaultPlan", "PoolCorruptionError", "ServingError"]


class ServingError(RuntimeError):
    """Drain-level failure (starvation or max_steps exhaustion) that does
    not discard completed work: ``finished`` holds the requests retired
    during the failing ``run_until_drained`` call, ``pending`` one
    diagnostic dict per request still queued / spilled / active (rid,
    state, wait-line age, context length, pages needed...)."""

    def __init__(self, message: str, finished: Sequence = (),
                 pending: Sequence[Dict] = ()):
        super().__init__(message)
        self.finished = list(finished)
        self.pending = list(pending)


class PoolCorruptionError(RuntimeError):
    """A pool ownership invariant broke (refcount != table occupancy,
    leaked / double-owned page or slab, frozen page in a write set...).
    ``violations`` lists every broken invariant, ``dump`` is a host-side
    snapshot of the accounting state for post-mortem."""

    def __init__(self, violations: Sequence[str], dump: Dict = None):
        head = "; ".join(list(violations)[:4])
        more = len(violations) - min(len(violations), 4)
        super().__init__(
            f"pool corruption: {len(violations)} invariant violation(s): "
            f"{head}{f'; ... +{more} more' if more > 0 else ''}")
        self.violations = list(violations)
        self.dump = dict(dump or {})


@dataclasses.dataclass
class FaultPlan:
    """A deterministic fault schedule. All hooks are no-ops unless the
    matching schedule field names the current step / tick / spill.

    Schedule (what to inject):
      * ``nan_logits`` — (engine step, slot) pairs whose decode logits
        are poisoned to NaN inside the step (keyed on ``Server._step_no``,
        the decode-step counter: the poison is a bool input of the step,
        upstream of its isfinite check).
      * ``corrupt_spills`` / ``drop_spills`` — spill *ordinals* (0 = the
        first preemption this server performs) whose host payload gets
        one byte flipped / is replaced with zeros. Caught by the spill
        CRC at resume -> tail re-prefill, the request still finishes.
      * ``alloc_fail_ticks`` — engine *ticks* (``Server._tick``, which
        advances every ``step()`` call even when no row decodes) on
        which the page allocator reports zero capacity. Tick-keyed so a
        blocked tick always passes: the exhaustion is transient by
        construction.

    Record (what actually landed — chaos tests assert against these):
      * ``nan_hits`` — (step, slot, rid) per poisoned row that held a
        live request (a poison aimed at an empty slot lands on nothing).
      * ``corrupted_rids`` / ``dropped_rids`` — rids whose spill payload
        was tampered with.
      * ``blocked_ticks`` — ticks on which the allocator was blanked.
    """

    seed: int = 0
    nan_logits: Tuple[Tuple[int, int], ...] = ()
    corrupt_spills: Tuple[int, ...] = ()
    drop_spills: Tuple[int, ...] = ()
    alloc_fail_ticks: Tuple[int, ...] = ()
    nan_hits: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    corrupted_rids: List[int] = dataclasses.field(default_factory=list)
    dropped_rids: List[int] = dataclasses.field(default_factory=list)
    blocked_ticks: List[int] = dataclasses.field(default_factory=list)
    _spill_no: int = dataclasses.field(default=0, repr=False)

    @classmethod
    def seeded(cls, seed: int, *, slots: int, max_step: int,
               n_nan: int = 1, n_corrupt: int = 1, n_drop: int = 0,
               n_alloc: int = 1, first_step: int = 2) -> "FaultPlan":
        """Draw a random-but-reproducible schedule: ``n_nan`` poisoned
        (step, slot) pairs in [first_step, max_step), the first
        ``n_corrupt`` spills corrupted and the next ``n_drop`` dropped,
        ``n_alloc`` blanked allocator ticks."""
        rng = np.random.default_rng(seed)
        lo, hi = first_step, max(first_step + 1, max_step)
        nan = tuple(sorted(
            (int(st), int(rng.integers(slots)))
            for st in rng.choice(np.arange(lo, hi),
                                 size=min(n_nan, hi - lo), replace=False)))
        alloc = tuple(sorted(
            int(t) for t in rng.choice(np.arange(lo, hi),
                                       size=min(n_alloc, hi - lo),
                                       replace=False)))
        return cls(seed=seed, nan_logits=nan,
                   corrupt_spills=tuple(range(n_corrupt)),
                   drop_spills=tuple(range(n_corrupt, n_corrupt + n_drop)),
                   alloc_fail_ticks=alloc)

    # -- hooks (called by Server; every one is a no-op off-schedule) -------
    def poison_rows(self, step: int, n_slots: int) -> np.ndarray:
        """Bool mask (n_slots,) of rows whose logits this decode step
        poisons to NaN (an input of the engine step)."""
        mask = np.zeros((n_slots,), bool)
        for st, sl in self.nan_logits:
            if st == step and 0 <= sl < n_slots:
                mask[sl] = True
        return mask

    def note_nan(self, step: int, slot: int, rid: int):
        self.nan_hits.append((step, slot, rid))

    def alloc_blocked(self, tick: int) -> bool:
        """True on ticks the page allocator must report zero capacity."""
        if tick in self.alloc_fail_ticks:
            self.blocked_ticks.append(tick)
            return True
        return False

    def spill_payload(self, rid: int,
                      payload: List[Dict[str, np.ndarray]]):
        """Tamper with a spill payload on its way to host residency (the
        spill's CRC was computed on the pristine bytes first — this
        models bit rot *while spilled*, which the resume-time verify
        must catch). Returns the (possibly tampered) payload."""
        ordinal = self._spill_no
        self._spill_no += 1
        if ordinal in self.drop_spills:
            self.dropped_rids.append(rid)
            return [{name: np.zeros_like(arr) for name, arr in part.items()}
                    for part in payload]
        if ordinal in self.corrupt_spills:
            rng = np.random.default_rng((self.seed, ordinal))
            leaves = [(pi, name) for pi, part in enumerate(payload)
                      for name in sorted(part) if part[name].size]
            if leaves:
                pi, name = leaves[int(rng.integers(len(leaves)))]
                payload = [dict(part) for part in payload]
                arr = np.array(payload[pi][name])  # host copy, contiguous
                flat = arr.view(np.uint8).reshape(-1)
                flat[int(rng.integers(flat.size))] ^= 0xFF
                payload[pi][name] = arr
                self.corrupted_rids.append(rid)
        return payload
