"""Batched W4A8 serving over the paged KV pool (port of the main slice of
``repro.runtime.serve``).

``Server`` owns ``slots`` concurrent sequences (slot = batch row). A
request is admitted into a free slot when the pool can back its prompt
pages plus ``headroom_pages`` (token-budget admission on a fully backed
pool: ``slots * ceil(max_seq / page_size)`` pages, so a free slot always
fits); its prompt then streams through the model in page-aligned chunks
written straight into its pages, each chunk padded to a power of two and
its page table to a power-of-two width (``_chunk_plan``), so the set of
chunk shapes stays O(log max_seq). Every ``step()`` decodes one greedy
token for every active slot; pages are allocated on demand as rows cross
page boundaries (``_grow``) and return to the free list at retirement.
This is the reference's alternating engine.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: the mixed prefill+decode engine, the prefix cache,
preemption / spill, fault quarantine and audit (queue 1, item 8), sampled
decoding (item 9), the front-end (item 10), meshes (item 14).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.layers import PackedLinear
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import segments_for
from repro_torch.runtime import kv_cache as kvc
from repro_torch.runtime.kv_cache import CachePolicy
from repro_torch.runtime.sampling import SamplingParams, greedy_tokens

__all__ = ["Request", "RequestResult", "Server", "ServerConfig", "SchedulerConfig",
           "CachePolicy", "SamplingParams"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission and chunking knobs.

    * ``headroom_pages``: decode headroom charged at admission on top of
      the prompt's pages.
    * ``prefill_chunk_pages``: the streaming prefill chunk, in pages, so
      chunk starts stay page-aligned.
    * ``engine``: ``"alternating"`` only in this slice; ``"mixed"`` raises
      (ROADMAP queue 1, item 8)."""

    headroom_pages: int = 1
    prefill_chunk_pages: int = 4
    engine: str = "alternating"


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """``cache`` selects the page payload (``CachePolicy(active_fmt=
    'fp8_e4m3')`` packed FP8 codes with per-(page, head) M2 scales, or
    ``None`` for bf16 pages). ``prefix_cache=True`` raises (ROADMAP queue
    1, item 8)."""

    slots: int = 4
    max_seq: int = 512
    a_fmt: Optional[str] = "fp8_e4m3"
    cache: CachePolicy = CachePolicy()
    page_size: int = 64
    scheduler: SchedulerConfig = SchedulerConfig()
    prefix_cache: bool = False


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Immutable outcome of one served request. ``status`` is ``"ok"``
    (hit max_new) or ``"truncated"`` (retired at the max_seq bound);
    ``token_times`` are the host clock at each emitted token."""

    rid: int
    tokens: Tuple[int, ...]
    status: str
    prompt_len: int
    submitted_at: float
    token_times: Tuple[float, ...]

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    sampling: SamplingParams = SamplingParams()
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "ok"
    seq: int = 0  # server-managed arrival sequence
    t_submit: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)

    def result(self) -> RequestResult:
        return RequestResult(rid=self.rid, tokens=tuple(self.out), status=self.status,
                             prompt_len=len(self.prompt), submitted_at=self.t_submit,
                             token_times=tuple(self.token_times))


def _to_device(params, device):
    return tree_map(lambda t: t.apply(lambda x: x.to(device)) if isinstance(t, PackedLinear)
                    else t.to(device), params, is_leaf=lambda x: isinstance(x, PackedLinear))


class Server:
    def __init__(self, params, cfg, config: Optional[ServerConfig] = None, *, device=None):
        """``device``: the card unless ``device='cpu'`` is passed; without a
        GPU and without that request this raises. ``params`` (dense or
        packed) are moved there."""
        config = config or ServerConfig()
        sched = config.scheduler
        if sched.engine != "alternating":
            raise NotImplementedError(
                f"engine={sched.engine!r}: the mixed prefill+decode engine is not "
                "ported yet (ROADMAP queue 1, item 8); use engine='alternating'")
        if config.prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True: the shared-prefix cache is not ported yet "
                "(ROADMAP queue 1, item 8)")
        self.device = resolve_device(device)
        self.config = config
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.slots, self.max_seq, self.a_fmt = config.slots, config.max_seq, config.a_fmt
        self.page_size = page = config.page_size
        self.headroom_pages = sched.headroom_pages
        if sched.prefill_chunk_pages < 1:
            raise ValueError(f"prefill_chunk_pages={sched.prefill_chunk_pages} must be >= 1")
        self.prefill_token_budget = sched.prefill_chunk_pages * page
        self.pages_per_slot = math.ceil(self.max_seq / page)
        self._n_pages = self.slots * self.pages_per_slot  # fully backed pool
        self.pools = [kvc.init_gqa_pool(seg.count, self._n_pages, page, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, config.cache.active,
                                        device=self.device)
                      for seg in segments_for(cfg)]
        self.active: List[Optional[Request]] = [None] * self.slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.free_pages: List[int] = list(range(self._n_pages))
        self.slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self.page_table = np.full((self.slots, self.pages_per_slot), self._n_pages, np.int32)
        self.lengths = np.zeros(self.slots, np.int32)
        self.stats = {"steps": 0, "decoded_tokens": 0, "prefill_tokens": 0, "programs": 0}
        # distinct (padded chunk length, table width) prefill shapes
        self.prefill_traces: set = set()
        self._submit_seq = 0
        self._step_no = 0

    @property
    def _null_page(self) -> int:
        return self._n_pages

    # -- admission -------------------------------------------------------------
    def _worst_case_pages(self, req: Request) -> int:
        return kvc.pages_needed(min(len(req.prompt) + req.max_new, self.max_seq),
                                self.page_size)

    def submit(self, req: Request):
        if not len(req.prompt):
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new={req.max_new} must be >= 1")
        req.sampling.validate(req.rid)
        lo, hi = min(req.prompt), max(req.prompt)
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(f"request {req.rid}: prompt token ids must be in "
                             f"[0, {self.cfg.vocab_size}), got {lo if lo < 0 else hi}")
        if len(req.prompt) >= self.max_seq:
            raise ValueError(f"request {req.rid}: prompt length {len(req.prompt)} must be "
                             f"< max_seq={self.max_seq} (no room left to decode)")
        req.seq = self._submit_seq
        req.t_submit = time.perf_counter()
        self._submit_seq += 1
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            if not self.queue or not self._admit_one(slot):
                break  # the head of the line waits; nothing overtakes it

    def _admit_one(self, slot: int) -> bool:
        req = self.queue[0]
        need = min(kvc.pages_needed(len(req.prompt), self.page_size) + self.headroom_pages,
                   self._worst_case_pages(req))
        if need > len(self.free_pages):
            return False
        self.queue.pop(0)
        self.active[slot] = req
        self._alloc(slot, need)
        self._prefill_slot(slot, req)
        return True

    def _alloc(self, slot: int, npg: int):
        if npg > len(self.free_pages):
            raise RuntimeError(f"page pool exhausted ({npg} wanted, "
                               f"{len(self.free_pages)} free)")
        ids = [self.free_pages.pop(0) for _ in range(npg)]
        self.slot_pages[slot].extend(ids)
        owned = self.slot_pages[slot]
        self.page_table[slot, :len(owned)] = owned

    # -- streaming paged prefill -------------------------------------------------
    def _chunk_plan(self, slot: int, n: int, pos: int, budget: int):
        """One prefill chunk at stream position ``pos`` of an ``n``-token
        context: true length ``take``, power-of-two padded length, the
        power-of-two table width ``w`` and the (1, w) table. Only pages
        holding data up to the chunk's true end are mapped; the pad
        overhang points at the null page."""
        page = self.page_size
        take = min(budget, n - pos)
        padded = min(_next_pow2(take), budget)
        w = _next_pow2(pos // page + kvc.pages_needed(padded, page))
        own = self.slot_pages[slot]
        table = np.full((1, w), self._null_page, np.int32)
        m = min(w, len(own), kvc.pages_needed(pos + take, page))
        table[0, :m] = own[:m]
        return take, padded, w, table

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32)).to(self.device)

    def _run(self, tokens, state) -> torch.Tensor:
        self.stats["programs"] += 1
        return api.decode_step(self.params, self.cfg, self._tensor(tokens), self.pools,
                               state, a_fmt=self.a_fmt)

    def _prefill_slot(self, slot: int, req: Request):
        ctx = list(req.prompt)
        n, pos = len(ctx), 0
        logits = None
        while pos < n:
            take, padded, w, table = self._chunk_plan(slot, n, pos, self.prefill_token_budget)
            toks = [ctx[pos: pos + take] + [0] * (padded - take)]
            state = kvc.PagedState(self._tensor(table), self._tensor([pos]),
                                   chunk_len=self._tensor([take]))
            logits = self._run(toks, state)
            self._check_finite(logits, f"prefill of request {req.rid}")
            self.prefill_traces.add((padded, w))
            pos += take
        self.lengths[slot] = n
        self.stats["prefill_tokens"] += n
        self._emit_token(req, int(greedy_tokens(logits)[0]))

    @staticmethod
    def _check_finite(logits: torch.Tensor, what: str):
        # per-request quarantine is ROADMAP queue 1, item 8: until then a
        # non-finite row stops the engine instead of emitting garbage
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite logits during {what}")

    # -- decode ------------------------------------------------------------------
    def _grow(self):
        """Allocate a page for every active row whose next token crosses
        into an unallocated page, in arrival order."""
        order = sorted((s for s, r in enumerate(self.active) if r is not None),
                       key=lambda s: self.active[s].seq)
        for slot in order:
            if int(self.lengths[slot]) // self.page_size >= len(self.slot_pages[slot]):
                self._alloc(slot, 1)

    def _emit_token(self, req: Request, token: int):
        req.out.append(token)
        req.token_times.append(time.perf_counter())

    def step(self) -> bool:
        """One engine step: admit (and prefill) what fits, then decode one
        token for every active slot. Returns False when nothing is active."""
        self._admit()
        self._grow()
        if not any(r is not None for r in self.active):
            return False
        self._step_no += 1
        self.stats["steps"] += 1
        tok = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                tok[s, 0] = req.out[-1]
        state = kvc.PagedState(self._tensor(self.page_table), self._tensor(self.lengths))
        logits = self._run(tok, state)
        nxt = greedy_tokens(logits).cpu().numpy()
        ok = torch.isfinite(logits).all(-1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if not ok[s]:
                raise RuntimeError(f"non-finite logits at decode step {self._step_no} "
                                   f"(request {req.rid}, slot {s})")
            self._emit_token(req, int(nxt[s]))
            self.lengths[s] += 1
            self.stats["decoded_tokens"] += 1
            if len(req.out) >= req.max_new or self.lengths[s] >= self.max_seq - 1:
                if len(req.out) < req.max_new:
                    req.status = "truncated"
                self._retire(s, req)
        return True

    def _retire(self, slot: int, req: Request):
        """Free the slot and its pages. Pages are not zeroed: a recycled page
        is overwritten by the next prefill, and decode appends zero the
        positions past the new owner's length before requantizing."""
        req.done = True
        self.active[slot] = None
        self.finished.append(req)
        self.free_pages.extend(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot] = self._null_page
        self.lengths[slot] = 0

    def run_until_drained(self, max_steps: int = 10_000) -> List[RequestResult]:
        """Step until the queue and the slots are empty; returns the results
        of the requests finished during this call, in retirement order."""
        start = len(self.finished)
        for _ in range(max_steps):
            if self.step():
                continue
            if not self.queue:
                break
            raise RuntimeError(f"serving starved: {len(self.queue)} queued request(s) "
                               f"cannot be admitted with {len(self.free_pages)} free pages")
        else:
            raise RuntimeError(f"run_until_drained: max_steps={max_steps} exhausted")
        return [r.result() for r in self.finished[start:]]
