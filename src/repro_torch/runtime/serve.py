"""Batched W4A8 serving over the paged KV pool (port of the single-device
dense path of ``repro.runtime.serve``).

``Server`` owns ``slots`` concurrent sequences (slot = batch row). A
request is admitted into a free slot when the pool can back its prompt
pages plus ``headroom_pages`` (token-budget admission on a fully backed
pool: ``slots * ceil(max_seq / page_size)`` pages). Its prompt streams
through the model in page-aligned chunks written straight into its pages,
each chunk padded to a power of two and its page table to a power-of-two
width (``_chunk_plan``), so the set of chunk shapes stays O(log max_seq).
Pages are allocated on demand as rows cross page boundaries (``_grow``).

Two engines (``SchedulerConfig.engine``):

* ``"mixed"`` (the default): every ``step()`` runs one program carrying a
  decode token for every decoding slot plus the next chunk of one
  request's prompt (``_step_mixed``), so decoding never stalls behind a
  long prompt.
* ``"alternating"``: a prompt streams whole at admission, and decode steps
  carry decode rows only.

Page ownership is refcounted, and full prompt pages are content-addressed
(``prefix_cache=True``, the default): after its prefill a request's full
prompt pages are registered in a ``PrefixCache``, and a later request with
the same prefix maps them instead of prefilling them. The boundary page
is always private, so no write ever lands on a shared page; pages whose
refcount drops to 0 park in the index's LRU until reclaimed. With
``CachePolicy(frozen_fmt="fp4_e2m1")`` registration is the freeze point:
each page is transcoded once into the packed FP4 frozen region, whose
logical ids start at ``_frozen_base``.

The pool is written in place, so a write to a shared page would corrupt
its other owners silently: every write set is checked with
``PrefixCache.assert_unfrozen`` where the reference checks it.

The model is a decoder with GQA attention over K/V pages (learned
positions or rope) or MLA over latent pages (``init_mla_pool``: c_kv and
the rope key, no head axis), its ffn an MLP or an MoE layer that routes
per token; the engine is the same for all. Not ported yet, and refused with
``NotImplementedError`` naming the ROADMAP item: preemption, steal and
spill (queue 1, item 8; the fully backed pool never needs them, and the
engine raises where the reference would steal), fault quarantine and
audit (item 8), sampled decoding (item 9), the front-end (item 10), the
recurrent and enc-dec families (item 12) and meshes (item 14).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

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
      chunk starts stay page-aligned (the mixed step's piggyback budget
      too).
    * ``engine``: ``"mixed"`` or ``"alternating"`` (see the module
      docstring)."""

    headroom_pages: int = 1
    prefill_chunk_pages: int = 4
    engine: str = "mixed"


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """``cache`` selects the page payload per page class (``CachePolicy``:
    bf16 or FP8 active pages, optionally packed FP4 frozen pages).
    ``prefix_cache`` shares full prompt pages across requests; a
    mixed-precision policy needs it."""

    slots: int = 4
    max_seq: int = 512
    a_fmt: Optional[str] = "fp8_e4m3"
    cache: CachePolicy = CachePolicy()
    page_size: int = 64
    scheduler: SchedulerConfig = SchedulerConfig()
    prefix_cache: bool = True


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
        if sched.engine not in ("mixed", "alternating"):
            raise ValueError(f"unknown scheduler engine {sched.engine!r}")
        policy = config.cache
        if policy.mixed and not config.prefix_cache:
            raise ValueError(
                "CachePolicy(frozen_fmt=...) needs an active prefix cache: frozen FP4 pages "
                "hold only content-shared prefix pages (prefix_cache=True)")
        if sched.prefill_chunk_pages < 1:
            raise ValueError(f"prefill_chunk_pages={sched.prefill_chunk_pages} must be >= 1")
        self.device = resolve_device(device)
        self.config = config
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.slots, self.max_seq, self.a_fmt = config.slots, config.max_seq, config.a_fmt
        self.page_size = page = config.page_size
        self.headroom_pages = sched.headroom_pages
        self.prefill_token_budget = sched.prefill_chunk_pages * page
        self.pages_per_slot = math.ceil(self.max_seq / page)
        self._n_pages = self.slots * self.pages_per_slot  # fully backed pool
        # a mixed-precision pool (FP4 frozen region) is not the mixed engine
        self._mixed_precision = policy.mixed
        self._mixed_step = sched.engine == "mixed"
        self._n_frozen = (policy.frozen_pages or self._n_pages) if policy.mixed else 0
        frozen_fmt = policy.frozen if policy.mixed else None
        self.pools = []
        for seg in segments_for(cfg):
            if seg.mixer == "mla":  # latent pages: c_kv and the shared rope key
                pool = kvc.init_mla_pool(seg.count, self._n_pages, page, cfg.mla.kv_lora_rank,
                                         cfg.mla.qk_rope_dim, policy.active, frozen_fmt,
                                         self._n_frozen, device=self.device)
            else:
                pool = kvc.init_gqa_pool(seg.count, self._n_pages, page, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, policy.active, frozen_fmt,
                                         self._n_frozen, device=self.device)
            self.pools.append(pool)
        self.active: List[Optional[Request]] = [None] * self.slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.free_pages: List[int] = list(range(self._n_pages))
        # frozen logical ids: _frozen_base + row of the *_fz stores
        self.free_frozen: List[int] = [self._frozen_base + i for i in range(self._n_frozen)]
        # page_refs[pid]: slots mapping the page now, over the logical id
        # space (active pool, the never-mapped null page, frozen region)
        self.page_refs = np.zeros(self._n_pages + 1 + self._n_frozen, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        # the leading run of each slot's pages that is shared (registered)
        self.slot_shared: List[int] = [0] * self.slots
        self._prefix = kvc.PrefixCache(page) if config.prefix_cache else None
        self.page_table = np.full((self.slots, self.pages_per_slot), self._n_pages, np.int32)
        self.lengths = np.zeros(self.slots, np.int32)
        self.stats = {"steps": 0, "decoded_tokens": 0, "prefill_tokens": 0, "programs": 0,
                      "prefix_hit_pages": 0, "prefix_hit_tokens": 0, "prefix_reclaims": 0,
                      "fp4_frozen_pages": 0}
        # distinct (padded chunk length, table width) prefill shapes
        self.prefill_traces: set = set()
        self._submit_seq = 0
        self._step_no = 0

    @property
    def engine(self) -> str:
        return "mixed" if self._mixed_step else "alternating"

    @property
    def _null_page(self) -> int:
        return self._n_pages

    @property
    def _frozen_base(self) -> int:
        """The first frozen logical id (the active store's row count, P+1)."""
        return self._n_pages + 1

    # -- page ownership ----------------------------------------------------------
    def _free_capacity(self) -> int:
        """Active pages allocatable now: the free list plus, in a
        homogeneous pool, the parked registered pages (reclaimed before
        anything else). In a mixed-precision pool every registered page is
        frozen-class, which no private allocation can use."""
        n = len(self.free_pages)
        if self._prefix is not None and not self._mixed_precision:
            n += self._prefix.n_reusable
        return n

    def _take_page(self) -> int:
        """One blank active page: the free list first, then the least
        recently parked registered page (never in a mixed-precision pool)."""
        if self.free_pages:
            return self.free_pages.pop(0)
        pid = None if self._mixed_precision or self._prefix is None else self._prefix.reclaim()
        if pid is None:
            raise RuntimeError("page pool exhausted: preemption by page steal is not ported "
                               "yet (ROADMAP queue 1, item 8)")
        self.stats["prefix_reclaims"] += 1
        return pid

    def _take_frozen(self) -> Optional[int]:
        """One blank frozen id for a freeze-time transcode: the frozen free
        list, then the least recently parked page (every registered page is
        frozen here). None when the region is fully live."""
        if self.free_frozen:
            return self.free_frozen.pop(0)
        pid = self._prefix.reclaim()
        if pid is not None:
            self.stats["prefix_reclaims"] += 1
        return pid

    def _release_page(self, pid: int):
        """Drop one mapping of ``pid``. At refcount 0 a registered page
        parks in the prefix LRU; any other returns to its class's free list."""
        self.page_refs[pid] -= 1
        if self.page_refs[pid] < 0:
            raise AssertionError(f"double free of page {pid}")
        if self.page_refs[pid] > 0:
            return
        if self._prefix is not None and self._prefix.registered(pid):
            self._prefix.park(pid)
        elif pid >= self._frozen_base:
            self.free_frozen.append(pid)
        else:
            self.free_pages.append(pid)

    def _parked_among(self, pids: List[int]) -> int:
        """How many of these hits are parked active pages: they count in
        ``_free_capacity`` and stop being allocatable once mapped."""
        return sum(1 for pid in pids if pid < self._n_pages and self.page_refs[pid] == 0)

    def _map_shared(self, slot: int, pids: List[int]):
        """Map prefix hits into an empty slot (refcount++, unpark)."""
        for pid in pids:
            if self.page_refs[pid] == 0:
                self._prefix.unpark(pid)
            self.page_refs[pid] += 1
        self.slot_pages[slot] = list(pids)
        self.slot_shared[slot] = len(pids)
        self.page_table[slot, :len(pids)] = pids

    def _alloc(self, slot: int, npg: int):
        ids = [self._take_page() for _ in range(npg)]
        for pid in ids:
            self.page_refs[pid] += 1
        self.slot_pages[slot].extend(ids)
        owned = self.slot_pages[slot]
        self.page_table[slot, :len(owned)] = owned

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
        n, page = len(req.prompt), self.page_size
        hits: List[int] = []
        if self._prefix is not None:
            # the last prompt token always streams (its logits seed decode),
            # which also keeps the boundary page private
            hits = self._prefix.walk(req.prompt, max_pages=(n - 1) // page)
        free = self._free_capacity() - self._parked_among(hits)
        need = min(kvc.pages_needed(n, page) - len(hits) + self.headroom_pages,
                   self._worst_case_pages(req) - len(hits))
        if need > free:
            return False
        self.queue.pop(0)
        self.active[slot] = req
        if hits:
            self._map_shared(slot, hits)
            self.lengths[slot] = len(hits) * page
            self.stats["prefix_hit_pages"] += len(hits)
            self.stats["prefix_hit_tokens"] += len(hits) * page
        self._alloc(slot, need)
        if not self._mixed_step:
            self._prefill_slot(slot, req)
        elif self._prefix is not None:
            # the mixed engine streams the prompt in later steps; its write
            # set is this slot's private pages from the first unshared one
            self._prefix.assert_unfrozen(
                self.slot_pages[slot][int(self.lengths[slot]) // page:
                                      kvc.pages_needed(n, page)],
                frozen_base=self._frozen_base)
        return True

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
        """Alternating engine: stream the prompt past the mapped prefix
        hits, register its full pages, emit the first token."""
        ctx = list(req.prompt)
        n, page = len(ctx), self.page_size
        start = pos = int(self.lengths[slot])
        if self._prefix is not None:
            self._prefix.assert_unfrozen(self.slot_pages[slot][start // page:
                                                               kvc.pages_needed(n, page)],
                                         frozen_base=self._frozen_base)
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
        self.stats["prefill_tokens"] += n - start
        if self._prefix is not None:
            self._register_prefix(slot, req)
        self._emit_token(req, int(greedy_tokens(logits)[0]))

    def _register_prefix(self, slot: int, req: Request):
        """Register this slot's full prompt pages in the prefix index once
        its prefill is done. A homogeneous pool adopts the canonical page
        where the chain already exists and releases its duplicate. A
        mixed-precision pool freezes here: each new page is transcoded once
        into a frozen id (or an existing frozen canonical is adopted), the
        slot remapped and the FP8 source released; when the frozen region
        is fully live the rest stays private FP8."""
        page = self.page_size
        n_full = len(req.prompt) // page
        shared = self.slot_shared[slot]
        if n_full <= shared:
            return
        own = self.slot_pages[slot]
        if not self._mixed_precision:
            canon = self._prefix.insert(req.prompt[:n_full * page], own[:n_full])
            for i in range(shared, n_full):
                if canon[i] != own[i]:  # duplicate content: adopt the canonical
                    dup = own[i]
                    if self.page_refs[canon[i]] == 0:
                        self._prefix.unpark(canon[i])
                    self.page_refs[canon[i]] += 1
                    own[i] = canon[i]
                    self.page_table[slot, i] = canon[i]
                    self._release_page(dup)
            self.slot_shared[slot] = n_full
            return
        canon = self._prefix.walk(req.prompt, max_pages=n_full)
        end = shared
        for i in range(shared, n_full):
            src = own[i]
            if i < len(canon):  # already frozen under this prefix: adopt it
                fid = canon[i]
                if self.page_refs[fid] == 0:
                    self._prefix.unpark(fid)
            else:
                fid = self._take_frozen()
                if fid is None:
                    break  # the frozen region is fully live
                for pool in self.pools:
                    kvc.transcode_page(pool, src, fid - self._frozen_base)
                self.stats["fp4_frozen_pages"] += 1
            self.page_refs[fid] += 1
            own[i] = fid
            self.page_table[slot, i] = fid
            self._release_page(src)
            end = i + 1
        if end > shared:
            self._prefix.insert(req.prompt[:end * page], own[:end])
        self.slot_shared[slot] = end

    @staticmethod
    def _check_finite(logits: torch.Tensor, what: str):
        # per-request quarantine is ROADMAP queue 1, item 8: until then a
        # non-finite row stops the engine instead of emitting garbage
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite logits during {what}")

    # -- the mixed engine ------------------------------------------------------
    @staticmethod
    def _ctx_target(req: Request) -> int:
        """The KV length at which ``req`` is prefilled and decoding: its
        prompt plus every emitted token but the newest."""
        return len(req.prompt) + max(len(req.out) - 1, 0)

    def _extend_shared(self, slot: int, ctx: List[int]):
        """At the start of a stream, adopt prefix pages a sibling stream
        registered after this request's admission: each maps over the
        private page admitted for the same position (released), and the
        stream starts past them."""
        page = self.page_size
        shared = self.slot_shared[slot]
        hits = self._prefix.walk(ctx, max_pages=(len(ctx) - 1) // page)
        if len(hits) <= shared:
            return
        own = self.slot_pages[slot]
        for i in range(shared, len(hits)):
            pid = hits[i]
            if self.page_refs[pid] == 0:
                self._prefix.unpark(pid)
            self.page_refs[pid] += 1
            self._release_page(own[i])
            own[i] = pid
            self.page_table[slot, i] = pid
        self.slot_shared[slot] = len(hits)
        self.lengths[slot] = len(hits) * page
        self.stats["prefix_hit_pages"] += len(hits) - shared
        self.stats["prefix_hit_tokens"] += (len(hits) - shared) * page

    def _grow_for_chunk(self, slot: int):
        """Make sure ``slot`` owns every page its next chunk writes
        (admission allocated the whole prompt, so this finds them there)."""
        end = min(int(self.lengths[slot]) + self.prefill_token_budget,
                  self._ctx_target(self.active[slot]))
        while kvc.pages_needed(end, self.page_size) > len(self.slot_pages[slot]):
            if not self._free_capacity():
                raise RuntimeError("page pool exhausted: preemption by page steal is not "
                                   "ported yet (ROADMAP queue 1, item 8)")
            self._alloc(slot, 1)

    def _pick_prefill_slot(self) -> Optional[int]:
        """The mid-prefill slot whose request arrived first, or None when
        every active row is decoding."""
        mid = [s for s, r in enumerate(self.active)
               if r is not None and int(self.lengths[s]) < self._ctx_target(r)]
        return min(mid, key=lambda s: self.active[s].seq) if mid else None

    # -- decode ------------------------------------------------------------------
    def _grow(self):
        """Allocate a page for every active row whose next token crosses
        into an unallocated page, in arrival order."""
        order = sorted((s for s, r in enumerate(self.active) if r is not None),
                       key=lambda s: self.active[s].seq)
        for slot in order:
            if int(self.lengths[slot]) // self.page_size >= len(self.slot_pages[slot]):
                if not self._free_capacity():
                    raise RuntimeError("page pool exhausted: preemption by page steal is not "
                                       "ported yet (ROADMAP queue 1, item 8)")
                self._alloc(slot, 1)

    def _emit_token(self, req: Request, token: int):
        req.out.append(token)
        req.token_times.append(time.perf_counter())

    def step(self) -> bool:
        """One engine step: admit what fits, then decode one token for every
        decoding slot; the mixed engine also carries the next prefill chunk
        of one mid-prefill request. Returns False when nothing is active."""
        self._admit()
        self._grow()
        pf_slot = self._pick_prefill_slot() if self._mixed_step else None
        if pf_slot is not None:
            r = self.active[pf_slot]
            if (self._prefix is not None
                    and int(self.lengths[pf_slot]) == self.slot_shared[pf_slot] * self.page_size):
                self._extend_shared(pf_slot, list(r.prompt) + list(r.out[:-1]))
            self._grow_for_chunk(pf_slot)
        if not any(r is not None for r in self.active):
            return False
        self._step_no += 1
        self.stats["steps"] += 1
        decoding = [s for s, r in enumerate(self.active)
                    if r is not None and int(self.lengths[s]) >= self._ctx_target(r)]
        if self._prefix is not None:
            # copy-on-write: the page each row's write lands on next (its
            # boundary page; a mid-prefill row's next chunk page) is private
            self._prefix.assert_unfrozen(
                (self.slot_pages[s][int(self.lengths[s]) // self.page_size]
                 for s, r in enumerate(self.active) if r is not None),
                frozen_base=self._frozen_base)
        if pf_slot is not None:
            self._step_mixed(pf_slot, decoding)
        else:
            self._step_decode()
        return True

    def _step_decode(self):
        """Every active row is at its context target and decodes one token."""
        tok = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                tok[s, 0] = req.out[-1]
        state = kvc.PagedState(self._tensor(self.page_table), self._tensor(self.lengths))
        logits = self._run(tok, state)
        nxt = greedy_tokens(logits).cpu().numpy()
        ok = torch.isfinite(logits).all(-1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is not None:
                self._finish_decode_row(s, req, ok[s], nxt[s])

    def _finish_decode_row(self, s: int, req: Request, ok: bool, nxt):
        if not ok:
            raise RuntimeError(f"non-finite logits at decode step {self._step_no} "
                               f"(request {req.rid}, slot {s})")
        self._emit_token(req, int(nxt))
        self.lengths[s] += 1
        self.stats["decoded_tokens"] += 1
        if len(req.out) >= req.max_new or self.lengths[s] >= self.max_seq - 1:
            if len(req.out) < req.max_new:
                req.status = "truncated"
            self._retire(s, req)

    def _step_mixed(self, pf_slot: int, decoding: List[int]):
        """One program: every decoding row's next token plus the next chunk
        of ``pf_slot``'s prompt, as the fused row ``(1, slots + padded)``.
        Non-decoding slots (``pf_slot`` among them) ride with lengths 0, so
        their decode-lane appends go to the null page. Logits come back
        ``(slots + 1, V)``: one row per slot, then the chunk's last token."""
        req = self.active[pf_slot]
        ctx = list(req.prompt) + list(req.out[:-1])
        n, pos = len(ctx), int(self.lengths[pf_slot])
        take, padded, w, table = self._chunk_plan(pf_slot, n, pos, self.prefill_token_budget)
        is_decoding = np.zeros(self.slots, bool)
        is_decoding[decoding] = True
        tok = np.zeros((1, self.slots + padded), np.int32)
        for s in decoding:
            tok[0, s] = self.active[s].out[-1]
        tok[0, self.slots: self.slots + take] = ctx[pos: pos + take]
        pre = kvc.PagedState(self._tensor(table), self._tensor([pos]),
                             chunk_len=self._tensor([take]))
        state = kvc.PagedState(self._tensor(self.page_table),
                               self._tensor(np.where(is_decoding, self.lengths, 0)),
                               prefill=pre)
        logits = self._run(tok, state)
        self.prefill_traces.add((padded, w))
        nxt = greedy_tokens(logits).cpu().numpy()
        ok = torch.isfinite(logits).all(-1).cpu().numpy()
        self.lengths[pf_slot] = pos + take
        self.stats["prefill_tokens"] += take
        if not ok[self.slots]:
            raise RuntimeError(f"non-finite logits during prefill of request {req.rid}")
        if pos + take == n:
            if self._prefix is not None:
                self._register_prefix(pf_slot, req)
            if not req.out:  # the final chunk's token seeds decode
                self._emit_token(req, int(nxt[self.slots]))
        for s in decoding:
            self._finish_decode_row(s, self.active[s], ok[s], nxt[s])

    def _retire(self, slot: int, req: Request):
        """Free the slot and release its pages (registered ones park).
        Pages are not zeroed: a recycled page is overwritten by the next
        prefill, and decode appends zero the positions past the new owner's
        length before requantizing."""
        req.done = True
        self.active[slot] = None
        self.finished.append(req)
        for pid in self.slot_pages[slot]:
            self._release_page(pid)
        self.slot_pages[slot] = []
        self.slot_shared[slot] = 0
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
                               f"cannot be admitted with {self._free_capacity()} free pages")
        else:
            raise RuntimeError(f"run_until_drained: max_steps={max_steps} exhausted")
        return [r.result() for r in self.finished[start:]]

    # -- accounting ------------------------------------------------------------
    @property
    def reusable_pages(self) -> List[int]:
        """Registered pages at refcount 0, parked in the prefix LRU."""
        return self._prefix.reusable_ids() if self._prefix is not None else []

    def prefix_hit_rate(self) -> float:
        """Share of prefilled-or-hit prompt tokens served from the cache."""
        total = self.stats["prefix_hit_tokens"] + self.stats["prefill_tokens"]
        return self.stats["prefix_hit_tokens"] / total if total else 0.0

    def cache_residency(self) -> Dict:
        """Live (mapped or parked) pages per class, what each class costs
        per token, and the blended bytes per token of everything resident."""
        page = self.page_size
        active_pb = sum(kvc.page_bytes(p) for p in self.pools)
        frozen_pb = sum(kvc.page_bytes(p, frozen=True) for p in self.pools)
        parked = set(self.reusable_pages)
        base = self._frozen_base
        n_active = sum(1 for pid in range(self._n_pages)
                       if self.page_refs[pid] > 0 or pid in parked)
        n_frozen = sum(1 for pid in range(base, base + self._n_frozen)
                       if self.page_refs[pid] > 0 or pid in parked)
        live_bytes = n_active * active_pb + n_frozen * frozen_pb
        tokens = (n_active + n_frozen) * page
        return {
            "n_active_live": int(n_active),
            "n_frozen_live": int(n_frozen),
            "active_bytes_per_token": active_pb / page,
            "frozen_bytes_per_token": frozen_pb / page if self._mixed_precision else 0.0,
            "live_bytes": float(live_bytes),
            "resident_tokens": int(tokens),
            "bytes_per_token": float(live_bytes / tokens) if tokens else 0.0,
        }
