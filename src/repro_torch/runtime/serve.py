"""Batched W4A8 serving over the paged KV pool and state slabs (port of the
single-device path of ``repro.runtime.serve``).

``Server`` owns ``slots`` concurrent sequences (slot = batch row). Its
prompt streams through the model in page-aligned chunks written straight
into its pages, each chunk padded to a power of two and its page table to
a power-of-two width (``_chunk_plan``), so the set of chunk shapes stays
O(log max_seq). Pages are allocated on demand as rows cross page
boundaries (``_grow``).

Scheduling (``SchedulerConfig.policy``):

* ``"token_budget"`` (the default): admission charges the prompt's pages
  plus ``headroom_pages``; the pool (``ServerConfig.pool_pages``, by
  default ``slots * ceil(max_seq / page_size)``) may be smaller than the
  worst case. On exhaustion the lowest-priority running request (then the
  most deadline slack, then the newest) is preempted by stealing its
  pages: its private page payload (codes and scales, every layer) is
  copied to host memory under a CRC32 and its pages return to the pool.
  It resumes token-identically once capacity returns, its bytes written
  back into whatever pages are free (``_resume``); a spill whose CRC no
  longer matches, whose shared prefix was reclaimed meanwhile, or which
  the host budget (``spill_budget_bytes``) evicts re-prefills its context
  instead. Readmission is one wait line over spills and fresh requests,
  keyed by (step it entered the line, arrival). Watermarks and a steal
  cooldown damp steal/resume thrash.
* ``"reserve"``: worst-case pages (prompt + max_new) are reserved at
  admission, so nothing is ever stolen.

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
refcount drops to 0 park in the index's LRU until reclaimed (before any
live request is stolen from). A preemption spills only private pages and
re-walks the shared prefix on resume. With
``CachePolicy(frozen_fmt="fp4_e2m1")`` registration is the freeze point:
each page is transcoded once into the packed FP4 frozen region, whose
logical ids start at ``_frozen_base``.

A non-finite logits row costs its request alone: the row's pages are
zeroed and the request retires ``failed`` while the others keep decoding.
``FaultPlan`` (``runtime.faults``) injects such rows, tampered spills and
blanked allocator ticks through hooks that do nothing by default;
``audit()`` checks the pool's ownership invariants (every
``audit_every`` steps, or ad hoc).

The pool is written in place, so a write to a shared page would corrupt
its other owners silently: every write set is checked with
``PrefixCache.assert_unfrozen`` where the reference checks it. Spill
restores and quarantine scrubs write by page index into the same leaves,
so the pool's addresses never change.

The model is a decoder with GQA attention over K/V pages (learned
positions or rope) or MLA over latent pages (``init_mla_pool``: c_kv and
the rope key, no head axis), its ffn an MLP or an MoE layer that routes
per token; the engine is the same for all. A VLM is served text-only, as
the reference serves it. An enc-dec (Whisper-style) decoder adds
write-once cross pages: each request carries its encoder frames
(``Request.frames``); admission charges the prompt's pages plus
``pages(encoder_seq)`` from the same pool and runs the encoder once,
quantizing every decoder layer's cross K/V into the request's cross pages
(``kv_cache.write_cross_pages``), which every decode step reads through the
paged decode kernel. Its prefix chains hang off a root per frames digest,
so a prompt under other frames never shares a page; its cross pages go
with it through steal, spill and resume; it runs the alternating engine
(``Server.engine`` says so).

The recurrent families hold their fixed-size decode state in *state
slabs*: one slab a running request, allocated at admission (and reset to
the pristine state, since a prefill continues from whatever its slab
holds), stolen, spilled, resumed and scrubbed like pages, never grown.
xLSTM (mLSTM / sLSTM pairs) holds slabs only; Zamba2's hybrid holds a
Mamba2 slab pool and pages for its shared attention block, one page layer
an invocation. ``ServerConfig.pool_slabs`` sizes the slab pool (None: one
a slot); when it runs dry the token budget steals a running request's
slab for a waiter of strictly higher priority, the reserve policy waits.
Their prompts stream in exact chunk lengths (a recurrence cannot mask pad
tokens out of its carry), on the alternating engine, with no prefix cache.
DeepSeek-V3's MLA segments (its dense layers, then its MoE layers) each
hold a latent pool, walked in segment order wherever the pools are; its
multi-token prediction block is never read by a served step, as in the
reference. Not ported yet: FP4 cross pages (``CachePolicy(cross_fmt=
"fp4_e2m1")`` on an enc-dec model raises, naming F9: the reference
misreads them); and meshes (item 14): ``ServerConfig`` has no ``mesh``
field, so ``ServerConfig(mesh=...)`` raises ``TypeError``.

Sampling (``Request.sampling``): each step draws every row's token from
its logits with the row's ``SamplingParams`` (``runtime.sampling``); a
step whose rows are all greedy takes the argmax and nothing else. The
draw at emitted-token index ``i`` is keyed by ``fold_in(PRNGKey(seed),
i)``, so a stream does not depend on the batch, the slot, or a steal and
resume. ``collect_events`` buffers a ``TokenEvent`` for every emitted
token and every retirement, drained by ``pop_events`` (the front-end,
``runtime.frontend``, switches it on).
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import math
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.layers import PackedLinear
from repro_torch.models.params import tree_map
from repro_torch.models.ssm import init_mamba2_cache
from repro_torch.models.transformer import segments_for
from repro_torch.models.xlstm import init_mlstm_cache, init_slstm_cache
from repro_torch.runtime import kv_cache as kvc
from repro_torch.runtime.faults import FaultPlan, PoolCorruptionError, ServingError
from repro_torch.runtime import sampling as smp
from repro_torch.runtime.kv_cache import CachePolicy
from repro_torch.runtime.sampling import SamplingParams

__all__ = ["Request", "RequestResult", "TokenEvent", "Server", "ServerConfig",
           "SchedulerConfig", "CachePolicy", "SamplingParams", "FaultPlan",
           "PoolCorruptionError", "ServingError"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission, preemption and chunking knobs.

    * ``policy``: ``"token_budget"`` or ``"reserve"`` (see the module
      docstring); the knobs below up to ``spill_budget_bytes`` act only
      under ``token_budget``.
    * ``headroom_pages``: decode headroom charged at admission on top of
      the prompt's pages.
    * ``low_watermark``: pages that must stay free after admitting fresh
      work while other requests run.
    * ``resume_watermark``: free pages beyond a spill's context required
      to resume it while other requests run.
    * ``steal_cooldown``: steps a freshly admitted or resumed request is
      protected from preemption (unless no other victim exists).
    * ``spill_budget_bytes``: cap on host bytes held by spills; over it the
      oldest spill is evicted and its request re-prefills (None: no cap).
    * ``prefill_chunk_pages``: the streaming prefill chunk, in pages, where
      ``prefill_token_budget`` is None.
    * ``engine``: ``"mixed"`` or ``"alternating"``.
    * ``prefill_token_budget``: the prefill chunk in tokens for both engines
      (the mixed step's piggyback cap, the alternating stream's chunk),
      rounded down to a page multiple and at least one page, so chunk
      starts stay page-aligned (None: ``prefill_chunk_pages`` worth).

    Both watermarks are waived when nothing runs."""

    policy: str = "token_budget"
    headroom_pages: int = 1
    low_watermark: int = 0
    resume_watermark: int = 1
    steal_cooldown: int = 2
    prefill_chunk_pages: int = 4
    spill_budget_bytes: Optional[int] = None
    engine: str = "mixed"
    prefill_token_budget: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """``cache`` selects the page payload per page class (``CachePolicy``:
    bf16 or FP8 active pages, optionally packed FP4 frozen pages).
    ``pool_pages``: the active pool's capacity in pages (None: fully
    backed, ``slots * ceil(max_seq / page_size)``). ``pool_slabs``: state
    slabs of a recurrent family (None: one a slot, fully backed).
    ``prefix_cache`` shares full prompt pages across requests (page
    families only); a mixed-precision policy needs it.

    Failure semantics: ``strict=True`` makes ``run_until_drained`` raise
    ``ServingError`` on starvation; ``strict=False`` fails the requests
    that cannot be admitted, one by one, and completes the drain.
    ``audit_every=N`` runs ``Server.audit()`` every N decode steps (0:
    never)."""

    slots: int = 4
    max_seq: int = 512
    a_fmt: Optional[str] = "fp8_e4m3"
    cache: CachePolicy = CachePolicy()
    page_size: int = 64
    pool_pages: Optional[int] = None
    pool_slabs: Optional[int] = None
    scheduler: SchedulerConfig = SchedulerConfig()
    prefix_cache: bool = True
    strict: bool = True
    audit_every: int = 0


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One engine emission: a token of a request (``index`` 0 is the
    prefill's seed token), or with ``finished=True`` and ``token=None`` the
    request's terminal event carrying its ``status``. ``t`` is the host
    clock at emission. Buffered only while ``Server.collect_events`` is on."""

    rid: int
    token: Optional[int]
    index: int
    t: float
    finished: bool = False
    status: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Immutable outcome of one served request. ``status`` is ``"ok"``
    (hit max_new), ``"truncated"`` (retired at the max_seq bound) or
    ``"failed"`` (quarantined; ``error`` says why); ``token_times`` are
    the host clock at each emitted token, read by ``ttft`` and ``itl``."""

    rid: int
    tokens: Tuple[int, ...]
    status: str
    error: Optional[str]
    prompt_len: int
    preemptions: int  # times this request's pages were stolen
    evictions: int  # times its host spill was dropped (re-prefilled)
    submitted_at: float
    token_times: Tuple[float, ...]

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def truncated(self) -> bool:
        return self.status == "truncated"

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submit to the first token (None if none came)."""
        return self.token_times[0] - self.submitted_at if self.token_times else None

    @property
    def itl(self) -> Tuple[float, ...]:
        """Seconds between consecutive tokens (empty with < 2 tokens)."""
        ts = self.token_times
        return tuple(b - a for a, b in zip(ts, ts[1:]))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    sampling: SamplingParams = SamplingParams()
    priority: int = 0  # higher = stolen from last; ties -> slack, then age
    deadline_step: Optional[int] = None  # engine step to finish by (None: no SLO)
    frames: Optional[np.ndarray] = None  # enc-dec: (encoder_seq, d) frame embeddings
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "ok"  # "ok" | "truncated" | "failed"
    error: Optional[str] = None  # why, when failed
    preemptions: int = 0
    evictions: int = 0
    resume_ctx: Optional[list] = None  # evicted: the context to re-prefill
    since: int = 0  # server-managed: step this request entered the wait line
    seq: int = 0  # server-managed: arrival sequence (tie-break)
    t_submit: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)
    _frames_digest: Optional[str] = dataclasses.field(default=None, repr=False, compare=False)

    def frames_digest(self) -> str:
        """sha256 of the encoder frames' bytes (enc-dec requests), computed
        once. The prefix cache roots this request's chains on it: decoder
        K/V depends on the frames, so equal prompts share pages only under
        bit-identical frames."""
        if self._frames_digest is None:
            assert self.frames is not None
            self._frames_digest = hashlib.sha256(
                np.ascontiguousarray(self.frames).tobytes()).hexdigest()
        return self._frames_digest

    @property
    def truncated(self) -> bool:
        return self.status == "truncated"

    def result(self) -> RequestResult:
        return RequestResult(rid=self.rid, tokens=tuple(self.out), status=self.status,
                             error=self.error, prompt_len=len(self.prompt),
                             preemptions=self.preemptions, evictions=self.evictions,
                             submitted_at=self.t_submit, token_times=tuple(self.token_times))


@dataclasses.dataclass
class _Spill:
    """A preempted request's resumable state: the bytes of its private
    pages (every pool leaf but the frozen region's, every layer) and of its
    state slab at preemption, on the host, one part a pool unit. Shared
    prefix pages are not spilled: they stay in the prefix index and are
    walked again on resume."""

    req: Request
    ctx_len: int  # tokens of KV spilled (prompt + generated so far)
    shared_pages: int  # leading shared pages (not in the payload)
    payload: List[Dict[str, np.ndarray]]  # per pool: leaf -> host array
    nbytes: int  # host bytes held (spill budget accounting)
    crc: int = 0  # kvc.payload_checksum of the pristine payload
    # the stream's RNG state at preemption: token i's key is
    # fold_in(PRNGKey(seed), i), so (seed, tokens emitted) is all of it;
    # _resume checks it against the request
    rng_seed: int = 0
    emitted: int = 0


def _to_device(params, device):
    return tree_map(lambda t: t.apply(lambda x: x.to(device)) if isinstance(t, PackedLinear)
                    else t.to(device), params, is_leaf=lambda x: isinstance(x, PackedLinear))


class Server:
    def __init__(self, params, cfg, config: Optional[ServerConfig] = None, *, device=None,
                 faults: Optional[FaultPlan] = None):
        """``device``: the card unless ``device='cpu'`` is passed; without a
        GPU and without that request this raises. ``params`` (dense or
        packed) are moved there. ``faults``: a ``FaultPlan`` consulted at
        the engine's injection hooks (None: every hook does nothing)."""
        config = config or ServerConfig()
        sched = config.scheduler
        if sched.policy not in ("token_budget", "reserve"):
            raise ValueError(f"unknown scheduler policy {sched.policy!r}")
        if sched.engine not in ("mixed", "alternating"):
            raise ValueError(f"unknown scheduler engine {sched.engine!r}")
        policy = config.cache
        # the prefix cache (and so the FP4 frozen region, which only the
        # freeze-time transcode writes) exists for pure page families:
        # recurrent state cannot skip a prefix's prefill
        if policy.mixed and not (config.prefix_cache and cfg.ssm is None):
            raise ValueError(
                "CachePolicy(frozen_fmt=...) needs an active prefix cache: frozen FP4 pages "
                "hold only content-shared prefix pages, which exist for pure page families "
                "with prefix_cache=True")
        if sched.prefill_chunk_pages < 1:
            raise ValueError(f"prefill_chunk_pages={sched.prefill_chunk_pages} must be >= 1")
        self._encdec = cfg.encoder_layers > 0
        if self._encdec and policy.cross.packed:
            raise NotImplementedError(
                "CachePolicy(cross_fmt='fp4_e2m1'): packed FP4 cross pages have no working "
                "reference (the reference's decode reads their packed width as the head "
                "width and fails at its first step; ROADMAP queue 3, F9)")
        self.device = resolve_device(device)
        self.config = config
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.slots, self.max_seq, self.a_fmt = config.slots, config.max_seq, config.a_fmt
        self.page_size = page = config.page_size
        self.scheduler = sched.policy
        self.headroom_pages = sched.headroom_pages
        self.low_watermark = sched.low_watermark
        self.resume_watermark = sched.resume_watermark
        self.steal_cooldown = sched.steal_cooldown
        self.spill_budget_bytes = sched.spill_budget_bytes
        budget = sched.prefill_token_budget
        if budget is None:
            budget = sched.prefill_chunk_pages * page
        self.prefill_token_budget = max(page, budget // page * page)
        self.strict = config.strict
        self.audit_every = config.audit_every
        self.faults = faults
        self.pages_per_slot = math.ceil(self.max_seq / page)
        # an enc-dec request also holds the write-once cross pages of its
        # encoder sequence, charged from the same page id space
        self._cross_pp = kvc.pages_needed(cfg.encoder_seq, page) if self._encdec else 0
        n_pages = config.pool_pages or self.slots * (self.pages_per_slot + self._cross_pp)
        self._n_slabs = (config.pool_slabs or self.slots) if cfg.ssm is not None else 0
        # a mixed-precision pool (FP4 frozen region) is not the mixed engine
        self._mixed_precision = policy.mixed
        self._n_frozen = (policy.frozen_pages or n_pages) if policy.mixed else 0
        self.cross_pool = None
        self._build_pools(n_pages, policy)
        self._has_pages = any(kind in ("kv", "cross") for _, kind in self._units)
        self._has_slabs = any(kind == "slab" for _, kind in self._units)
        # the pristine one-slab state of each slab unit: a recycled slab is
        # reset to it at allocation (a page is overwritten whole by the next
        # prefill, but a recurrent prefill continues from whatever state its
        # slab holds: a previous owner's must not leak in, nor zeros, where
        # mLSTM's stabilizer starts at -1e30 and sLSTM's normalizer at 1)
        self._slab_init = {ui: {name: leaf[:, :1].clone() for name, leaf in pool.items()}
                           for ui, (pool, kind) in enumerate(self._units) if kind == "slab"}
        self._n_pages = n_pages if self._has_pages else 0
        # a recurrence cannot mask pad tokens out of its carry: slab
        # families stream exact chunk lengths, not powers of two
        self._bucket_prefill = not self._has_slabs
        # the mixed step is for page families: recurrent state cannot ride
        # a padded fused row, and enc-dec admission runs the encoder
        self._mixed_step = (sched.engine == "mixed" and self._has_pages and not self._has_slabs
                            and not self._encdec)
        self.active: List[Optional[Request]] = [None] * self.slots
        self.queue: List[Request] = []
        self.preempted: List[_Spill] = []
        self.finished: List[Request] = []
        self.free_pages: List[int] = list(range(self._n_pages))
        # frozen logical ids: _frozen_base + row of the *_fz stores
        self.free_frozen: List[int] = [self._frozen_base + i for i in range(self._n_frozen)]
        # page_refs[pid]: slots mapping the page now, over the logical id
        # space (active pool, the never-mapped null page, frozen region)
        self.page_refs = np.zeros(self._n_pages + 1 + self._n_frozen, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        # the leading run of each slot's pages that is shared (registered);
        # the rest is private (refcount 1, writable, spillable)
        self.slot_shared: List[int] = [0] * self.slots
        self._prefix = (kvc.PrefixCache(page) if config.prefix_cache and self._has_pages
                        and not self._has_slabs else None)
        self.page_table = np.full(
            (self.slots, self.pages_per_slot if self._has_pages else 1), self._n_pages, np.int32)
        # slab ownership: slab_table[slot] is the slot's slab, or the null
        # slab (index _n_slabs) that inactive rows share
        self.free_slabs: List[int] = list(range(self._n_slabs))
        self.slot_slab: List[int] = [-1] * self.slots
        self.slab_table = np.full(self.slots, self._n_slabs, np.int32)
        self.slot_cross: List[List[int]] = [[] for _ in range(self.slots)]
        self.cross_table = np.full((self.slots, max(1, self._cross_pp)), self._n_pages, np.int32)
        self.enc_lengths = np.zeros(self.slots, np.int32)
        self.lengths = np.zeros(self.slots, np.int32)
        self._slot_seq = [0] * self.slots  # arrival sequence of the occupant
        self._slot_since = [0] * self.slots  # step admitted or resumed (cooldown)
        self.stats = {"steps": 0, "slot_steps": 0, "decoded_tokens": 0, "prefill_tokens": 0,
                      "programs": 0, "preemptions": 0, "resumes": 0, "pages_stolen": 0,
                      "spill_evictions": 0, "resume_fallbacks": 0, "truncated": 0,
                      "failed": 0, "spill_integrity_failures": 0, "prefix_hit_pages": 0,
                      "prefix_hit_tokens": 0, "prefix_reclaims": 0, "fp4_frozen_pages": 0}
        # distinct (padded chunk length, table width) prefill shapes
        self.prefill_traces: set = set()
        self._submit_seq = 0
        self._step_no = 0  # decode steps: the clock of nan_logits and deadlines
        # advances on every step() call, decoded or not: the clock of
        # alloc_fail_ticks (a blocked tick always passes)
        self._tick = 0
        self._alloc_faulted = False
        self._spill_bytes = 0
        # per-row sampling arrays: one a slot, and the mixed step's chunk row
        self._samp = smp.slot_arrays(self.slots)
        self._samp_m = smp.slot_arrays(self.slots + 1)
        # emissions for a streaming front-end, buffered only while it listens
        self.collect_events = False
        self._events: List[TokenEvent] = []

    def _build_pools(self, n_pages: int, policy: CachePolicy):
        """The device pools, and ``_units``: one (pool, kind) a pool in the
        reference's unit order (the order of a spill payload's parts), the
        kind "kv", "cross" or "slab". Every leaf is (lead, ids + 1, ...):
        the lead axis stacked layers (or the hybrid's shared-block
        invocations), the id axis pages or slabs, the last id the null
        page or null slab. ``pools`` is a list a segment (a page pool, or
        xLSTM's {"mlstm", "slstm"} slab pools), or for the hybrid
        {"mamba": slab pool, "shared_kv": page pool}."""
        cfg, page, dev = self.cfg, self.page_size, self.device

        def slabs(one: Dict, lead: int) -> Dict:
            return {name: leaf[None].repeat(lead, *[1] * leaf.dim()) for name, leaf in one.items()}

        self._units: List[Tuple[Dict, str]] = []
        if api._is_hybrid(cfg):
            from repro_torch.models.hybrid import n_attn_invocations

            mamba = slabs(init_mamba2_cache(cfg, self._n_slabs + 1, dev), cfg.n_layers)
            self.pools = {"mamba": mamba}
            self._units.append((mamba, "slab"))
            n_inv = n_attn_invocations(cfg)
            if n_inv:
                self.pools["shared_kv"] = kvc.init_gqa_pool(
                    n_inv, n_pages, page, cfg.n_kv_heads, cfg.resolved_head_dim, policy.active,
                    device=dev)
                self._units.append((self.pools["shared_kv"], "kv"))
            return
        frozen_fmt = policy.frozen if policy.mixed else None
        self.pools = []
        for seg in segments_for(cfg):
            if seg.mixer == "xlstm_pair":
                pool = {name: slabs(init(cfg, self._n_slabs + 1, dev), seg.count)
                        for name, init in (("mlstm", init_mlstm_cache),
                                           ("slstm", init_slstm_cache))}
                self._units += [(pool["mlstm"], "slab"), (pool["slstm"], "slab")]
            elif seg.mixer == "mla":  # latent pages: c_kv and the shared rope key
                pool = kvc.init_mla_pool(seg.count, n_pages, page, cfg.mla.kv_lora_rank,
                                         cfg.mla.qk_rope_dim, policy.active, frozen_fmt,
                                         self._n_frozen, device=dev)
                self._units.append((pool, "kv"))
            else:
                pool = kvc.init_gqa_pool(seg.count, n_pages, page, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, policy.active, frozen_fmt,
                                         self._n_frozen, device=dev)
                self._units.append((pool, "kv"))
            self.pools.append(pool)
        if self._encdec:  # the write-once cross pages, indexed by the same page ids
            self.cross_pool = kvc.init_cross_pool(cfg.n_layers, n_pages, page, cfg.n_kv_heads,
                                                  cfg.resolved_head_dim, policy.cross, device=dev)
            self._units.append((self.cross_pool, "cross"))

    @property
    def engine(self) -> str:
        """The resolved step architecture: "alternating" where the mixed
        engine was asked for a family it does not serve (recurrent slabs,
        enc-dec), as in the reference."""
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
        anything is stolen). In a mixed-precision pool every registered page
        is frozen-class, which no private allocation can use. An injected
        allocator fault reports 0 for its tick."""
        if self._alloc_faulted:
            return 0
        n = len(self.free_pages)
        if self._prefix is not None and not self._mixed_precision:
            n += self._prefix.n_reusable
        return n

    def _take_page(self) -> int:
        """One blank active page: the free list first, then the least
        recently parked registered page (never in a mixed-precision pool).
        Callers check ``_free_capacity`` (or steal) first."""
        if self.free_pages:
            return self.free_pages.pop(0)
        assert not self._mixed_precision, "allocator called with zero free capacity"
        pid = self._prefix.reclaim()
        assert pid is not None, "allocator called with zero free capacity"
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
        assert not self.slot_pages[slot]
        for pid in pids:
            if self.page_refs[pid] == 0:
                self._prefix.unpark(pid)
            self.page_refs[pid] += 1
        self.slot_pages[slot] = list(pids)
        self.slot_shared[slot] = len(pids)
        self.page_table[slot, :len(pids)] = pids

    def _alloc(self, slot: int, npg: int) -> List[int]:
        ids = [self._take_page() for _ in range(npg)]
        for pid in ids:
            self.page_refs[pid] += 1
        self.slot_pages[slot].extend(ids)
        owned = self.slot_pages[slot]
        self.page_table[slot, :len(owned)] = owned
        return ids

    def _alloc_cross(self, slot: int) -> List[int]:
        """The write-once cross pages of an enc-dec request's encoder
        sequence, from the same free list."""
        ids = [self._take_page() for _ in range(self._cross_pp)]
        for pid in ids:
            self.page_refs[pid] += 1
        self.slot_cross[slot] = ids
        self.cross_table[slot, :len(ids)] = ids
        return ids

    def _alloc_slab(self, slot: int, reset: bool = True) -> int:
        """Give ``slot`` the first free slab; with ``reset`` write the
        pristine state into it (a resume restores its spill there instead)."""
        sid = self.free_slabs.pop(0)
        self.slot_slab[slot] = sid
        self.slab_table[slot] = sid
        if reset:
            for ui, (pool, kind) in enumerate(self._units):
                if kind == "slab":
                    for name, init in self._slab_init[ui].items():
                        pool[name][:, sid:sid + 1] = init
        return sid

    def _ids(self, pids: List[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pids, np.int64)).to(self.device)

    def _release_slot(self, slot: int):
        """Drop every page mapping of ``slot`` (its cross pages too), free
        its slab and clear its row."""
        for pid in self.slot_pages[slot] + self.slot_cross[slot]:
            self._release_page(pid)
        self.slot_pages[slot] = []
        self.slot_cross[slot] = []
        self.slot_shared[slot] = 0
        self.page_table[slot] = self._null_page
        self.cross_table[slot] = self._null_page
        self.enc_lengths[slot] = 0
        if self.slot_slab[slot] >= 0:
            self.free_slabs.append(self.slot_slab[slot])
            self.slot_slab[slot] = -1
            self.slab_table[slot] = self._n_slabs
        self.lengths[slot] = 0
        self.active[slot] = None

    def _prefix_root(self, req: Request) -> int:
        """The radix root of ``req``'s prefix walks and inserts: the global
        root, or for enc-dec the root of its frames digest."""
        if not self._encdec:
            return kvc._PREFIX_ROOT
        return self._prefix.root_for(req.frames_digest())

    # -- admission -------------------------------------------------------------
    def _worst_case_pages(self, req: Request) -> int:
        """Pages ``req`` can ever hold: prompt + max_new capped at max_seq,
        plus its cross pages (0 for a family without pages)."""
        if not self._has_pages:
            return 0
        return kvc.pages_needed(min(len(req.prompt) + req.max_new, self.max_seq),
                                self.page_size) + self._cross_pp

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
        if self._encdec:
            if req.frames is None:
                raise ValueError(f"request {req.rid}: enc-dec serving needs per-request "
                                 "encoder frames (Request.frames)")
            if req.frames.shape[0] != self.cfg.encoder_seq:
                raise ValueError(f"request {req.rid}: frames length {req.frames.shape[0]} "
                                 f"!= encoder_seq={self.cfg.encoder_seq} (pad the input; "
                                 "the encoder program is fixed-shape)")
        if self._worst_case_pages(req) > self._n_pages:
            raise ValueError(f"request {req.rid}: needs {self._worst_case_pages(req)} pages "
                             f"but the pool has {self._n_pages}; raise pool_pages or shrink "
                             "prompt/max_new")
        req.since = self._step_no
        req.seq = self._submit_seq
        req.t_submit = time.perf_counter()
        self._submit_seq += 1
        self.queue.append(req)  # (since, seq) grows here: the queue stays sorted

    def _enqueue(self, req: Request):
        """Put an evicted request back in the queue at its wait-line place:
        it keeps the (since, seq) it already earned."""
        keys = [(r.since, r.seq) for r in self.queue]
        self.queue.insert(bisect.bisect(keys, (req.since, req.seq)), req)

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            if not (self.preempted or self.queue):
                break
            if not self._admit_one(slot):
                break  # the head of the line waits; nothing overtakes it

    def _slack(self, req: Request) -> float:
        """Steps ``req`` can lose before it misses its deadline (deadline,
        less the step now, less the tokens still to decode). No deadline, or
        one already lost (slack <= 0), is infinite slack."""
        if req.deadline_step is None:
            return math.inf
        slack = req.deadline_step - self._step_no - (req.max_new - len(req.out))
        return slack if slack > 0 else math.inf

    def _pick_victim(self) -> Optional[int]:
        """The steal victim: the lowest priority, then the most deadline
        slack, then the newest arrival. Requests inside the steal cooldown
        are spared unless no other victim exists."""
        cands = [s for s, r in enumerate(self.active) if r is not None]
        if not cands:
            return None
        warm = [s for s in cands if self._step_no - self._slot_since[s] >= self.steal_cooldown]
        return min(warm or cands, key=lambda s: (self.active[s].priority,
                                                 -self._slack(self.active[s]),
                                                 -self._slot_seq[s]))

    def _slab_available(self, want_priority: int) -> bool:
        """True if a slab is free or, under the token budget, one was just
        stolen for a waiter whose priority strictly beats the victim's. The
        reserve policy never preempts: slab exhaustion defers admission."""
        if not self._has_slabs or self.free_slabs:
            return True
        if self.scheduler != "token_budget":
            return False
        victim = self._pick_victim()
        if victim is not None and self.active[victim].priority < want_priority:
            self._preempt(victim)
            return True
        return False

    def _admit_one(self, slot: int) -> bool:
        """Admit the longest-waiting candidate into ``slot``: spills and
        fresh requests share one wait line keyed on (since, seq), and its
        head is never overtaken while it does not fit (in pages, or in
        slabs that cannot be stolen for it)."""
        any_active = any(r is not None for r in self.active)
        free = self._free_capacity()
        page = self.page_size
        spill = None
        if self.scheduler == "token_budget" and self.preempted:
            spill = min(self.preempted, key=lambda sp: (sp.req.since, sp.req.seq))
        fresh = self.queue[0] if self.queue else None
        if spill is not None and fresh is not None and \
                (fresh.since, fresh.seq) < (spill.req.since, spill.req.seq):
            spill = None  # the fresh head has waited longer
        if spill is not None:
            req = spill.req
            shared_pids: List[int] = []
            if spill.shared_pages:
                ctx = list(req.prompt) + list(req.out[:-1])
                shared_pids = self._prefix.walk(ctx, max_pages=spill.shared_pages,
                                                root=self._prefix_root(req))
                if len(shared_pids) < spill.shared_pages:
                    # part of the shared prefix was reclaimed meanwhile: the
                    # private bytes no longer abut it, re-prefill the tail
                    self.stats["resume_fallbacks"] += 1
                    self._evict_spill(spill)
                    return self._admit_one(slot)
            need = 0
            if self._has_pages:
                free -= self._parked_among(shared_pids)
                need = min(kvc.pages_needed(spill.ctx_len, page) - spill.shared_pages
                           + self.headroom_pages,
                           self._worst_case_pages(req) - self._cross_pp - spill.shared_pages)
                need += self._cross_pp
                if free - need < (self.resume_watermark if any_active else 0):
                    return False
            if not self._slab_available(req.priority):
                return False
            if kvc.payload_checksum(spill.payload) != spill.crc:
                # the bytes rotted while spilled: re-prefill instead of
                # restoring garbage into the pool
                self.stats["spill_integrity_failures"] += 1
                self._evict_spill(spill)
                return self._admit_one(slot)
            self.preempted.remove(spill)
            self._spill_bytes -= spill.nbytes
            self._resume(slot, spill, shared_pids, need - self._cross_pp)
            return True
        if fresh is None:
            return False
        req = fresh
        ctx = req.resume_ctx if req.resume_ctx is not None else req.prompt
        n = len(ctx)
        hits: List[int] = []
        if self._prefix is not None:
            # the last context token always streams (its logits seed
            # decode), which also keeps the boundary page private
            hits = self._prefix.walk(ctx, max_pages=(n - 1) // page,
                                     root=self._prefix_root(req))
        need = 0
        if self._has_pages:
            free -= self._parked_among(hits)
            if self.scheduler == "reserve":
                need = self._worst_case_pages(req) - len(hits)
                if free < need:
                    return False
            else:
                need = min(kvc.pages_needed(n, page) - len(hits) + self.headroom_pages,
                           self._worst_case_pages(req) - self._cross_pp - len(hits))
                need += self._cross_pp
                if free - need < (self.low_watermark if any_active else 0):
                    return False
        if not self._slab_available(req.priority):
            return False
        self.queue.pop(0)
        self.active[slot] = req
        self._slot_seq[slot] = req.seq
        self._slot_since[slot] = self._step_no
        if hits:
            self._map_shared(slot, hits)
            self.lengths[slot] = len(hits) * page
            self.stats["prefix_hit_pages"] += len(hits)
            self.stats["prefix_hit_tokens"] += len(hits) * page
        self._alloc(slot, need - self._cross_pp)
        if self._encdec:
            self._alloc_cross(slot)
        if self._has_slabs:
            self._alloc_slab(slot)
        if not self._mixed_step:
            self._prefill_slot(slot, req)
            return True
        if self._prefix is not None:
            # the mixed engine streams the context in later steps; its write
            # set is this slot's private pages from the first unshared one
            self._prefix.assert_unfrozen(
                self.slot_pages[slot][int(self.lengths[slot]) // page: kvc.pages_needed(n, page)],
                frozen_base=self._frozen_base)
        # the mixed step reads the stream from the request (prompt + out[:-1])
        req.resume_ctx = None
        return True

    # -- streaming paged prefill -------------------------------------------------
    def _chunk_plan(self, slot: int, n: int, pos: int, budget: int):
        """One prefill chunk at stream position ``pos`` of an ``n``-token
        context: true length ``take``, power-of-two padded length, the
        power-of-two table width ``w`` and the (1, w) table. Only pages
        holding data up to the chunk's true end are mapped; the pad
        overhang points at the null page. A slab family's chunk is its
        exact length over the pages it fills (one null entry without
        pages)."""
        page = self.page_size
        take = min(budget, n - pos)
        if self._bucket_prefill:
            padded = min(_next_pow2(take), budget)
            w = _next_pow2(pos // page + kvc.pages_needed(padded, page))
        else:
            padded = take
            w = kvc.pages_needed(pos + take, page) if self._has_pages else 1
        own = self.slot_pages[slot]
        table = np.full((1, w), self._null_page, np.int32)
        m = min(w, len(own), kvc.pages_needed(pos + take, page))
        table[0, :m] = own[:m]
        return take, padded, w, table

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32)).to(self.device)

    def _state(self, table, lengths, rows, chunk_len=None) -> kvc.PagedState:
        """The step's PagedState; for enc-dec with ``rows``' cross tables
        and encoder lengths, for a slab family with their slab ids."""
        return kvc.PagedState(
            self._tensor(table), self._tensor(lengths),
            chunk_len=None if chunk_len is None else self._tensor(chunk_len),
            cross_table=self._tensor(self.cross_table[rows]) if self._encdec else None,
            enc_lengths=self._tensor(self.enc_lengths[rows]) if self._encdec else None,
            slabs=self._tensor(self.slab_table[rows]) if self._has_slabs else None)

    def _run(self, tokens, state, pmask: Optional[np.ndarray] = None) -> torch.Tensor:
        """One program; ``pmask`` (a bool per logits row) sets the rows a
        fault plan poisons to NaN, upstream of the callers' isfinite
        check, so injection runs the real detection path."""
        self.stats["programs"] += 1
        logits = api.decode_step(self.params, self.cfg, self._tensor(tokens), self.pools,
                                 state, a_fmt=self.a_fmt, cross=self.cross_pool)
        if pmask is not None and pmask.any():
            poison = torch.as_tensor(pmask).to(self.device)
            logits = torch.where(poison[:, None], torch.full_like(logits, math.nan), logits)
        return logits

    def _pick(self, logits: torch.Tensor, samp: Optional[dict] = None):
        """Each row's token and whether all its logits are finite. ``samp``
        (``sampling.slot_arrays``, one entry a row): the rows' sampling
        params; a step whose rows are all greedy takes the argmax alone."""
        if samp is None or not (samp["temperature"] > 0).any():
            nxt = smp.greedy_tokens(logits)
        else:
            nxt = smp.sample_tokens(logits, *smp.as_tuple(samp, logits.device))
        return nxt.cpu().numpy(), torch.isfinite(logits).all(-1).cpu().numpy()

    def _prefill_slot(self, slot: int, req: Request):
        """Alternating engine: stream the context (the prompt, or an evicted
        request's prompt and tokens) past the mapped prefix hits, register
        its full prompt pages, and emit the first token of a fresh stream."""
        ctx = req.resume_ctx if req.resume_ctx is not None else list(req.prompt)
        fresh = req.resume_ctx is None
        req.resume_ctx = None
        n, page = len(ctx), self.page_size
        if self._encdec:
            # the encoder runs once per admission, writing the slot's cross pages
            frames = torch.as_tensor(np.asarray(req.frames, np.float32))[None]
            api.encode_cross_pages(self.params, self.cfg, frames, self.cross_pool,
                                   self._tensor(self.cross_table[slot:slot + 1]),
                                   a_fmt=self.a_fmt)
            self.stats["programs"] += 1
            self.enc_lengths[slot] = self.cfg.encoder_seq
        start = pos = int(self.lengths[slot])
        if self._prefix is not None:
            self._prefix.assert_unfrozen(self.slot_pages[slot][start // page:
                                                               kvc.pages_needed(n, page)],
                                         frozen_base=self._frozen_base)
        # the final chunk's draw seeds a fresh stream, at its index len(out)
        samp = smp.slot_arrays(1)
        smp.fill_slot(samp, 0, req.sampling, len(req.out))
        nxt, ok = None, True
        while pos < n:
            take, padded, w, table = self._chunk_plan(slot, n, pos, self.prefill_token_budget)
            toks = [ctx[pos: pos + take] + [0] * (padded - take)]
            state = self._state(table, [pos], slice(slot, slot + 1), chunk_len=[take])
            last = fresh and pos + take == n
            nxt, row_ok = self._pick(self._run(toks, state), samp if last else None)
            ok = ok and bool(row_ok[0])
            self.prefill_traces.add((padded, w))
            pos += take
        self.lengths[slot] = n
        self.stats["prefill_tokens"] += n - start
        if not ok:
            # nothing registered (frozen garbage would poison every later
            # hit) and no seed token
            self._fail_slot(slot, req, f"non-finite logits during prefill of request "
                                       f"{req.rid} ({n} context tokens)", scrub_null=True)
            return
        if self._prefix is not None:
            self._register_prefix(slot, req)
        if fresh:
            self._emit_token(req, int(nxt[0]))

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
            canon = self._prefix.insert(req.prompt[:n_full * page], own[:n_full],
                                        root=self._prefix_root(req))
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
        canon = self._prefix.walk(req.prompt, max_pages=n_full, root=self._prefix_root(req))
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
                for pool in self._unit_pools("kv"):
                    kvc.transcode_page(pool, src, fid - self._frozen_base)
                self.stats["fp4_frozen_pages"] += 1
            self.page_refs[fid] += 1
            own[i] = fid
            self.page_table[slot, i] = fid
            self._release_page(src)
            end = i + 1
        if end > shared:
            self._prefix.insert(req.prompt[:end * page], own[:end], root=self._prefix_root(req))
        self.slot_shared[slot] = end

    # -- preemption by page steal ------------------------------------------------
    def _unit_ids(self, slot: int, kind: str, kv: List[int]) -> torch.Tensor:
        """The ids of ``slot``'s part of a unit of ``kind``: the pages
        ``kv`` of a page pool, its cross pages, or its slab."""
        if kind == "kv":
            return self._ids(kv)
        return self._ids(self.slot_cross[slot] if kind == "cross" else [self.slot_slab[slot]])

    def _unit_pools(self, *kinds: str) -> List[Dict]:
        return [pool for pool, kind in self._units if kind in kinds]

    def _preempt(self, slot: int):
        """Steal this slot's pages and slab: copy its private pages' bytes
        (every pool leaf but the frozen region's, every layer), its cross
        pages and its slab's state to the host under a CRC32, one part a
        unit in the reference's order, and drop every mapping. Shared
        prefix pages are not spilled: they stay in the index (parked if no
        one else maps them)."""
        req = self.active[slot]
        ctx_len = int(self.lengths[slot])
        shared = self.slot_shared[slot]
        priv = self.slot_pages[slot][shared:kvc.pages_needed(ctx_len, self.page_size)]
        payload = [kvc.spill_pages(pool, self._unit_ids(slot, kind, priv))
                   for pool, kind in self._units]
        nbytes = sum(a.nbytes for part in payload for a in part.values())
        # the checksum covers the pristine bytes; the fault hook runs after
        # it (bit rot while spilled, which the resume-time check must catch)
        crc = kvc.payload_checksum(payload)
        if self.faults is not None:
            payload = self.faults.spill_payload(req.rid, payload)
        req.since = self._step_no  # re-enters the wait line now
        self.preempted.append(_Spill(req=req, ctx_len=ctx_len, shared_pages=shared,
                                     payload=payload, nbytes=nbytes, crc=crc,
                                     rng_seed=req.sampling.seed, emitted=len(req.out)))
        self._spill_bytes += nbytes
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.stats["pages_stolen"] += (len(self.slot_pages[slot]) - shared
                                       + len(self.slot_cross[slot]))
        self._release_slot(slot)

    def _evict_spill(self, sp: _Spill):
        """Drop a spill's host bytes and queue its request, at the wait-line
        place it already holds, to re-prefill its context: prompt + out[:-1]
        (the newest token is fed back by the next decode step). A request
        spilled mid-prefill, with no token out yet, re-enters as fresh."""
        self.preempted.remove(sp)
        self._spill_bytes -= sp.nbytes
        req = sp.req
        req.resume_ctx = list(req.prompt) + list(req.out[:-1]) if req.out else None
        req.evictions += 1
        self.stats["spill_evictions"] += 1
        self._enqueue(req)

    def _enforce_spill_budget(self):
        """While spills hold more host bytes than ``spill_budget_bytes``,
        evict the oldest. Runs at the top of a step, never inside
        ``_preempt``, so the budget can overshoot by one round's spills."""
        if self.spill_budget_bytes is None:
            return
        while self._spill_bytes > self.spill_budget_bytes and self.preempted:
            self._evict_spill(min(self.preempted, key=lambda s: (s.req.since, s.req.seq)))

    def _resume(self, slot: int, spill: _Spill, shared_pids: List[int], need: int):
        """Map the walked shared prefix, allocate ``need`` private pages
        (the cross pages, a slab) and write the spilled bytes back into the
        first of them, in place."""
        self.active[slot] = spill.req
        self._slot_seq[slot] = spill.req.seq  # keeps its arrival age
        self._slot_since[slot] = self._step_no
        if shared_pids:
            self._map_shared(slot, shared_pids)
        new = self._alloc(slot, need)
        if self._prefix is not None:  # restore targets must be writable
            self._prefix.assert_unfrozen(new, frozen_base=self._frozen_base)
        if self._encdec:
            self._alloc_cross(slot)
            self.enc_lengths[slot] = self.cfg.encoder_seq
        if self._has_slabs:
            self._alloc_slab(slot, reset=False)  # its spill is written below
        npg_priv = kvc.pages_needed(spill.ctx_len, self.page_size) - spill.shared_pages
        for (pool, kind), part in zip(self._units, spill.payload):
            kvc.restore_pages(pool, part, self._unit_ids(slot, kind, new[:npg_priv]))
        self.lengths[slot] = spill.ctx_len
        # the next draw's key is recomputed from the request; the spill's
        # copy of the stream position must agree with it
        assert spill.rng_seed == spill.req.sampling.seed
        assert spill.emitted == len(spill.req.out), (
            f"request {spill.req.rid}: spill recorded {spill.emitted} emitted tokens but the "
            f"request holds {len(spill.req.out)}: the resumed RNG stream would diverge")
        self.stats["resumes"] += 1

    def _steal(self) -> bool:
        """Preempt the victim ``_pick_victim`` names (the row that needs
        the page is a candidate too)."""
        victim = self._pick_victim()
        if victim is None:
            return False
        self._preempt(victim)
        return True

    # -- the mixed engine ------------------------------------------------------
    @staticmethod
    def _ctx_target(req: Request) -> int:
        """The KV length at which ``req`` is prefilled and decoding: its
        prompt plus every emitted token but the newest."""
        return len(req.prompt) + max(len(req.out) - 1, 0)

    def _extend_shared(self, slot: int, ctx: List[int]):
        """At the start of a stream, adopt prefix pages a sibling stream
        registered after this request's admission: each maps over the
        private page allocated for the same position (released), or is
        appended where a resume restored fewer pages, and the stream
        starts past them."""
        page = self.page_size
        shared = self.slot_shared[slot]
        hits = self._prefix.walk(ctx, max_pages=(len(ctx) - 1) // page,
                                 root=self._prefix_root(self.active[slot]))
        if len(hits) <= shared:
            return
        own = self.slot_pages[slot]
        for i in range(shared, len(hits)):
            pid = hits[i]
            if self.page_refs[pid] == 0:
                self._prefix.unpark(pid)
            self.page_refs[pid] += 1
            if i < len(own):
                self._release_page(own[i])
                own[i] = pid
            else:
                own.append(pid)
            self.page_table[slot, i] = pid
        self.slot_shared[slot] = len(hits)
        self.lengths[slot] = len(hits) * page
        self.stats["prefix_hit_pages"] += len(hits) - shared
        self.stats["prefix_hit_tokens"] += (len(hits) - shared) * page

    def _grow_for_chunk(self, slot: int):
        """Make sure ``slot`` owns every page its next chunk writes: fresh
        admission allocated the whole context, a request resumed
        mid-prefill only the pages it had written. Reclaim, then steal (the
        needer itself is a candidate)."""
        while self.active[slot] is not None:
            end = min(int(self.lengths[slot]) + self.prefill_token_budget,
                      self._ctx_target(self.active[slot]))
            if kvc.pages_needed(end, self.page_size) <= len(self.slot_pages[slot]):
                break
            if self._free_capacity():
                self._alloc(slot, 1)
            elif not self._steal():
                break

    def _pick_prefill_slot(self) -> Optional[int]:
        """The mid-prefill slot that has waited longest (the wait line's
        key), or None when every active row is decoding."""
        mid = [s for s, r in enumerate(self.active)
               if r is not None and int(self.lengths[s]) < self._ctx_target(r)]
        return min(mid, key=lambda s: (self.active[s].since, self.active[s].seq)) if mid else None

    # -- decode ------------------------------------------------------------------
    def _grow(self):
        """Allocate a page for every active row whose next token crosses
        into an unallocated page, higher priority first, then arrival:
        reclaim parked pages first and steal only when none is left."""
        if not self._has_pages:
            return
        order = sorted((s for s, r in enumerate(self.active) if r is not None),
                       key=lambda s: (-self.active[s].priority, self._slot_seq[s]))
        for slot in order:
            while self.active[slot] is not None:
                if int(self.lengths[slot]) // self.page_size < len(self.slot_pages[slot]):
                    break
                if self._free_capacity():
                    self._alloc(slot, 1)
                elif not self._steal():
                    break

    def _emit_token(self, req: Request, token: int):
        t = time.perf_counter()
        req.out.append(token)
        req.token_times.append(t)
        if self.collect_events:
            self._events.append(TokenEvent(rid=req.rid, token=token, index=len(req.out) - 1, t=t))

    def _emit_finished(self, req: Request):
        if self.collect_events:
            self._events.append(TokenEvent(rid=req.rid, token=None, index=len(req.out),
                                           t=time.perf_counter(), finished=True,
                                           status=req.status))

    def pop_events(self) -> List[TokenEvent]:
        """Drain the buffered emissions (empty unless ``collect_events`` is
        on): one event a token in emission order, and a terminal event for
        every retirement (ok, truncated or failed)."""
        ev, self._events = self._events, []
        return ev

    def step(self) -> bool:
        """One engine step: admit what fits, grow (stealing where the pool
        is dry), then decode one token for every decoding slot; the mixed
        engine also carries the next prefill chunk of one mid-prefill
        request. Returns False when nothing is active."""
        self._tick += 1
        self._alloc_faulted = self.faults is not None and self.faults.alloc_blocked(self._tick)
        self._enforce_spill_budget()
        self._admit()
        if self.scheduler == "token_budget":
            self._grow()
        pf_slot = self._pick_prefill_slot() if self._mixed_step else None
        if pf_slot is not None:
            r = self.active[pf_slot]
            if (self._prefix is not None
                    and int(self.lengths[pf_slot]) == self.slot_shared[pf_slot] * self.page_size):
                self._extend_shared(pf_slot, list(r.prompt) + list(r.out[:-1]))
            self._grow_for_chunk(pf_slot)
            pf_slot = self._pick_prefill_slot()  # a steal may have taken it
        if not any(r is not None for r in self.active):
            return False
        self._step_no += 1
        self.stats["steps"] += 1
        decoding = [s for s, r in enumerate(self.active)
                    if r is not None and int(self.lengths[s]) >= self._ctx_target(r)]
        self.stats["slot_steps"] += len(decoding)
        if self._prefix is not None:
            # copy-on-write: the page each row's write lands on next (its
            # boundary page; a mid-prefill row's next chunk page) is private
            self._prefix.assert_unfrozen(
                (self.slot_pages[s][int(self.lengths[s]) // self.page_size]
                 for s, r in enumerate(self.active) if r is not None),
                frozen_base=self._frozen_base)
        pmask = self.faults.poison_rows(self._step_no, self.slots) if self.faults else None
        if pf_slot is not None:
            self._step_mixed(pf_slot, decoding, pmask)
        else:
            self._step_decode(pmask)
        if self.audit_every and self._step_no % self.audit_every == 0:
            self.audit()
        return True

    def _step_decode(self, pmask):
        """Every active row is at its context target and decodes one token."""
        tok = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None and req.out:
                tok[s, 0] = req.out[-1]
            if req is not None:
                # the draw's RNG index is the tokens emitted so far, read off
                # the request each step: it survives steals and resumes
                smp.fill_slot(self._samp, s, req.sampling, len(req.out))
            else:
                smp.clear_slot(self._samp, s)
        state = self._state(self.page_table, self.lengths, slice(None))
        nxt, ok = self._pick(self._run(tok, state, pmask), self._samp)
        for s, req in enumerate(self.active):
            if req is not None:
                self._finish_decode_row(s, req, ok[s], nxt[s], pmask)

    def _finish_decode_row(self, s: int, req: Request, ok: bool, nxt, pmask):
        """Emit and maybe retire; a non-finite row quarantines its request
        alone (its token is never appended)."""
        if not ok:
            if pmask is not None and pmask[s]:
                self.faults.note_nan(self._step_no, s, req.rid)
            self._fail_slot(s, req, f"non-finite logits at decode step {self._step_no} "
                                    f"(slot {s})")
            return
        self._emit_token(req, int(nxt))
        self.lengths[s] += 1
        self.stats["decoded_tokens"] += 1
        if len(req.out) >= req.max_new or self.lengths[s] >= self.max_seq - 1:
            if len(req.out) < req.max_new:
                req.status = "truncated"
                self.stats["truncated"] += 1
            self._retire(s, req)

    def _step_mixed(self, pf_slot: int, decoding: List[int], pmask):
        """One program: every decoding row's next token plus the next chunk
        of ``pf_slot``'s prompt, as the fused row ``(1, slots + padded)``.
        Non-decoding slots (``pf_slot`` among them) ride with lengths 0, so
        their decode-lane appends go to the null page. Logits come back
        ``(slots + 1, V)``: one row per slot, then the chunk's last token,
        which inherits ``pf_slot``'s poison."""
        req = self.active[pf_slot]
        ctx = list(req.prompt) + list(req.out[:-1])
        n, pos = len(ctx), int(self.lengths[pf_slot])
        take, padded, w, table = self._chunk_plan(pf_slot, n, pos, self.prefill_token_budget)
        is_decoding = np.zeros(self.slots, bool)
        is_decoding[decoding] = True
        tok = np.zeros((1, self.slots + padded), np.int32)
        for s in range(self.slots):
            if is_decoding[s]:
                tok[0, s] = self.active[s].out[-1]
                smp.fill_slot(self._samp_m, s, self.active[s].sampling, len(self.active[s].out))
            else:
                smp.clear_slot(self._samp_m, s)
        tok[0, self.slots: self.slots + take] = ctx[pos: pos + take]
        # the chunk row draws at index len(out): a fresh stream's final chunk
        # emits it as the seed token; any other chunk's draw is discarded
        smp.fill_slot(self._samp_m, self.slots, req.sampling, len(req.out))
        pre = kvc.PagedState(self._tensor(table), self._tensor([pos]),
                             chunk_len=self._tensor([take]))
        state = kvc.PagedState(self._tensor(self.page_table),
                               self._tensor(np.where(is_decoding, self.lengths, 0)),
                               prefill=pre)
        rows = None if pmask is None else np.concatenate([pmask, pmask[pf_slot:pf_slot + 1]])
        nxt, ok = self._pick(self._run(tok, state, rows), self._samp_m)
        self.prefill_traces.add((padded, w))
        self.lengths[pf_slot] = pos + take
        self.stats["prefill_tokens"] += take
        if not ok[self.slots]:
            if pmask is not None and pmask[pf_slot]:
                self.faults.note_nan(self._step_no, pf_slot, req.rid)
            self._fail_slot(pf_slot, req, f"non-finite logits during prefill of request "
                                          f"{req.rid} ({n} context tokens)", scrub_null=True)
        elif pos + take == n:
            if self._prefix is not None:
                self._register_prefix(pf_slot, req)
            if not req.out:  # the final chunk's token seeds decode
                self._emit_token(req, int(nxt[self.slots]))
        for s in decoding:
            if self.active[s] is not None:
                self._finish_decode_row(s, self.active[s], ok[s], nxt[s], pmask)

    def _retire(self, slot: int, req: Request):
        """Free the slot and release its pages (registered ones park).
        Pages are not zeroed: a recycled page is overwritten by the next
        prefill, and decode appends zero the positions past the new owner's
        length before requantizing."""
        req.done = True
        self.finished.append(req)
        self._emit_finished(req)
        self._release_slot(slot)

    # -- request-level failure isolation -----------------------------------------
    def _scrub_slot(self, slot: int, include_null: bool = False):
        """Zero the private pages, cross pages and slab of a quarantined
        row, and the null page where a failing prefill's padded overhang
        wrote it: NaN codes would survive attention's zero weights (0 * NaN
        = NaN) and fail healthy rows that later read the recycled page.
        Registered pages were frozen by a healthy prefill and are left
        alone, as is the frozen region (the transcode is its only writer).
        The null slab is not scrubbed: it is never read as live state (a
        slab is reset when it is allocated)."""
        priv = list(self.slot_pages[slot][self.slot_shared[slot]:])
        if include_null:
            priv.append(self._null_page)
        for pool, kind in self._units:
            if kind == "slab" and self.slot_slab[slot] < 0:
                continue
            ids = self._unit_ids(slot, kind, priv)
            if not ids.numel():
                continue
            for name, leaf in pool.items():
                if "_fz" not in name and leaf.numel():
                    leaf[:, ids] = 0

    def _fail_slot(self, slot: int, req: Request, error: str, scrub_null: bool = False):
        """Quarantine one active row: scrub what it wrote, mark it failed
        and retire it; every other row keeps decoding."""
        self._scrub_slot(slot, include_null=scrub_null)
        req.status = "failed"
        req.error = error
        self.stats["failed"] += 1
        self._retire(slot, req)

    def _fail_request(self, req: Request, error: str):
        """Fail a request that holds no pool state (queued or spilled)."""
        req.status = "failed"
        req.error = error
        req.done = True
        self.stats["failed"] += 1
        self.finished.append(req)
        self._emit_finished(req)

    def _fail_pending(self, reason: str):
        """Non-strict starvation: fail every queued and spilled request one
        by one (dropping spill bytes); active rows keep decoding."""
        for sp in list(self.preempted):
            self.preempted.remove(sp)
            self._spill_bytes -= sp.nbytes
            self._fail_request(sp.req, reason)
        for req in list(self.queue):
            self.queue.remove(req)
            self._fail_request(req, reason)

    def _pages_for(self, n: int) -> int:
        """Pages (with cross pages) a context of ``n`` tokens holds."""
        return kvc.pages_needed(n, self.page_size) + self._cross_pp if self._has_pages else 0

    def _pending_diagnostics(self) -> List[Dict]:
        """One dict per request still waiting or running, for ServingError."""
        diag = []
        for req in self.queue:
            ctx = req.resume_ctx if req.resume_ctx is not None else req.prompt
            diag.append({"rid": req.rid, "state": "queued", "since": req.since,
                         "out_tokens": len(req.out), "ctx_len": len(ctx),
                         "pages_needed": self._pages_for(len(ctx))})
        for sp in self.preempted:
            diag.append({"rid": sp.req.rid, "state": "spilled", "since": sp.req.since,
                         "out_tokens": len(sp.req.out), "ctx_len": sp.ctx_len,
                         "pages_needed": self._pages_for(sp.ctx_len),
                         "spill_bytes": sp.nbytes})
        for s, req in enumerate(self.active):
            if req is not None:
                diag.append({"rid": req.rid, "state": "active", "slot": s,
                             "out_tokens": len(req.out), "ctx_len": int(self.lengths[s])})
        return diag

    def run_until_drained(self, max_steps: int = 10_000) -> List[RequestResult]:
        """Step until the queue, the spills and the slots are empty; returns
        the results of the requests finished during this call, in
        retirement order. When a step makes no progress while work waits,
        ``strict`` raises ``ServingError`` (with the finished results and
        per-request diagnostics), else the waiting requests fail one by one
        and the drain goes on. A step blocked only by an injected allocator
        fault is not starvation."""
        start = len(self.finished)
        for _ in range(max_steps):
            if self.step():
                continue
            if not self.queue and not self.preempted:
                break
            if self._alloc_faulted:
                continue
            msg = (f"serving starved: {len(self.queue)} queued + {len(self.preempted)} "
                   f"preempted request(s) cannot be (re)admitted with "
                   f"{self._free_capacity()}/{self._n_pages} allocatable pool pages (incl. "
                   f"reusable cached) and {len(self.free_slabs)}/{self._n_slabs} slabs free and "
                   "no active work to retire: the pool is too small for the waiting context "
                   "(or pages leaked)")
            if not self.strict:
                self._fail_pending(msg)
                continue
            raise ServingError(msg, finished=[r.result() for r in self.finished[start:]],
                               pending=self._pending_diagnostics())
        else:
            pending = (len(self.queue) + len(self.preempted)
                       + sum(r is not None for r in self.active))
            if pending:
                raise ServingError(f"run_until_drained: max_steps={max_steps} exhausted "
                                   f"with {pending} request(s) still pending",
                                   finished=[r.result() for r in self.finished[start:]],
                                   pending=self._pending_diagnostics())
        return [r.result() for r in self.finished[start:]]

    # -- accounting ------------------------------------------------------------
    def audit(self) -> Dict:
        """The pool ownership audit: refcounts equal table occupancy; the
        mapped, parked and free sets are disjoint and cover the pool (no
        leak, no double free); the page table mirrors the slot lists; each
        slot holds a leading run of registered shared pages and then
        private pages (refcount 1, unregistered, active-class); no active
        row's boundary page is frozen; slabs are owned by one slot each,
        owned and free slabs partition the slab pool (the null slab in
        neither) and the slab table mirrors ownership. Raises ``PoolCorruptionError`` with
        every violation and a state dump, else returns a summary."""
        v: List[str] = []
        base = self._frozen_base
        all_ids = list(range(self._n_pages)) + list(range(base, base + self._n_frozen))
        mapped = Counter()
        for ids in self.slot_pages + self.slot_cross:
            mapped.update(ids)
        for pid in all_ids:
            if self.page_refs[pid] != mapped.get(pid, 0):
                v.append(f"page {pid}: refcount {int(self.page_refs[pid])} "
                         f"!= {mapped.get(pid, 0)} table mappings")
        free = self.free_pages + self.free_frozen
        parked = self.reusable_pages
        if len(free) != len(set(free)):
            v.append(f"double-freed pages in the free lists: {free}")
        if any(pid >= base for pid in self.free_pages) or \
                any(pid < base for pid in self.free_frozen):
            v.append(f"free-list class mixup: active {self.free_pages} / "
                     f"frozen {self.free_frozen} (frozen base {base})")
        for kind_a, kind_b, inter in (("mapped", "free", set(mapped) & set(free)),
                                      ("mapped", "parked", set(mapped) & set(parked)),
                                      ("free", "parked", set(free) & set(parked))):
            if inter:
                v.append(f"pages both {kind_a} and {kind_b}: {sorted(inter)}")
        if sorted(set(mapped) | set(free) | set(parked)) != sorted(all_ids):
            lost = set(all_ids) - set(mapped) - set(free) - set(parked)
            v.append(f"pages leaked from the pool: {sorted(lost)}")
        for slot, ids in enumerate(self.slot_pages):
            if not np.array_equal(self.page_table[slot, :len(ids)], ids):
                v.append(f"slot {slot}: page table "
                         f"{self.page_table[slot, :len(ids)].tolist()} != owned pages {ids}")
            for i, pid in enumerate(ids):
                if i < self.slot_shared[slot]:
                    if self._prefix is None or not self._prefix.registered(pid):
                        v.append(f"slot {slot}: shared page {pid} not registered in the "
                                 "prefix index")
                    if self._mixed_precision and pid < base:
                        v.append(f"slot {slot}: shared page {pid} is active-class in a "
                                 "mixed-precision pool (freeze-time transcode missed it)")
                else:
                    if self.page_refs[pid] != 1:
                        v.append(f"slot {slot}: private page {pid} has refcount "
                                 f"{int(self.page_refs[pid])} (copy-on-write violated)")
                    if self._prefix is not None and self._prefix.registered(pid):
                        v.append(f"slot {slot}: private page {pid} is registered (would be "
                                 "written while shared-frozen)")
                    if pid >= base:
                        v.append(f"slot {slot}: private page {pid} is a frozen FP4 logical "
                                 "id — no write path may own a packed page")
        for slot, ids in enumerate(self.slot_cross):
            for pid in ids:
                if pid >= base:
                    v.append(f"slot {slot}: cross page {pid} is a frozen FP4 logical id (cross "
                             "pages live in their own write-once pool)")
        if self._prefix is not None:
            for s, req in enumerate(self.active):
                if req is None:
                    continue
                bidx = int(self.lengths[s]) // self.page_size
                if bidx < len(self.slot_pages[s]) and \
                        self._prefix.registered(self.slot_pages[s][bidx]):
                    v.append(f"slot {s}: boundary (write-target) page "
                             f"{self.slot_pages[s][bidx]} is frozen")
        owned = [sid for sid in self.slot_slab if sid >= 0]
        if len(owned) != len(set(owned)):
            v.append(f"slab double-owned: {owned}")
        if sorted(owned + self.free_slabs) != list(range(self._n_slabs)):
            v.append(f"slabs leaked: owned {sorted(owned)} + free {sorted(self.free_slabs)} "
                     f"!= 0..{self._n_slabs - 1}")
        for slot in range(self.slots):
            want = self.slot_slab[slot] if self.slot_slab[slot] >= 0 else self._n_slabs
            if int(self.slab_table[slot]) != want:
                v.append(f"slot {slot}: slab table {int(self.slab_table[slot])} != owned {want}")
        if v:
            raise PoolCorruptionError(v, {
                "step": self._step_no, "tick": self._tick,
                "page_refs": self.page_refs.tolist(),
                "slot_pages": [list(p) for p in self.slot_pages],
                "slot_cross": [list(p) for p in self.slot_cross],
                "slot_shared": list(self.slot_shared),
                "free_pages": list(self.free_pages),
                "free_frozen": list(self.free_frozen),
                "parked_pages": list(parked),
                "slot_slab": list(self.slot_slab),
                "free_slabs": list(self.free_slabs),
                "lengths": self.lengths.tolist(),
                "active_rids": [r.rid if r is not None else None for r in self.active]})
        return {"step": self._step_no, "pages_mapped": len(mapped), "pages_free": len(free),
                "pages_parked": len(parked),
                "frozen_mapped": sum(1 for pid in mapped if pid >= base),
                "frozen_free": len(self.free_frozen),
                "slabs_owned": len(owned), "slabs_free": len(self.free_slabs),
                "active": sum(r is not None for r in self.active), "violations": 0}

    def utilization(self) -> float:
        """Mean share of the slots that decoded a token per engine step."""
        if not self.stats["steps"]:
            return 0.0
        return self.stats["slot_steps"] / (self.stats["steps"] * self.slots)

    def engine_utilization(self) -> float:
        """Decoded tokens per program, over the slot count: what the mixed
        engine raises over the alternating one, whose prefill chunks run
        programs that decode nothing."""
        if not self.stats["programs"]:
            return 0.0
        return self.stats["decoded_tokens"] / (self.stats["programs"] * self.slots)

    def _page_pools(self) -> List[Dict]:
        """The self-attention pools, then the cross pool (enc-dec); none
        for a family of slabs alone."""
        return self._unit_pools("kv", "cross")

    def kv_bytes_per_token(self) -> float:
        """Active-pool bytes per token slot across the layer stack (cross
        pages included)."""
        return sum(kvc.pool_bytes_per_token(p) for p in self._page_pools())

    def kv_bf16_bytes_per_token(self) -> float:
        """What the same pools would cost per token holding bf16 values."""
        return sum(kvc.bf16_bytes_per_token(p) for p in self._page_pools())

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
        active_pb = sum(kvc.page_bytes(p) for p in self._page_pools())
        frozen_pb = sum(kvc.page_bytes(p, frozen=True) for p in self._page_pools())
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
