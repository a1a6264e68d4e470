"""Quantized paged KV pool and the shared-prefix index (port of
``repro.runtime.kv_cache``).

Layout (one pool dict per model segment, leading dim = stacked layers):

  GQA:  k/v        (L, P+1, page, KV, hd)  uint8 FP8 E4M3 codes | bf16 values
        k/v_smax   (L, P+1)                f32   per-page full-precision S_max
        k/v_shift  (L, P+1, KV)            int32 per-(page, head) M2 shifts
  MLA:  ckv        (L, P+1, page, r)       the compressed latent and the
        krope      (L, P+1, page, dr)      shared rope key, no head axis;
                                           their smax/shift have a single
                                           scale "head": (L, P+1), (L, P+1, 1)

Page ids are global across layers; the last id (P) is the reserved null
page that idle rows write to. FP8 scales are amax / 480 per (page, head),
M2-constrained across the page's heads with floor rounding (never
saturates), so decode applies them as an exponent add plus one s_max
multiply per page.

Mixed precision (``CachePolicy(frozen_fmt="fp4_e2m1")``): the pool grows a
frozen region of half-width packed FP4 E2M1 stores (``k_fz``/``v_fz``, two
codes per byte, low nibble first, with their own ``*_fz_smax`` and
``*_fz_shift``) of ``n_frozen`` pages plus one dummy row that clamped reads
land on. Frozen logical ids share the id space above the active store: id
``(P+1) + fidx`` addresses frozen row ``fidx``. A page enters the region
exactly once, through ``transcode_page`` when the prefix cache freezes it,
and is read-only afterwards.

Unlike the reference, whose arrays are immutable, the write paths here
(``splice_prefill``, ``append_paged``, ``append_prefill_chunk``,
``transcode_page``) update the
pool leaves in place: copying the whole pool for every layer of every step
would cost far more than the step. They return the (same) dict, so callers
read as in the reference. In place also means a write to a page that other
rows share corrupts them without any error, so the serving engine checks
every write set with ``PrefixCache.assert_unfrozen`` where the reference
does.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from collections import OrderedDict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import f32, fp_encode, pack_nibbles, quantize_to_grid
from repro_torch.core.scales import constrain_scales_m2
from repro_torch.device import resolve_device
from repro_torch.kernels.common import PageFormat, page_format

__all__ = ["CachePolicy", "PagedState", "PrefixCache", "page_key", "init_gqa_pool",
           "init_cross_pool", "write_cross_pages", "init_mla_pool", "pool_keys", "pool_format", "frozen_format", "n_frozen_pages", "quantize_pages",
           "dequantize_pages", "transcode_page", "splice_prefill", "append_paged",
           "append_prefill_chunk",
           "gather_slabs", "scatter_slabs", "gather_pages", "gather_history",
           "pool_bytes_per_token", "bf16_bytes_per_token",
           "page_bytes", "pages_needed", "spill_pages", "restore_pages", "payload_checksum"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """KV-cache precision per page class.

    * ``active_fmt``: pages a write path can still touch (decode appends
      requantize them): ``None`` (bf16) or ``'fp8_e4m3'``.
    * ``frozen_fmt``: pages the prefix cache has registered, read-only for
      the rest of their lives. ``None`` inherits ``active_fmt``;
      ``'fp4_e2m1'`` (behind FP8 active pages) transcodes each page to
      packed FP4 exactly once, at the freeze point.
    * ``cross_fmt``: enc-dec cross pages, written once at admission (``None``
      inherits ``active_fmt``). ``'fp4_e2m1'`` validates as in the reference,
      but the port's ``Server`` refuses it: the reference's own decode
      misreads packed cross pages (ROADMAP queue 3, F9).
    * ``frozen_pages`` sizes the frozen region (``None``: the active pool's
      page count)."""

    active_fmt: Optional[str] = None
    frozen_fmt: Optional[str] = None
    cross_fmt: Optional[str] = None
    frozen_pages: Optional[int] = None

    def __post_init__(self):
        if self.active_fmt not in (None, "fp8_e4m3"):
            raise ValueError(
                f"active_fmt={self.active_fmt!r}: active pages are requantized "
                "by decode appends, so only None (bf16) or 'fp8_e4m3' are writable")
        page_format(self.frozen_fmt)  # fail fast with the allowed set
        page_format(self.cross_fmt)
        if self.frozen_fmt is not None and self.frozen_fmt != self.active_fmt:
            if (self.active_fmt, self.frozen_fmt) != ("fp8_e4m3", "fp4_e2m1"):
                raise ValueError(
                    f"unsupported transcode {self.active_fmt!r} -> {self.frozen_fmt!r}: the "
                    "only mixed-precision policy is FP8 active pages with 'fp4_e2m1' "
                    "frozen pages")
        if self.cross_fmt == "fp4_e2m1" and self.active_fmt != "fp8_e4m3":
            raise ValueError("cross_fmt='fp4_e2m1' requires quantized (fp8_e4m3) active pages")
        if self.frozen_pages is not None and self.frozen_pages < 1:
            raise ValueError(f"frozen_pages={self.frozen_pages}: must be >= 1")

    @property
    def active(self) -> PageFormat:
        return page_format(self.active_fmt)

    @property
    def frozen(self) -> PageFormat:
        return page_format(self.frozen_fmt if self.frozen_fmt is not None else self.active_fmt)

    @property
    def cross(self) -> PageFormat:
        return page_format(self.cross_fmt if self.cross_fmt is not None else self.active_fmt)

    @property
    def mixed(self) -> bool:
        """True when frozen pages live in a separate (FP4) region."""
        return self.frozen != self.active


class PagedState(NamedTuple):
    """Per-row cache index: which pages each row owns and how many tokens
    it truly holds. ``chunk_len`` ((1,) int) marks a streaming-prefill
    chunk (batch 1) bucketed to a power of two: positions >= chunk_len are
    pad, masked out of page writes and of the logits row. ``cross_table`` /
    ``enc_lengths`` (enc-dec decoders): each row's write-once cross page
    ids and true encoder length. ``prefill`` is the mixed engine's nested
    batch-1 chunk state: the outer state indexes the decode rows, and the
    fused token row ``[decode tokens | chunk]`` splits at
    ``lengths.shape[0]``. ``slabs`` (recurrent families): each row's
    state-slab id in the slab pools; the last id is the null slab that
    inactive rows share."""

    page_table: torch.Tensor  # (B, pages_per_slot) int32
    lengths: torch.Tensor  # (B,) int32
    chunk_len: Optional[torch.Tensor] = None
    cross_table: Optional[torch.Tensor] = None  # (B, cross_pp) int32
    enc_lengths: Optional[torch.Tensor] = None  # (B,) int32
    slabs: Optional[torch.Tensor] = None  # (B,) int32 state-slab ids
    prefill: Optional["PagedState"] = None


def pool_keys(pool: Dict) -> Tuple[str, str]:
    """The value-bearing leaf names of a pool: 'k'/'v' or 'ckv'/'krope'."""
    return ("k", "v") if "k" in pool else ("ckv", "krope")


def _has_heads(store: torch.Tensor, per_layer: bool = True) -> bool:
    """GQA stores carry a head axis, MLA latent stores do not: (P+1, page,
    KV, hd) vs (P+1, page, d) per layer, one more leading dim stacked."""
    return store.dim() == (4 if per_layer else 5)


def _with_head_axis(t: torch.Tensor, has_heads: bool) -> torch.Tensor:
    return t if has_heads else t[..., None, :]


def pool_format(pool: Dict) -> PageFormat:
    """The active store's format: bf16 values, FP8 codes, or packed FP4
    codes (marked by the zero-size ``_fp4`` leaf)."""
    if pool[pool_keys(pool)[0]].dtype != torch.uint8:
        return page_format(None)
    return page_format("fp4_e2m1" if "_fp4" in pool else "fp8_e4m3")


def frozen_format(pool: Dict) -> Optional[PageFormat]:
    """The frozen region's format, or None for a homogeneous pool."""
    return page_format("fp4_e2m1") if pool_keys(pool)[0] + "_fz" in pool else None


def n_frozen_pages(pool: Dict) -> int:
    """Frozen-region page count (0 when homogeneous), for full pools and
    per-layer slices alike: the value leaf's rank tells them apart (GQA
    5-D full / 4-D per layer; MLA 4-D / 3-D)."""
    key = pool_keys(pool)[0]
    if key + "_fz" not in pool:
        return 0
    leaf = pool[key + "_fz"]
    full_rank = 5 if key == "k" else 4
    return leaf.shape[1 if leaf.dim() == full_rank else 0] - 1


def _init_store(n_layers, n_pages, page_size, n_kv, head_dim, fmt: PageFormat, device):
    shape = (n_layers, n_pages + 1, page_size, n_kv)  # + the null page / dummy row
    if not fmt.quantized:
        return {"": torch.zeros(shape + (head_dim,), dtype=torch.bfloat16, device=device)}
    return {"": torch.zeros(shape + (fmt.width(head_dim),), dtype=torch.uint8, device=device),
            "_smax": torch.zeros(shape[:2], dtype=torch.float32, device=device),
            "_shift": torch.zeros(shape[:2] + (n_kv,), dtype=torch.int32, device=device)}


def _init_pool(n_layers, n_pages, page_size, leaves, fmt, frozen_fmt, n_frozen,
               device) -> Dict:
    """``leaves``: (name, KV heads, width, keep the head axis) per value
    leaf. The active stores, the ``_fp4`` marker of a packed active store,
    and the frozen region when ``frozen_fmt`` differs from ``fmt``."""
    fmt = page_format(fmt)
    frozen = page_format(frozen_fmt) if frozen_fmt is not None else None
    regions = [("", fmt, n_pages)]
    if frozen is not None and frozen != fmt:
        if (fmt.name, frozen.name) != ("fp8_e4m3", "fp4_e2m1"):
            raise ValueError(f"unsupported frozen store {frozen.name!r} behind {fmt.name!r} "
                             "active pages (only fp4_e2m1 behind fp8_e4m3)")
        if n_frozen < 1:
            raise ValueError("a mixed-precision pool needs n_frozen >= 1")
        regions.append(("_fz", frozen, n_frozen))
    pool = {}
    for region, f, n in regions:
        for name, n_kv, width, heads in leaves:
            for suffix, leaf in _init_store(n_layers, n, page_size, n_kv, width, f,
                                            device).items():
                pool[name + region + suffix] = leaf if heads or suffix else leaf[..., 0, :]
        if f is fmt and fmt.packed:  # zero-size marker: packed FP4, not FP8
            pool["_fp4"] = torch.zeros((n_layers, 0), dtype=torch.uint8, device=device)
    return pool


def init_gqa_pool(n_layers: int, n_pages: int, page_size: int, n_kv: int, head_dim: int,
                  fmt="fp8_e4m3", frozen_fmt=None, n_frozen: int = 0,
                  device=None) -> Dict:
    """Zeroed pool of ``n_pages`` pages plus the null page. A ``frozen_fmt``
    other than ``fmt`` adds the frozen region: half-width packed stores of
    ``n_frozen`` pages plus the dummy row. ``device=None`` is the card
    (``resolve_device``: it raises when there is none)."""
    return _init_pool(n_layers, n_pages, page_size,
                      [("k", n_kv, head_dim, True), ("v", n_kv, head_dim, True)],
                      fmt, frozen_fmt, n_frozen, resolve_device(device))


def init_cross_pool(n_layers: int, n_pages: int, page_size: int, n_kv: int, head_dim: int,
                    fmt="fp8_e4m3", device=None) -> Dict:
    """Write-once cross-attention pages (enc-dec decoders): a GQA pool's
    layout with no frozen region. The encoder runs once per request and
    ``write_cross_pages`` fills the request's pages in one shot; decode
    only reads them (``ops.paged_decode_attn`` with ``kv_lens =
    enc_lengths``), so their scales stay those of encode time."""
    return init_gqa_pool(n_layers, n_pages, page_size, n_kv, head_dim, fmt, device=device)


def init_mla_pool(n_layers: int, n_pages: int, page_size: int, kv_lora_rank: int,
                  qk_rope_dim: int, fmt="fp8_e4m3", frozen_fmt=None, n_frozen: int = 0,
                  device=None) -> Dict:
    """Latent pages: the compressed c_kv and the shared rope key, each with
    a single scale "head" that is squeezed out of the value leaves.
    ``device=None`` is the card, as for ``init_gqa_pool``."""
    return _init_pool(n_layers, n_pages, page_size,
                      [("ckv", 1, kv_lora_rank, False), ("krope", 1, qk_rope_dim, False)],
                      fmt, frozen_fmt, n_frozen, resolve_device(device))


def quantize_pages(vals: torch.Tensor, fmt="fp8_e4m3"):
    """vals (..., page, KV, hd) f32 -> (codes uint8, s_max (...,), shifts
    (..., KV) int32): amax / fmt_max per (page, head), M2 across heads with
    floor rounding, then RNE onto the grid. A packed format stores two
    codes per byte, an odd head dim padded with one zero nibble."""
    pf = page_format(fmt)
    grid = pf.fmt
    amax = torch.amax(vals.abs(), dim=(-3, -1))
    raw = torch.clamp(amax * f32(1.0 / grid.max_value), min=_EPS)
    m2 = constrain_scales_m2(raw, group_axis=-1, rounding="floor")
    codes = fp_encode(quantize_to_grid(vals / m2.scales[..., None, :, None], grid), grid)
    if pf.packed:
        if codes.shape[-1] % 2:
            codes = torch.cat([codes, codes.new_zeros(codes.shape[:-1] + (1,))], dim=-1)
        codes = pack_nibbles(codes)
    return codes, m2.s_max[..., 0], m2.shifts


def dequantize_pages(codes, s_max, shifts, fmt="fp8_e4m3", d: Optional[int] = None):
    """Inverse: exponent-add shift per (page, head), one s_max multiply per
    page. codes (..., page, KV, width); s_max (...,); shifts (..., KV) ->
    f32. ``d`` is the logical head dim (needed for a packed odd width)."""
    pf = page_format(fmt)
    if d is None:
        d = codes.shape[-1] * (2 if pf.packed else 1)
    v = pf.decode(codes, shifts[..., None, :, None], d)
    return v * s_max[..., None, None, None]


def transcode_page(pool: Dict, src_pid: int, dst_fidx: int) -> Dict:
    """Re-encode active page ``src_pid`` (every stacked layer) into frozen
    row ``dst_fidx``: dequantize the FP8 page, requantize it onto packed FP4
    E2M1 with fresh M2 scales. The only writer of the ``*_fz`` leaves; the
    source page is untouched (the caller releases it)."""
    fz = frozen_format(pool)
    if fz is None or pool_format(pool).name != "fp8_e4m3":
        raise ValueError("transcode_page needs an FP8 pool with a frozen FP4 region")
    for name in pool_keys(pool):
        heads = _has_heads(pool[name], per_layer=False)
        vals = dequantize_pages(_with_head_axis(pool[name][:, src_pid], heads),
                                pool[name + "_smax"][:, src_pid],
                                pool[name + "_shift"][:, src_pid])
        codes, smax, shift = quantize_pages(vals, fz)
        pool[name + "_fz"][:, dst_fidx] = codes if heads else codes[..., 0, :]
        pool[name + "_fz_smax"][:, dst_fidx] = smax
        pool[name + "_fz_shift"][:, dst_fidx] = shift
    return pool


def splice_prefill(pool: Dict, prefill_cache: Dict, page_ids, n_tokens: int,
                   chunk_pages: int = 8) -> Dict:
    """Quantize a batch-1 prefill's contiguous K/V into a slot's pages, in
    place, by page id. ``prefill_cache``: one segment's contiguous cache
    (``api.prefill``'s ``caches[i]["kv"]``), leaves (L, 1, max_seq, KV, hd)
    (GQA) or (L, 1, max_seq, d) (MLA). ``page_ids``: the pages covering
    ``n_tokens``. Positions from ``n_tokens`` on are zeroed before a page's
    amax is taken (as the reference's multiply: a negative value leaves
    -0.0; a non-finite one leaves 0), pages that overhang ``max_seq`` are
    padded with zeros, and the pages are quantized ``chunk_pages`` at a time
    (``quantize_pages``), so the f32 staging copy never exceeds one chunk.
    Returns the pool."""
    pf = pool_format(pool)
    ids_all = np.asarray(page_ids.cpu() if torch.is_tensor(page_ids) else page_ids, np.int64)
    for c0 in range(0, len(ids_all), chunk_pages):
        ids_np = ids_all[c0:c0 + chunk_pages]
        npg = len(ids_np)
        for name in pool_keys(pool):
            store = pool[name]
            heads = _has_heads(store, per_layer=False)
            page, t0 = store.shape[2], c0 * store.shape[2]
            src = prefill_cache[name][:, 0, t0:t0 + npg * page].to(store.device).float()
            short = npg * page - src.shape[1]
            if short > 0:  # the reserved pages overhang max_seq
                src = torch.cat([src, src.new_zeros((src.shape[0], short) + src.shape[2:])], 1)
            if t0 + npg * page > n_tokens:
                live = (t0 + torch.arange(npg * page, device=src.device)) < n_tokens
                live = live.reshape((1, npg * page) + (1,) * (src.dim() - 2))
                src = torch.where(live, src, (src * 0).nan_to_num(0.0))
            vals = _with_head_axis(src, heads)
            vals = vals.reshape(vals.shape[0], npg, page, vals.shape[-2], vals.shape[-1])
            ids = torch.as_tensor(ids_np, device=store.device)
            if pf.quantized:
                codes, smax, shifts = quantize_pages(vals, pf)
                store[:, ids] = codes if heads else codes[..., 0, :]
                pool[name + "_smax"][:, ids] = smax
                pool[name + "_shift"][:, ids] = shifts
            else:
                store[:, ids] = (vals if heads else vals[..., 0, :]).to(store.dtype)
    return pool


def append_paged(pool_layer: Dict, new_vals: Dict, state: PagedState) -> Dict:
    """Write one token per row at its true position, in place. new_vals:
    {"k": (B, 1, KV, hd), "v": ...} or {"ckv": (B, 1, r), "krope": ...}.
    Rows with lengths == 0 write to the null page. FP8 pages are
    dequantized, the token written, positions past it zeroed (a recycled
    page may hold a previous owner's stale codes) and the page requantized
    with fresh scales."""
    pf = pool_format(pool_layer)
    if pf.packed:  # frozen pages are transcoded once and never written again
        raise AssertionError(
            "decode append must never target packed FP4 pages (frozen pages are read-only)")
    lengths = state.lengths.long()
    b = lengths.shape[0]
    rows = torch.arange(b, device=lengths.device)
    for name in pool_keys(pool_layer):
        store = pool_layer[name]
        heads = _has_heads(store)
        page, null = store.shape[1], store.shape[0] - 1
        slot = torch.clamp(lengths // page, max=state.page_table.shape[1] - 1)
        off = lengths % page
        pid = state.page_table.long().gather(1, slot[:, None])[:, 0]
        # a row's tail page is private (boundary pages never freeze), so pid
        # is an active id; the clamp keeps a violation inside the store
        pid = torch.clamp(torch.where(lengths > 0, pid, torch.full_like(pid, null)), max=null)
        new = new_vals[name].float()[:, 0]  # (B, KV, hd) | (B, d)
        if not pf.quantized:
            store[pid, off] = new.to(store.dtype)
            continue
        smax, shift = pool_layer[name + "_smax"], pool_layer[name + "_shift"]
        vals = dequantize_pages(_with_head_axis(store[pid], heads), smax[pid], shift[pid])
        vals[rows, off] = _with_head_axis(new, heads)
        # where(), not a multiply: a stale non-finite code must not survive
        live = torch.arange(page, device=off.device)[None, :] <= off[:, None]
        vals = torch.where(live[:, :, None, None], vals, torch.zeros_like(vals))
        codes, nsmax, nshift = quantize_pages(vals)
        store[pid] = codes if heads else codes[..., 0, :]
        smax[pid] = nsmax
        shift[pid] = nshift
    return pool_layer


def append_prefill_chunk(pool_layer: Dict, new_vals: Dict, state: PagedState) -> Dict:
    """Write one page-aligned chunk of a batch-1 streaming prefill, in
    place. new_vals: {"k": (1, S, KV, hd), ...} or {"ckv": (1, S, r), ...}
    starting at position ``state.lengths[0]`` (a page multiple). With
    ``chunk_len`` set, positions >= chunk_len are pad and zeroed (with
    where(): pad K/V can be NaN downstream of a non-finite chunk); pages the
    pad overhangs must map to the null page in the table."""
    pf = pool_format(pool_layer)
    start = int(state.lengths[0])
    for name in pool_keys(pool_layer):
        store = pool_layer[name]
        heads = _has_heads(store)
        page = store.shape[1]
        new = _with_head_axis(new_vals[name].float()[0], heads)  # (S, KV|1, hd)
        s = new.shape[0]
        if state.chunk_len is not None:
            live = torch.arange(s, device=new.device) < state.chunk_len[0]
            new = torch.where(live[:, None, None], new, torch.zeros_like(new))
        npg = -(-s // page)
        if npg * page > s:
            new = torch.cat([new, new.new_zeros((npg * page - s,) + tuple(new.shape[1:]))])
        vals = new.reshape(npg, page, new.shape[-2], new.shape[-1])
        pid = state.page_table[0, start // page: start // page + npg].long()
        # prefill writes target private active pages only; a frozen id here
        # is a bug the engine's assert_unfrozen catches, the clamp keeps it
        # inside the store
        pid = torch.clamp(pid, max=store.shape[0] - 1)
        if pf.quantized:
            codes, smax, shifts = quantize_pages(vals, pf)
            store[pid] = codes if heads else codes[..., 0, :]
            pool_layer[name + "_smax"][pid] = smax
            pool_layer[name + "_shift"][pid] = shifts
        else:
            store[pid] = (vals if heads else vals[..., 0, :]).to(store.dtype)
    return pool_layer


def write_cross_pages(pool_layer: Dict, new_vals: Dict, cross_table: torch.Tensor) -> Dict:
    """Write one layer's encoder K/V ({"k": (1, T_enc, KV, hd), "v": ...})
    into its cross pages ``cross_table`` (1, cross_pp), in place: a prefill
    chunk over the whole encoder sequence at length 0. The only writer of
    cross pages."""
    state = PagedState(cross_table, torch.zeros((1,), dtype=torch.int32,
                                                device=cross_table.device))
    return append_prefill_chunk(pool_layer, new_vals, state)


# ---------------------------------------------------------------------------
# State slabs (SSM / xLSTM recurrent state)
# ---------------------------------------------------------------------------
def gather_slabs(pool_layer: Dict, slab_ids: torch.Tensor) -> Dict:
    """One layer's recurrent state for each row: slab-pool leaves (S+1, ...)
    -> (B, ...) copies. ``slab_ids`` (B,): the last slab (index S) is the
    null slab inactive rows point at.

    A slab is the fixed-size counterpart of a page for families whose
    decode state does not grow with context (the SSM state and conv tail,
    xLSTM's cells): one a running request, allocated at admission, stolen
    and spilled like pages, never grown."""
    ids = slab_ids.long()
    return {name: leaf[ids] for name, leaf in pool_layer.items()}


def scatter_slabs(pool_layer: Dict, slab_ids: torch.Tensor, new_rows: Dict) -> Dict:
    """Write each row's new state back into its slab, in place. Rows
    sharing the null slab overwrite each other there (in no fixed order on
    the card): harmless, since the null slab is never read as live state --
    a slab is reset to the pristine state when it is allocated."""
    ids = slab_ids.long()
    for name, leaf in pool_layer.items():
        leaf[ids] = new_rows[name].to(leaf.dtype)
    return pool_layer


def gather_pages(pool_layer: Dict, name: str, state: PagedState) -> torch.Tensor:
    """Dequantized gather of each row's table: (B, PP * page, KV, hd) f32
    for GQA leaves, (B, PP * page, d) for MLA latent leaves. In a mixed
    pool, ids >= P+1 are frozen logical ids: both regions are gathered with
    clamped ids (frozen ids clamp to the null page in the active store,
    active ids to row 0 of the frozen store) and a ``where`` on the id
    class picks each page."""
    store = pool_layer[name]
    heads = _has_heads(store)
    pf = pool_format(pool_layer)
    fz = frozen_format(pool_layer)
    pt = state.page_table.long()
    b, pp = pt.shape
    base = store.shape[0]  # P+1: the first frozen logical id
    apt = torch.clamp(pt, max=base - 1) if fz is not None else pt
    if pf.quantized:
        d = store.shape[-1] * (2 if pf.packed else 1)
        vals = dequantize_pages(_with_head_axis(store[apt], heads),
                                pool_layer[name + "_smax"][apt],
                                pool_layer[name + "_shift"][apt], pf, d=d)
    else:
        vals = _with_head_axis(store[apt].float(), heads)
    if fz is not None:
        fstore = pool_layer[name + "_fz"]
        fpt = torch.clamp(pt - base, 0, fstore.shape[0] - 1)
        fvals = dequantize_pages(_with_head_axis(fstore[fpt], heads),
                                 pool_layer[name + "_fz_smax"][fpt],
                                 pool_layer[name + "_fz_shift"][fpt], fz, d=store.shape[-1])
        vals = torch.where((pt >= base)[:, :, None, None, None], fvals, vals)
    vals = vals if heads else vals[..., 0, :]
    return vals.reshape(b, pp * store.shape[1], *vals.shape[3:])


def gather_history(pool_layer: Dict, state: PagedState, chunk_len: int):
    """History gather for a streaming-prefill chunk: the whole table is
    gathered and the caller masks columns >= lengths[0] (the chunk's own
    pages or null fill). Returns ({name: (B, W * page, ...)}, W * page), or
    ({}, 0) when the table is no wider than the chunk itself."""
    keys = pool_keys(pool_layer)
    page = pool_layer[keys[0]].shape[1]
    if state.page_table.shape[1] <= -(-chunk_len // page):
        return {}, 0
    return ({name: gather_pages(pool_layer, name, state) for name in keys},
            state.page_table.shape[1] * page)


# ---------------------------------------------------------------------------
# Content-addressed shared-prefix index (host side)
# ---------------------------------------------------------------------------
_PREFIX_ROOT = -1  # the parent node id of every depth-0 page


def page_key(parent: int, tokens: Sequence[int]) -> Tuple:
    """Content address of one full page: its token ids chained on the
    parent page's node id (assigned at registration, never reissued), so a
    key names the whole prefix up to and including this page."""
    return (parent, tuple(int(t) for t in tokens))


class PrefixCache:
    """Host-side radix index over full, scale-frozen KV pages.

    A full page's content is a pure function of its token prefix (the
    prefill stream wrote it in one shot and its M2 scales never move
    again), so requests sharing a prompt prefix can map the same pages.
    ``page_key(parent, tokens)`` -> page id, one entry per registered page.
    Refcounts live in the engine; the index keeps the reusable LRU of
    registered pages at refcount 0, which stay reusable until the
    allocator reclaims them, oldest first."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._by_key: Dict[Tuple, Tuple[int, int]] = {}  # key -> (pid, node id)
        self._by_pid: Dict[int, Tuple] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # oldest-parked first
        self._next_node = 0
        # conditioning digest -> root node id: enc-dec requests chain off a
        # root per frames digest (decoder K/V depends on the frames through
        # cross-attention), so equal prompts under other frames never alias
        self._roots: Dict[str, int] = {}
        self.reclaims = 0

    def root_for(self, digest: str) -> int:
        """The radix root node of a conditioning digest (e.g. the encoder
        frames' hash), assigned once from the node counter: one digest,
        one chain; two digests, disjoint chains."""
        root = self._roots.get(digest)
        if root is None:
            root = self._next_node
            self._next_node += 1
            self._roots[digest] = root
        return root

    def __len__(self) -> int:
        return len(self._by_key)

    @property
    def n_reusable(self) -> int:
        """Registered pages at refcount 0."""
        return len(self._lru)

    def reusable_ids(self) -> List[int]:
        """The parked page ids, oldest first."""
        return list(self._lru)

    def registered(self, pid: int) -> bool:
        return int(pid) in self._by_pid

    def walk(self, tokens: Sequence[int], max_pages: Optional[int] = None,
             root: int = _PREFIX_ROOT) -> List[int]:
        """Longest chain of consecutive full-page hits for this token
        prefix from ``root`` (the global root or a ``root_for`` node): the
        page ids holding ``tokens[:len(hits) * page_size]``."""
        page = self.page_size
        limit = len(tokens) // page
        if max_pages is not None:
            limit = min(limit, max_pages)
        pids: List[int] = []
        parent = root
        for i in range(limit):
            hit = self._by_key.get(page_key(parent, tokens[i * page: (i + 1) * page]))
            if hit is None:
                break
            pids.append(hit[0])
            parent = hit[1]
        return pids

    def insert(self, tokens: Sequence[int], pids: Sequence[int],
               root: int = _PREFIX_ROOT) -> List[int]:
        """Register the full pages covering ``tokens[:len(pids) * page]``
        under ``root``. Returns the canonical pid per page: where the chain
        key already exists, the existing page wins and the caller adopts it."""
        page = self.page_size
        out: List[int] = []
        parent = root
        for i, pid in enumerate(pids):
            pid = int(pid)
            key = page_key(parent, tokens[i * page: (i + 1) * page])
            cur = self._by_key.get(key)
            if cur is None:
                if pid in self._by_pid:
                    raise AssertionError(f"page {pid} already registered under another prefix")
                cur = (pid, self._next_node)
                self._next_node += 1
                self._by_key[key] = cur
                self._by_pid[pid] = key
            out.append(cur[0])
            parent = cur[1]
        return out

    def park(self, pid: int):
        """A registered page's refcount hit zero: keep it in the LRU."""
        pid = int(pid)
        if pid not in self._by_pid:
            raise AssertionError(f"parking unregistered page {pid}")
        self._lru[pid] = None
        self._lru.move_to_end(pid)

    def unpark(self, pid: int):
        """A parked page was mapped again (refcount 0 -> 1)."""
        self._lru.pop(int(pid), None)

    def reclaim(self) -> Optional[int]:
        """Drop the least recently parked page from the index and return its
        id as a blank; None when nothing is parked."""
        if not self._lru:
            return None
        pid, _ = self._lru.popitem(last=False)
        del self._by_key[self._by_pid.pop(pid)]
        self.reclaims += 1
        return pid

    def assert_unfrozen(self, page_ids: Iterable[int], frozen_base: Optional[int] = None):
        """No write path may target a registered page (shared, possibly
        mapped by several rows) nor, with ``frozen_base``, any id of the
        packed FP4 region (read-only once transcoded, registered or not)."""
        for pid in page_ids:
            pid = int(pid)
            if frozen_base is not None and pid >= frozen_base:
                raise AssertionError(
                    f"write targets frozen FP4 page {pid} (>= frozen base {frozen_base}): "
                    "packed FP4 pages are transcoded once at freeze time and never written again")
            if pid in self._by_pid:
                raise AssertionError(
                    f"write targets shared-frozen page {pid}: frozen pages are immutable "
                    "(copy-on-write means the boundary page must be private)")


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def pool_bytes_per_token(pool: Dict) -> float:
    """Bytes of active-store storage per token slot (values and scales,
    across the stacked layers), excluding the null page and the frozen
    region."""
    n_layers, p1, page = pool[pool_keys(pool)[0]].shape[:3]
    total = 0.0
    for name, leaf in pool.items():
        if "_fz" in name or leaf.numel() == 0:
            continue
        total += _nbytes(leaf) * (leaf.shape[1] - 1) / leaf.shape[1]
    return total / ((p1 - 1) * page)


def bf16_bytes_per_token(pool: Dict) -> float:
    """What the same pool geometry would cost per token holding bf16 values
    (the cache the FP8 pool replaces): 2 bytes a feature, every layer."""
    total = 0
    for name in pool_keys(pool):
        leaf = pool[name]
        total += math.prod(leaf.shape[3:]) * leaf.shape[0] * 2
    return float(total)


def page_bytes(pool: Dict, frozen: bool = False) -> float:
    """Bytes one page costs across the stacked layers (values and scales)
    in the active store, or with ``frozen`` in the packed frozen region
    (0.0 when the pool is homogeneous)."""
    total = 0.0
    for name, leaf in pool.items():
        if leaf.numel() == 0 or ("_fz" in name) != frozen:
            continue
        total += _nbytes(leaf) / leaf.shape[1 if leaf.dim() >= 2 else 0]
    return total


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(n_tokens / page_size))


# ---------------------------------------------------------------------------
# Spill payloads (preemption by page steal)
# ---------------------------------------------------------------------------
def spill_pages(pool: Dict, ids: torch.Tensor) -> Dict[str, np.ndarray]:
    """Host copy of pages ``ids`` (every stacked layer) of the active
    stores, or of slabs ``ids`` of a slab pool (whose leaves index the slab
    on the same axis): one pool's part of a spill payload. The frozen region's leaves
    and the zero-size ``_fp4`` marker are left out (a spilled page is
    private, so active-class). bf16 has no numpy dtype: such a leaf travels
    as its int16 view, the same bytes."""
    out = {}
    for name, leaf in pool.items():
        if "_fz" in name or not leaf.numel():
            continue
        part = leaf[:, ids]
        out[name] = (part.view(torch.int16) if part.dtype == torch.bfloat16 else part).cpu().numpy()
    return out


def restore_pages(pool: Dict, part: Dict[str, np.ndarray], ids: torch.Tensor):
    """Write a ``spill_pages`` part back into pages ``ids``, in place (the
    pool's leaves keep their addresses)."""
    for name, arr in part.items():
        leaf = pool[name]
        leaf[:, ids] = torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.device).view(leaf.dtype)


def payload_checksum(payload: List[Dict[str, np.ndarray]]) -> int:
    """CRC32 over a spill payload (one leaf dict per pool): each part's
    leaf names in sorted order, each followed by its bytes. Computed at
    preemption on the pristine bytes and checked again before a resume
    restores them, so bit rot while spilled is caught. The same bytes give
    ``repro.runtime.kv_cache.payload_checksum``'s value."""
    crc = 0
    for part in payload:
        for name in sorted(part):
            crc = zlib.crc32(name.encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(part[name]).tobytes(), crc)
    return crc
