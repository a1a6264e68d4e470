"""Quantized paged KV pool, GQA slice (port of ``repro.runtime.kv_cache``).

Layout (one pool dict per model segment, leading dim = stacked layers):

  k/v        (L, P+1, page, KV, hd)  uint8 FP8 E4M3 codes | bf16 values
  k/v_smax   (L, P+1)                f32   per-page full-precision S_max
  k/v_shift  (L, P+1, KV)            int32 per-(page, head) M2 shifts

Page ids are global across layers; the last id (P) is the reserved null
page that idle rows write to. FP8 scales are amax / 480 per (page, head),
M2-constrained across the page's heads with floor rounding (never
saturates), so decode applies them as an exponent add plus one s_max
multiply per page.

Unlike the reference, whose arrays are immutable, the write paths here
(``append_paged``, ``append_prefill_chunk``) update the pool leaves in
place: copying the whole pool for every layer of every step would cost far
more than the step. They return the (same) layer dict, so callers read as
in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.formats import f32, fp_encode, quantize_to_grid
from repro_torch.core.scales import constrain_scales_m2
from repro_torch.kernels.common import PageFormat, page_format

__all__ = ["CachePolicy", "PagedState", "init_gqa_pool", "pool_format",
           "quantize_pages", "dequantize_pages", "append_paged",
           "append_prefill_chunk", "gather_pages", "gather_history", "pages_needed"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """KV-cache precision. This slice ports ``active_fmt`` only: ``None``
    (bf16 pages) or ``'fp8_e4m3'``. Frozen FP4 pages and cross pages come
    with the prefix cache and enc-dec (ROADMAP queue 1, items 8 and 12)."""

    active_fmt: Optional[str] = None

    def __post_init__(self):
        if self.active_fmt not in (None, "fp8_e4m3"):
            raise ValueError(
                f"active_fmt={self.active_fmt!r}: active pages are requantized "
                "by decode appends, so only None (bf16) or 'fp8_e4m3' are writable")

    @property
    def active(self) -> PageFormat:
        return page_format(self.active_fmt)


class PagedState(NamedTuple):
    """Per-row cache index: which pages each row owns and how many tokens
    it truly holds. ``chunk_len`` ((1,) int) marks a streaming-prefill
    chunk (batch 1) bucketed to a power of two: positions >= chunk_len are
    pad, masked out of page writes and of the logits row."""

    page_table: torch.Tensor  # (B, pages_per_slot) int32
    lengths: torch.Tensor  # (B,) int32
    chunk_len: Optional[torch.Tensor] = None


def pool_format(pool: Dict) -> PageFormat:
    return page_format("fp8_e4m3" if pool["k"].dtype == torch.uint8 else None)


def init_gqa_pool(n_layers: int, n_pages: int, page_size: int, n_kv: int,
                  head_dim: int, fmt="fp8_e4m3", device="cpu") -> Dict:
    """Zeroed pool of ``n_pages`` pages plus the null page."""
    fmt = page_format(fmt)
    if fmt.packed:
        raise NotImplementedError("packed FP4 pools come with the frozen region (ROADMAP queue 1, item 8)")
    shape = (n_layers, n_pages + 1, page_size, n_kv, head_dim)
    pool = {}
    for name in ("k", "v"):
        if fmt.quantized:
            pool[name] = torch.zeros(shape, dtype=torch.uint8, device=device)
            pool[name + "_smax"] = torch.zeros(shape[:2], dtype=torch.float32, device=device)
            pool[name + "_shift"] = torch.zeros(shape[:2] + (n_kv,), dtype=torch.int32,
                                                device=device)
        else:
            pool[name] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return pool


def quantize_pages(vals: torch.Tensor, fmt="fp8_e4m3"):
    """vals (..., page, KV, hd) f32 -> (codes uint8, s_max (...,), shifts
    (..., KV) int32): amax / fmt_max per (page, head), M2 across heads with
    floor rounding, then RNE onto the grid."""
    grid = page_format(fmt).fmt
    amax = torch.amax(vals.abs(), dim=(-3, -1))
    raw = torch.clamp(amax * f32(1.0 / grid.max_value), min=_EPS)
    m2 = constrain_scales_m2(raw, group_axis=-1, rounding="floor")
    q = quantize_to_grid(vals / m2.scales[..., None, :, None], grid)
    return fp_encode(q, grid), m2.s_max[..., 0], m2.shifts


def dequantize_pages(codes, s_max, shifts, fmt="fp8_e4m3"):
    """Inverse: exponent-add shift per (page, head), one s_max multiply per
    page. codes (..., page, KV, hd); s_max (...,); shifts (..., KV) -> f32."""
    v = page_format(fmt).decode(codes, shifts[..., None, :, None], codes.shape[-1])
    return v * s_max[..., None, None, None]


def append_paged(pool_layer: Dict, new_vals: Dict, state: PagedState) -> Dict:
    """Write one token per row at its true position, in place. new_vals:
    {"k": (B, 1, KV, hd), "v": ...}. Rows with lengths == 0 write to the
    null page. FP8 pages are dequantized, the token written, positions past
    it zeroed (a recycled page may hold a previous owner's stale codes) and
    the page requantized with fresh scales."""
    pf = pool_format(pool_layer)
    lengths = state.lengths.long()
    b = lengths.shape[0]
    rows = torch.arange(b, device=lengths.device)
    for name in ("k", "v"):
        store = pool_layer[name]
        page, null = store.shape[1], store.shape[0] - 1
        slot = torch.clamp(lengths // page, max=state.page_table.shape[1] - 1)
        off = lengths % page
        pid = state.page_table.long().gather(1, slot[:, None])[:, 0]
        pid = torch.clamp(torch.where(lengths > 0, pid, torch.full_like(pid, null)), max=null)
        new = new_vals[name].float()[:, 0]  # (B, KV, hd)
        if not pf.quantized:
            store[pid, off] = new.to(store.dtype)
            continue
        smax, shift = pool_layer[name + "_smax"], pool_layer[name + "_shift"]
        vals = dequantize_pages(store[pid], smax[pid], shift[pid])
        vals[rows, off] = new
        # where(), not a multiply: a stale non-finite code must not survive
        live = torch.arange(page, device=off.device)[None, :] <= off[:, None]
        vals = torch.where(live[:, :, None, None], vals, torch.zeros_like(vals))
        codes, nsmax, nshift = quantize_pages(vals)
        store[pid] = codes
        smax[pid] = nsmax
        shift[pid] = nshift
    return pool_layer


def append_prefill_chunk(pool_layer: Dict, new_vals: Dict, state: PagedState) -> Dict:
    """Write one page-aligned chunk of a batch-1 streaming prefill, in
    place. new_vals: {"k": (1, S, KV, hd), ...} starting at position
    ``state.lengths[0]`` (a page multiple). With ``chunk_len`` set,
    positions >= chunk_len are pad and zeroed (with where(): pad K/V can be
    NaN downstream of a non-finite chunk); pages the pad overhangs must
    map to the null page in the table."""
    pf = pool_format(pool_layer)
    start = int(state.lengths[0])
    for name in ("k", "v"):
        store = pool_layer[name]
        page = store.shape[1]
        new = new_vals[name].float()[0]  # (S, KV, hd)
        s = new.shape[0]
        if state.chunk_len is not None:
            live = torch.arange(s, device=new.device) < state.chunk_len[0]
            new = torch.where(live[:, None, None], new, torch.zeros_like(new))
        npg = -(-s // page)
        if npg * page > s:
            new = torch.cat([new, new.new_zeros((npg * page - s,) + tuple(new.shape[1:]))])
        vals = new.reshape(npg, page, new.shape[-2], new.shape[-1])
        pid = state.page_table[0, start // page: start // page + npg].long()
        pid = torch.clamp(pid, max=store.shape[0] - 1)
        if pf.quantized:
            codes, smax, shifts = quantize_pages(vals)
            store[pid] = codes
            pool_layer[name + "_smax"][pid] = smax
            pool_layer[name + "_shift"][pid] = shifts
        else:
            store[pid] = vals.to(store.dtype)
    return pool_layer


def gather_pages(pool_layer: Dict, name: str, state: PagedState) -> torch.Tensor:
    """Dequantized gather (B, PP * page, KV, hd) f32 of each row's table."""
    store = pool_layer[name]
    pt = state.page_table.long()
    b, pp = pt.shape
    pages = store[pt]
    if pool_format(pool_layer).quantized:
        vals = dequantize_pages(pages, pool_layer[name + "_smax"][pt],
                                pool_layer[name + "_shift"][pt])
    else:
        vals = pages.float()
    return vals.reshape(b, pp * store.shape[1], *vals.shape[3:])


def gather_history(pool_layer: Dict, state: PagedState, chunk_len: int):
    """History gather for a streaming-prefill chunk: the whole table is
    gathered and the caller masks columns >= lengths[0] (the chunk's own
    pages or null fill). Returns ({name: (B, W * page, KV, hd)}, W * page),
    or ({}, 0) when the table is no wider than the chunk itself."""
    page = pool_layer["k"].shape[1]
    if state.page_table.shape[1] <= -(-chunk_len // page):
        return {}, 0
    return ({name: gather_pages(pool_layer, name, state) for name in ("k", "v")},
            state.page_table.shape[1] * page)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(n_tokens / page_size))
