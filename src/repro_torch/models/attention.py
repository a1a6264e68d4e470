"""GQA attention over the paged KV pool (port of the paged branches of
``repro.models.attention``): the decode step (one token per row, appended
then read through ``ops.paged_decode_attn``) and the streaming-prefill
chunk (batch 1: written to its pages, attending gathered history pages
plus its own exact K/V). The mixed engine's fused branch, the training /
contiguous-cache modes and cross-attention come with later slices."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.formats import f32
from repro_torch.runtime.kv_cache import (PagedState, append_paged,
                                          append_prefill_chunk, gather_history)

from .layers import ParamDef, linear, quant_act

__all__ = ["attn_params", "attention"]

_NEG_INF = -1e30


def attn_params(cfg):
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, dt = cfg.resolved_head_dim, cfg.param_dtype
    p = {
        "wq": ParamDef((h * hd, d), ("heads", "embed"), dt),
        "wk": ParamDef((kv * hd, d), ("kv", "embed"), dt),
        "wv": ParamDef((kv * hd, d), ("kv", "embed"), dt),
        "wo": ParamDef((d, h * hd), ("embed", "heads"), dt),
    }
    if cfg.use_bias:
        p["bq"] = ParamDef((h * hd,), ("heads",), dt, "zeros")
        p["bv"] = ParamDef((kv * hd,), ("kv",), dt, "zeros")
        p["bo"] = ParamDef((d,), ("embed",), dt, "zeros")
    return p


def _repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV*g, hd) by head repetition."""
    return k if g == 1 else torch.repeat_interleave(k, g, dim=2)


def _sdpa_full(q, k, v, mask):
    """q: (B, Sq, H, hd) bf16; k/v: (B, Sk, H, hd) bf16; mask (Sq, Sk) f32
    additive. bf16 operands, f32 sums and softmax, bf16 out — the
    reference's dtype flow."""
    scale = f32(1.0 / f32(math.sqrt(q.shape[-1])))
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale + mask
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqt,bthd->bqhd", p.float(), v.float()).to(v.dtype)


def _paged_chunk_attn(q, k, v, pool_layer, state: PagedState, g: int, window: int):
    """One batch-1 streaming-prefill chunk: gathered history pages (columns
    before the chunk start) plus the chunk's own exact K/V under a tril
    mask. q/k/v: (1, S, ., hd) bf16."""
    s = q.shape[1]
    hist, hist_len = gather_history(pool_layer, state, s)
    start = state.lengths[0].to(q.device)
    kc, vc = k, v
    if hist_len:
        kc = torch.cat([hist["k"].to(k.dtype), k], 1)
        vc = torch.cat([hist["v"].to(v.dtype), v], 1)
    dev = q.device
    ok = torch.cat([(torch.arange(hist_len, device=dev)[None, :] < start).expand(s, hist_len),
                    torch.ones((s, s), dtype=torch.bool, device=dev).tril()], dim=1)
    if window:
        qi = start + torch.arange(s, device=dev)
        ki = torch.cat([torch.arange(hist_len, device=dev), qi])
        ok &= ki[None, :] > qi[:, None] - window
    mask = torch.where(ok, 0.0, _NEG_INF).to(torch.float32)
    return _sdpa_full(q, _repeat_kv(kc, g), _repeat_kv(vc, g), mask)


def attention(p, x: torch.Tensor, cfg, kv_cache, state: PagedState,
              a_fmt: Optional[str] = None):
    """Returns (out, kv_cache). ``kv_cache`` is one layer's pool slice,
    written in place. A state with ``chunk_len`` is a prefill chunk (even a
    1-token one); without, x is one decode token per row."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    b, s, _ = x.shape
    xq = quant_act(x, a_fmt)
    q = linear(p["wq"], xq, p.get("bq")).reshape(b, s, h, hd)
    k = linear(p["wk"], xq).reshape(b, s, kv, hd)
    v = linear(p["wv"], xq, p.get("bv")).reshape(b, s, kv, hd)
    if cfg.pos_embedding == "rope":
        raise NotImplementedError("rope models come with a later slice (ROADMAP queue 1, item 4)")
    if s == 1 and state.chunk_len is None:
        from repro_torch.kernels import ops

        append_paged(kv_cache, {"k": k, "v": v}, state)
        o = ops.paged_decode_attn(q[:, 0], kv_cache, state.page_table,
                                  state.lengths + 1, window=cfg.window)
        o = o[:, None].to(x.dtype)
    else:
        assert cfg.causal and b == 1, "streaming paged prefill is causal and row-wise"
        append_prefill_chunk(kv_cache, {"k": k, "v": v}, state)
        o = _paged_chunk_attn(q, k, v, kv_cache, state, g, cfg.window)
    out = linear(p["wo"], quant_act(o.reshape(b, s, h * hd), a_fmt), p.get("bo"))
    return out, kv_cache
