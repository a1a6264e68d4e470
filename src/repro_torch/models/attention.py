"""GQA attention (port of ``repro.models.attention``): over the paged KV
pool, the decode step (one token per row, appended then read through
``ops.paged_decode_attn``), the streaming-prefill chunk (batch 1: written
to its pages, attending gathered history pages plus its own exact K/V) and
the mixed engine's fused row of both; over a contiguous cache
(``init_kv_cache``: (B, max_seq, KV, hd) bf16, one synchronized position
for every row), the prefill (attending within x, K/V written from the
position given) and the scalar-index decode step (one token written, then
a full softmax row over the whole cache under a length mask); without a
cache, the forward over a whole sequence (full softmax rows,
query-chunked above ``attn_chunk``), which calibration and perplexity
run; and the enc-dec decoder's cross-attention, over the write-once cross
pages when serving (``paged_cross_attention``) or against the encoder's
K/V."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.formats import f32
from repro_torch.kernels import ops
from repro_torch.runtime.kv_cache import (PagedState, append_paged, append_prefill_chunk,
                                          gather_history, gather_pages)

from .layers import ParamDef, apply_rope, linear, quant_act

__all__ = ["attn_params", "attention", "paged_cross_attention", "block_mask", "init_kv_cache",
           "write_contiguous", "check_contiguous_step"]

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


def init_kv_cache(batch: int, max_seq: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None):
    """A zeroed contiguous K/V cache: {"k", "v"} (B, max_seq, KV, hd)."""
    return {name: torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device)
            for name in ("k", "v")}


def write_contiguous(cache, new_vals, index: int):
    """Write ``new_vals`` ({name: (B, S, ...)}) at positions index ..
    index + S - 1 of the contiguous cache leaves (B, max_seq, ...), in place,
    rounded to the cache's dtype. A write that runs past max_seq raises
    ``ValueError``: the reference's ``dynamic_update_slice`` clamps the index
    instead and silently overwrites the last slots (ROADMAP queue 3, F10)."""
    for name, v in new_vals.items():
        leaf = cache[name]
        if index < 0 or index + v.shape[1] > leaf.shape[1]:
            raise ValueError(f"contiguous cache write of {v.shape[1]} positions at index {index} "
                             f"runs past max_seq {leaf.shape[1]} (ROADMAP queue 3, F10)")
        leaf[:, index:index + v.shape[1]] = v.to(leaf.dtype)
    return cache


def check_contiguous_step(s: int, index: int):
    """Refuse a contiguous-cache step of ``s`` > 1 tokens at an ``index``
    past 0. The reference attends such a step within its own tokens, masked
    as a prefill from position 0, and silently ignores every position the
    cache holds (ROADMAP queue 3, F11); only the prefill (index 0) and the
    one-token step are defined."""
    if s > 1 and index > 0:
        raise ValueError(f"a contiguous step of {s} tokens at index {index}: the cache's "
                         f"earlier positions would be ignored (ROADMAP queue 3, F11)")


def block_mask(sq: int, sk: int, q_start: int, k_start: int, causal: bool, window: int,
               kv_len: Optional[int] = None, device=None) -> torch.Tensor:
    """(sq, sk) additive f32 mask of a block of queries from ``q_start``
    against keys from ``k_start``: causal and / or a sliding window, and
    keys at or past ``kv_len`` hidden when it is given."""
    qi = q_start + torch.arange(sq, device=device)[:, None]
    ki = k_start + torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window:
        ok &= ki > qi - window
    if kv_len is not None:
        ok &= ki < kv_len
    return torch.where(ok, 0.0, _NEG_INF).to(torch.float32)


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


def _sdpa_chunked(q, k, v, causal: bool, window: int, q_chunk: int):
    """Query-chunked attention: each block of ``q_chunk`` queries takes a
    full softmax row against the whole K/V (one level of looping, as the
    reference's scan). q: (B, S, H, hd) at positions 0..S-1; k/v: (B, T,
    H, hd/dv) from position 0. Returns (B, S, H, dv) in v's dtype."""
    s, t = q.shape[1], k.shape[1]
    scale = f32(1.0 / float(q.shape[-1]) ** 0.5)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, s, q_chunk):
        qb = q[:, q0:q0 + q_chunk]
        sblk = torch.einsum("bqhd,bthd->bhqt", qb.float(), kf) * scale
        msk = block_mask(qb.shape[1], t, q0, 0, causal, window, device=q.device)
        p = torch.softmax(sblk + msk, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", p.float(), vf).to(v.dtype))
    return torch.cat(outs, dim=1)


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


def _self_attention(q, k, v, g: int, cfg, device):
    """A whole sequence attending within itself from position 0: full
    softmax rows, query-chunked above ``attn_chunk``."""
    s = q.shape[1]
    kf, vf = _repeat_kv(k, g), _repeat_kv(v, g)
    if s > cfg.attn_chunk:
        return _sdpa_chunked(q, kf, vf, cfg.causal, cfg.window, cfg.attn_chunk)
    return _sdpa_full(q, kf, vf, block_mask(s, s, 0, 0, cfg.causal, cfg.window, device=device))


def attention(p, x: torch.Tensor, cfg, positions: torch.Tensor, kv_cache=None,
              state=None, a_fmt: Optional[str] = None, cross_kv=None):
    """Returns (out, kv_cache). ``kv_cache`` is one layer's pool slice,
    written in place; ``positions`` (B, S) are the rows' token positions
    (rope). A state with ``prefill`` is a mixed step (x is the fused (1,
    slots + S) row); one with ``chunk_len`` a prefill chunk (even a 1-token
    one); otherwise x is one decode token per row. An ``int`` state is the
    contiguous cache's synchronized index (``kv_cache`` one layer's
    {"k", "v"}, (B, max_seq, KV, hd)): K/V are written there; with S > 1
    x attends within itself as from position 0 (the prefill, as the
    reference), with S == 1 the token attends to the cache's first index + 1
    positions; S > 1 at an index past 0 raises (F11). Without a state (and
    cache) x is a whole sequence at ``positions`` = 0..S-1, attending within
    itself, or with ``cross_kv`` = (k, v) (B, T, KV, hd) from the encoder,
    attending to all of it."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    b, s, _ = x.shape
    xq = quant_act(x, a_fmt)
    q = linear(p["wq"], xq, p.get("bq")).reshape(b, s, h, hd)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
    if cross_kv is not None:
        k, v = cross_kv
        if k.shape[2] != h:
            k, v = _repeat_kv(k, h // k.shape[2]), _repeat_kv(v, h // v.shape[2])
        mask = torch.zeros((s, k.shape[1]), dtype=torch.float32, device=x.device)
        o = _sdpa_full(q, k, v, mask).reshape(b, s, h * hd)
        return linear(p["wo"], quant_act(o, a_fmt), p.get("bo")), None
    k = linear(p["wk"], xq).reshape(b, s, kv, hd)
    v = linear(p["wv"], xq, p.get("bv")).reshape(b, s, kv, hd)
    if cfg.pos_embedding == "rope":
        k = apply_rope(k, positions, cfg.rope_theta)
    if state is None:
        o = _self_attention(q, k, v, g, cfg, x.device)
    elif isinstance(state, int):
        check_contiguous_step(s, state)
        write_contiguous(kv_cache, {"k": k, "v": v}, state)
        if s == 1:
            t = kv_cache["k"].shape[1]
            mask = block_mask(1, t, state, 0, cfg.causal, cfg.window, kv_len=state + 1,
                              device=x.device)
            o = _sdpa_full(q, _repeat_kv(kv_cache["k"], g), _repeat_kv(kv_cache["v"], g), mask)
        else:
            o = _self_attention(q, k, v, g, cfg, x.device)
    elif state.prefill is not None:
        # the mixed engine's fused batch-1 row: one decode token per slot,
        # then one request's bucketed prefill chunk. The decode lanes append
        # first, then the chunk, both in place on this pool; mid-prefill
        # slots ride with lengths 0, so their appends go to the null page
        assert cfg.causal and b == 1, "the mixed step is one causal fused row"
        pre, nd = state.prefill, state.lengths.shape[0]
        append_paged(kv_cache, {"k": k[:, :nd].transpose(0, 1),
                                "v": v[:, :nd].transpose(0, 1)}, state)
        append_prefill_chunk(kv_cache, {"k": k[:, nd:], "v": v[:, nd:]}, pre)
        o_dec = ops.paged_decode_attn(q[0, :nd], kv_cache, state.page_table,
                                      state.lengths + 1, window=cfg.window)
        o_pre = _paged_chunk_attn(q[:, nd:], k[:, nd:], v[:, nd:], kv_cache, pre, g,
                                  cfg.window)
        o = torch.cat([o_dec[None].to(x.dtype), o_pre.to(x.dtype)], dim=1)
    elif s == 1 and state.chunk_len is None:
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


def paged_cross_attention(p, x: torch.Tensor, cfg, positions: torch.Tensor, cross_layer,
                          state: PagedState, a_fmt: Optional[str] = None) -> torch.Tensor:
    """The enc-dec decoder's cross-attention over one layer's write-once
    cross pages (written at admission by ``kv_cache.write_cross_pages``,
    only read here). A decode step (s == 1) runs the paged decode kernel
    with ``kv_lens = state.enc_lengths``: cross-attention is not causal, so
    the length mask is the whole mask. A prefill chunk (batch 1) gathers
    the cross pages once and attends under the encoder-length mask.
    Returns the projected output."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    b, s, _ = x.shape
    assert state.prefill is None, "enc-dec serving runs the alternating engine"
    xq = quant_act(x, a_fmt)
    q = linear(p["wq"], xq, p.get("bq")).reshape(b, s, h, hd)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
    if s == 1 and state.chunk_len is None:
        o = ops.paged_decode_attn(q[:, 0], cross_layer, state.cross_table, state.enc_lengths,
                                  window=0)
        o = o[:, None].to(x.dtype)
    else:
        assert b == 1, "streaming paged prefill is row-wise (batch 1)"
        cstate = PagedState(state.cross_table, state.enc_lengths)
        kf = gather_pages(cross_layer, "k", cstate).to(x.dtype)
        vf = gather_pages(cross_layer, "v", cstate).to(x.dtype)
        t = kf.shape[1]
        ok = torch.arange(t, device=x.device)[None, :] < state.enc_lengths[:1, None].to(x.device)
        mask = torch.where(ok.expand(s, t), 0.0, _NEG_INF).to(torch.float32)
        o = _sdpa_full(q, _repeat_kv(kf, g), _repeat_kv(vf, g), mask)
    return linear(p["wo"], quant_act(o.reshape(b, s, h * hd), a_fmt), p.get("bo"))
