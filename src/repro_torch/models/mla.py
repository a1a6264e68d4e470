"""Multi-head Latent Attention over the paged latent pool (port of the
paged branches of ``repro.models.mla``: DeepSeek-V2/V3, MiniCPM3).

Serving runs the absorbed form: ``wk_b`` is folded into the query and
``wv_b`` into the output, so attention runs in the (kv_lora_rank +
qk_rope_dim)-dim latent space against the compressed cache, which holds
only (c_kv, k_rope) per token and layer. Three paged modes, as in the
reference: a decode step (one token per row, appended, then read by
``ops.paged_mla_decode_attn``), a streaming-prefill chunk (batch 1,
attending the gathered history pages plus its own exact latents), and the
mixed engine's fused row of both. A packed ``wk_b`` / ``wv_b`` runs the
batched W4A8 kernel per head (``layers.batched_linear``; transposed for
``wk_b``, whose out rows are contracted). The chunk's attention is plain
torch, as it is plain ``jnp`` in the reference. Without a cache (the loss,
calibration, perplexity) MLA takes the reference's materialized form:
``wk_b`` and ``wv_b`` expand c_kv into per-head keys and values (plain
``linear``s, so packed weights run the W4A8 GEMM), the rope key is
broadcast over the heads and the attention is ``attention._sdpa_full`` or,
past ``attn_chunk`` tokens, ``_sdpa_chunked``, v at its own width. Over a
contiguous latent cache (``init_mla_cache``: ckv (B, max_seq, r), krope
(B, max_seq, dr), bf16) the prefill takes the materialized form and writes
the latents; the scalar-index decode step takes the absorbed form against
the whole cache under a length mask, its ``wk_b`` / ``wv_b`` on the
batched W4A8 kernel as on the pages.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.runtime.kv_cache import (PagedState, append_paged, append_prefill_chunk,
                                          gather_history)

from .attention import (_sdpa_chunked, _sdpa_full, block_mask, check_contiguous_step,
                        write_contiguous)
from .layers import (PackedLinear, ParamDef, apply_rope, batched_linear, linear, norm,
                     packed_head_view, quant_act)

__all__ = ["mla_params", "mla_attention", "init_mla_cache"]

_NEG_INF = -1e30


def mla_params(cfg):
    d, dt, m, h = cfg.d_model, cfg.param_dtype, cfg.mla, cfg.n_heads
    dq = m.qk_nope_dim + m.qk_rope_dim
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = ParamDef((m.q_lora_rank, d), ("lora", "embed"), dt)
        p["q_norm"] = {"scale": ParamDef((m.q_lora_rank,), ("lora",), dt, "ones")}
        p["wq_b"] = ParamDef((h * dq, m.q_lora_rank), ("heads", "lora"), dt)
    else:
        p["wq"] = ParamDef((h * dq, d), ("heads", "embed"), dt)
    p["wkv_a"] = ParamDef((m.kv_lora_rank + m.qk_rope_dim, d), ("lora", "embed"), dt)
    p["kv_norm"] = {"scale": ParamDef((m.kv_lora_rank,), ("lora",), dt, "ones")}
    p["wk_b"] = ParamDef((h * m.qk_nope_dim, m.kv_lora_rank), ("heads", "lora"), dt)
    p["wv_b"] = ParamDef((h * m.v_head_dim, m.kv_lora_rank), ("heads", "lora"), dt)
    p["wo"] = ParamDef((d, h * m.v_head_dim), ("embed", "heads"), dt)
    return p


def init_mla_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device=None):
    """A zeroed contiguous latent cache: {"ckv": (B, max_seq, r), "krope":
    (B, max_seq, dr)}."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, m.qk_rope_dim), dtype=dtype, device=device)}


def _project_q(p, xq, cfg):
    m, h = cfg.mla, cfg.n_heads
    if "wq_a" in p:
        ql = norm(p["q_norm"], linear(p["wq_a"], xq), "rmsnorm", cfg.norm_eps)
        q = linear(p["wq_b"], ql)
    else:
        q = linear(p["wq"], xq)
    b, s = xq.shape[:2]
    q = q.reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _chunk_latents(c_kv, k_rope, pool_layer, state: PagedState):
    """A streaming chunk's keys: the gathered history pages (columns before
    the chunk start) plus its own exact latents, and the additive mask
    (1, 1, S, W) that hides history at or past the start and applies tril
    within the chunk. All bf16, as the reference concatenates them."""
    s = c_kv.shape[1]
    hist, hist_len = gather_history(pool_layer, state, s)
    ckv, krope = c_kv.to(torch.bfloat16), k_rope.to(torch.bfloat16)
    if hist_len:
        ckv = torch.cat([hist["ckv"].to(torch.bfloat16), ckv], dim=1)
        krope = torch.cat([hist["krope"].to(torch.bfloat16), krope], dim=1)
    dev = c_kv.device
    start = state.lengths[0].to(dev)
    ok = torch.cat([(torch.arange(hist_len, device=dev)[None, :] < start).expand(s, hist_len),
                    torch.ones((s, s), dtype=torch.bool, device=dev).tril()], dim=1)
    return ckv, krope, torch.where(ok, 0.0, _NEG_INF).to(torch.float32)[None, None]


def _chunk_attn(q_lat, q_rope, ckv, krope, mask, scale_dim: int, dtype):
    """Latent attention of a chunk's queries over (history | chunk):
    bf16 operands, f32 scores and softmax, the context in ``dtype``."""
    s_lat = torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
    s_rope = torch.einsum("bshr,btr->bhst", q_rope.float(), krope.to(q_rope.dtype).float())
    att = torch.softmax((s_lat + s_rope) / torch.tensor(float(scale_dim)).sqrt() + mask, -1)
    ctx = torch.einsum("bhst,btr->bhsr", att.to(ckv.dtype).float(), ckv.float())
    return ctx.transpose(1, 2).to(dtype)


def _materialized(p, q_nope, q_rope, c_kv, k_rope, cfg) -> torch.Tensor:
    """Cache-free attention of a whole sequence at positions 0..S-1: keys
    and values expanded from the latents, (B, S, H * v_head_dim) out."""
    m, h = cfg.mla, cfg.n_heads
    b, s = c_kv.shape[:2]
    k_nope = linear(p["wk_b"], c_kv).reshape(b, s, h, m.qk_nope_dim)
    v = linear(p["wv_b"], c_kv).reshape(b, s, h, m.v_head_dim)
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h.to(k_nope.dtype)], dim=-1)
    if s > cfg.attn_chunk:
        o = _sdpa_chunked(q_full, k_full, v, cfg.causal, cfg.window, cfg.attn_chunk)
    else:
        o = _sdpa_full(q_full, k_full, v, block_mask(s, s, 0, 0, cfg.causal, 0,
                                                     device=c_kv.device))
    return o.reshape(b, s, h * m.v_head_dim)


def mla_attention(p, x: torch.Tensor, cfg, positions: torch.Tensor, kv_cache=None,
                  state=None, a_fmt: Optional[str] = None):
    """Returns (out, kv_cache). ``kv_cache`` is one layer's latent pool
    slice, written in place; ``positions`` (B, S) the rope positions. A
    state with ``prefill`` is a mixed step (x the fused (1, slots + S)
    row); one with ``chunk_len`` a prefill chunk; otherwise x is one decode
    token per row. An ``int`` state is the contiguous cache's index
    (``kv_cache`` one layer's {"ckv", "krope"}): the latents are written
    there; S > 1 takes the materialized form within x, S == 1 the absorbed
    form over the cache's first index + 1 positions; S > 1 at an index past
    0 raises (F11). Without a state x is a whole sequence at ``positions``
    0..S-1 (the materialized form; no cache)."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    scale_dim = m.qk_nope_dim + m.qk_rope_dim
    scale = 1.0 / float(scale_dim) ** 0.5

    xq = quant_act(x, a_fmt)
    q_nope, q_rope = _project_q(p, xq, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = linear(p["wkv_a"], xq)  # (B, S, r + dr)
    c_kv = norm(p["kv_norm"], kv_a[..., :m.kv_lora_rank], "rmsnorm", cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    contiguous = isinstance(state, int)
    if contiguous:
        check_contiguous_step(s, state)
        write_contiguous(kv_cache, {"ckv": c_kv, "krope": k_rope}, state)
    if state is None or (contiguous and s > 1):
        o = _materialized(p, q_nope, q_rope, c_kv, k_rope, cfg)
        return linear(p["wo"], quant_act(o, a_fmt), p.get("bo")), kv_cache

    # q absorbed into the latent space: (B, S, H, r)
    if isinstance(p["wk_b"], PackedLinear):
        q_h = q_nope.permute(2, 0, 1, 3).reshape(h, b * s, m.qk_nope_dim)
        q_lat = batched_linear(packed_head_view(p["wk_b"], h), q_h, transpose_w=True,
                               quantize_acts=False)
        q_lat = q_lat.reshape(h, b, s, m.kv_lora_rank).permute(1, 2, 0, 3).to(x.dtype)
    else:
        wk_b = p["wk_b"].reshape(h, m.qk_nope_dim, m.kv_lora_rank)
        q_lat = torch.einsum("bshn,hnr->bshr", q_nope.float(), wk_b.float()).to(x.dtype)

    if contiguous:
        mask = block_mask(s, kv_cache["ckv"].shape[1], state, 0, False, 0, kv_len=state + s,
                          device=x.device)[None, None]
        ctx_lat = _chunk_attn(q_lat, q_rope, kv_cache["ckv"], kv_cache["krope"], mask, scale_dim,
                              x.dtype)
    elif state.prefill is not None:
        # the mixed engine's fused batch-1 row: one decode token per slot,
        # then one request's bucketed prefill chunk. Decode latents append
        # at each slot's true position (mid-prefill slots ride with lengths
        # 0, so theirs go to the null page), then the chunk; the decode rows
        # run the latent decode kernel exactly as a pure decode step does
        assert cfg.causal and b == 1, "the mixed step is one causal fused row"
        pre, nd = state.prefill, state.lengths.shape[0]
        append_paged(kv_cache, {"ckv": c_kv[:, :nd].transpose(0, 1),
                                "krope": k_rope[:, :nd].transpose(0, 1)}, state)
        append_prefill_chunk(kv_cache, {"ckv": c_kv[:, nd:], "krope": k_rope[:, nd:]}, pre)
        ctx_dec = ops.paged_mla_decode_attn(q_lat[0, :nd], q_rope[0, :nd], kv_cache,
                                            state.page_table, state.lengths + 1, scale)
        ckv, krope, mask = _chunk_latents(c_kv[:, nd:], k_rope[:, nd:], kv_cache, pre)
        ctx_pre = _chunk_attn(q_lat[:, nd:], q_rope[:, nd:], ckv, krope, mask, scale_dim,
                              x.dtype)
        ctx_lat = torch.cat([ctx_dec[None].to(x.dtype), ctx_pre], dim=1)
    elif s == 1 and state.chunk_len is None:
        append_paged(kv_cache, {"ckv": c_kv, "krope": k_rope}, state)
        ctx_lat = ops.paged_mla_decode_attn(q_lat[:, 0], q_rope[:, 0], kv_cache,
                                            state.page_table, state.lengths + 1,
                                            scale)[:, None].to(x.dtype)
    else:
        assert cfg.causal and b == 1, "streaming paged prefill is causal and row-wise"
        append_prefill_chunk(kv_cache, {"ckv": c_kv, "krope": k_rope}, state)
        ckv, krope, mask = _chunk_latents(c_kv, k_rope, kv_cache, state)
        ctx_lat = _chunk_attn(q_lat, q_rope, ckv, krope, mask, scale_dim, x.dtype)

    if isinstance(p["wv_b"], PackedLinear):
        ctx_h = ctx_lat.permute(2, 0, 1, 3).reshape(h, b * s, m.kv_lora_rank)
        o = batched_linear(packed_head_view(p["wv_b"], h), ctx_h, quantize_acts=False)
        o = o.reshape(h, b, s, m.v_head_dim).permute(1, 2, 0, 3).to(x.dtype)
    else:
        wv_b = p["wv_b"].reshape(h, m.v_head_dim, m.kv_lora_rank)
        o = torch.einsum("bshr,hvr->bshv", ctx_lat.float(), wv_b.float()).to(x.dtype)
    out = linear(p["wo"], quant_act(o.reshape(b, s, h * m.v_head_dim), a_fmt), p.get("bo"))
    return out, kv_cache
