"""xLSTM blocks (port of ``repro.models.xlstm``; Beck et al. 2024): mLSTM
(matrix memory, parallelizable) and sLSTM (scalar memory, sequential),
assembled in alternating pairs.

mLSTM cell (stabilized exponential gating):
    weight(t, s) = exp(L_t - L_s + i_s - m_t),  L = cumsum(logsigmoid(f)),
    m_t = running max of the exponent (flash-attention-style online max),
    h_t = [sum_s w(t,s) (q_t.k_s/sqrt(dk)) v_s] / max(|den_t|, exp(-m_t)).
Evaluated blockwise like chunked attention (prefill) and as an exact
recurrent step with a (C, n, m) carry (decode); a Python loop over the
chunks takes ``lax.scan``'s place.

sLSTM: per-head scalar memory with recurrent gate preactivations through a
block-diagonal R, one step a token (inherently sequential). Decode is one
step of the same cell.

The projections are quantizable linears (W4A8 on the serving path); the
cells run in plain PyTorch in f32, as the reference runs them in plain jnp.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import ParamDef, as_dense, linear, log_sigmoid, norm, quant_act, xla_tanh
from .ssm import _pad_time, causal_conv, silu32

__all__ = ["mlstm_params", "mlstm_block", "init_mlstm_cache", "slstm_params", "slstm_block",
           "init_slstm_cache"]

_NEG = -1e30  # the stabilizer's floor, and log_i on the chunk pad
MLSTM_CHUNK = 256  # the reference's fixed mLSTM chunk


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_dims(cfg):
    d_in = 2 * cfg.d_model  # projection factor 2
    h = cfg.n_heads
    return d_in, h, d_in // h


def mlstm_params(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, h, _ = _mlstm_dims(cfg)
    return {
        "up_proj": ParamDef((2 * d_in, d), ("ffn", "embed"), dt),  # x branch + z gate
        "conv_w": ParamDef((4, d_in), ("conv", None), dt, "normal", 0.5),
        "wq": ParamDef((d_in, d_in), ("heads", "ffn"), dt),
        "wk": ParamDef((d_in, d_in), ("heads", "ffn"), dt),
        "wv": ParamDef((d_in, d_in), ("heads", "ffn"), dt),
        "wi": ParamDef((h, d_in), (None, "ffn"), dt, "normal", 0.5),
        "wf": ParamDef((h, d_in), (None, "ffn"), dt, "normal", 0.5),
        "bi": ParamDef((h,), (None,), "float32", "zeros"),
        "bf": ParamDef((h,), (None,), "float32", "ones"),
        "out_norm": {"scale": ParamDef((d_in,), ("ffn",), dt, "ones")},
        "down_proj": ParamDef((d, d_in), ("embed", "ffn"), dt),
    }


def init_mlstm_cache(cfg, batch: int, device=None):
    """A pristine state per row: C and n zeros, the stabilizer m at -1e30
    (not 0: a zero m would weigh the first token by exp(-i) instead of 1),
    the conv tail zeros; all f32."""
    d_in, h, dk = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dk, dk), **f32),
            "n": torch.zeros((batch, h, dk), **f32),
            "m": torch.full((batch, h), _NEG, **f32),
            "conv": torch.zeros((batch, 3, d_in), **f32)}


def _bf16_scale(dk: int, dtype) -> torch.Tensor:
    """The reference's ``1.0 / jnp.sqrt(dk)``: an f32 value, weakly typed,
    so it is rounded to q's dtype before it multiplies q."""
    return (1.0 / torch.sqrt(torch.tensor(float(dk), dtype=torch.float32))).to(dtype)


def _mlstm_chunked(q, k, v, log_f, log_i, chunk: int, s0=None):
    """q, k, v: (B, T, H, dk); log_f (<= 0), log_i: (B, T, H). ``s0``: the
    incoming (c, n, m) state in the recurrent step's convention (what
    ``_mlstm_step`` carries), so a prompt continues chunk by chunk; None
    starts from zeros and m = -1e30. Returns (h (B, T, H, dk) f32, (c, n, m))."""
    b, t, h, dk = q.shape
    chunk = min(chunk, t)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:
        q, k, v, log_f = (_pad_time(a, pad) for a in (q, k, v, log_f))
        log_i = _pad_time(log_i, pad, _NEG)
    qs = (q * _bf16_scale(dk, q.dtype)).reshape(b, nc, chunk, h, dk).float()
    ks = k.reshape(b, nc, chunk, h, dk).float()
    vs = v.reshape(b, nc, chunk, h, dk).float()
    lfs = log_f.reshape(b, nc, chunk, h).float()
    lis = log_i.reshape(b, nc, chunk, h).float()
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    if s0 is None:
        c_st = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=q.device)
        n_st = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
        m_st = torch.full((b, h), _NEG, dtype=torch.float32, device=q.device)
    else:
        c_st, n_st, m_st = (s.float() for s in s0)
    hs = []
    for ci in range(nc):
        # the carry is in the step convention: c/n stabilized by m_st and
        # decayed to the end of the previous chunk. Exponents are
        # chunk-local (L from the chunk start): the decay from the previous
        # chunk's end to position t is exp(L_t), so e_inter = L_t + m_st
        qb, kb, vb = qs[:, ci], ks[:, ci], vs[:, ci]
        lf, li = lfs[:, ci], lis[:, ci]
        lcum = torch.cumsum(lf, dim=1)  # (B, c, H)
        lt = lcum.permute(0, 2, 1)  # (B, H, c)
        # intra-chunk exponent E_ts = L_t - L_s + i_s, -inf above the diagonal
        e_intra = lt[:, :, :, None] - lt[:, :, None, :] + li.permute(0, 2, 1)[:, :, None, :]
        e_intra = torch.where(causal, e_intra, float("-inf"))
        e_inter = lt + m_st[..., None]  # (B, H, c)
        m_new = torch.maximum(e_intra.amax(-1), e_inter)
        m_new = torch.clamp_min(m_new, _NEG)
        w = torch.exp(e_intra - m_new[..., None])  # (B, H, t, s)
        scores = torch.einsum("bthd,bshd->bhts", qb, kb) * w
        num = torch.einsum("bhts,bshd->bthd", scores, vb)
        den = scores.sum(-1)  # (B, H, t)
        inter_w = torch.exp(e_inter - m_new)  # (B, H, c)
        num = num + torch.einsum("bthd,bhdv->bthv", qb, c_st) * inter_w.permute(0, 2, 1)[..., None]
        den = den + torch.einsum("bthd,bhd->bht", qb, n_st) * inter_w
        den_t = den.permute(0, 2, 1)  # (B, t, H)
        m_t = m_new.permute(0, 2, 1)
        hs.append(num / torch.maximum(den_t.abs(), torch.exp(-m_t))[..., None])
        # the state to the chunk's end, stabilized by m at its last position
        l_tot = lcum[:, -1]  # (B, H)
        m_end = m_t[:, -1]  # (B, H)
        wk_exp = torch.exp(l_tot[:, None] - lcum + li - m_end[:, None])  # (B, c, H)
        kb_w = kb * wk_exp[..., None]  # the gate folded into k first
        carry = torch.exp(m_st + l_tot - m_end)
        c_st = c_st * carry[..., None, None] + torch.einsum("bshd,bshv->bhdv", kb_w, vb)
        n_st = n_st * carry[..., None] + torch.einsum("bshd,bsh->bhd", kb, wk_exp)
        m_st = m_end
    hh = torch.stack(hs, dim=1).reshape(b, nc * chunk, h, dk)[:, :t]
    return hh, (c_st, n_st, m_st)


def _mlstm_step(q, k, v, log_f, log_i, c, n, m):
    """The exact recurrent step. q, k, v: (B, H, dk); gates: (B, H);
    (c, n, m) the carried state. Returns (h (B, H, dk) f32, (c', n', m'))."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    q = q.float() * scale.to(q.device)
    k, v = k.float(), v.float()
    m_new = torch.maximum(log_f + m, log_i)
    fw = torch.exp(log_f + m - m_new)
    iw = torch.exp(log_i - m_new)
    c_new = c * fw[..., None, None] + iw[..., None, None] * torch.einsum("bhd,bhv->bhdv", k, v)
    n_new = n * fw[..., None] + iw[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, c_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h_out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h_out, (c_new, n_new, m_new)


def mlstm_block(p, x, cfg, cache=None, a_fmt: Optional[str] = None):
    """x: (B, T, d) -> (y, new_cache). ``cache``: {'c', 'n', 'm', 'conv'}
    per row, or None (a whole sequence from the pristine state). One token
    with a cache takes the step; a prefill chunk continues the carried
    state through the chunked form."""
    d_in, h, dk = _mlstm_dims(cfg)
    b, t, _ = x.shape
    up = linear(p["up_proj"], quant_act(x, a_fmt))
    xm, z = up[..., :d_in], up[..., d_in:]
    xc, new_conv = causal_conv(xm, p["conv_w"], None if cache is None else cache["conv"])
    xcq = quant_act(xc, a_fmt)
    q = linear(p["wq"], xcq).reshape(b, t, h, dk)
    k = linear(p["wk"], xcq).reshape(b, t, h, dk)
    v = xm.reshape(b, t, h, dk)  # the value from the un-conv'd branch
    wi = as_dense(p["wi"], torch.float32).float()
    wf = as_dense(p["wf"], torch.float32).float()
    log_i = xc.float() @ wi.t() + p["bi"]
    log_f = log_sigmoid(xc.float() @ wf.t() + p["bf"])
    new_cache = None
    if cache is not None and t == 1:
        hh, (c_n, n_n, m_n) = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0],
                                          cache["c"], cache["n"], cache["m"])
        hh = hh[:, None]
    else:
        s0 = None if cache is None else (cache["c"], cache["n"], cache["m"])
        hh, (c_n, n_n, m_n) = _mlstm_chunked(q, k, v, log_f, log_i, MLSTM_CHUNK, s0=s0)
    if cache is not None:
        new_cache = {"c": c_n, "n": n_n, "m": m_n, "conv": new_conv.float()}
    hh = hh.reshape(b, t, d_in).to(x.dtype) + xc  # the learnable skip simplified to the conv's
    hh = norm(p["out_norm"], hh, "rmsnorm", cfg.norm_eps)
    hh = hh * silu32(z.float()).to(hh.dtype)
    return linear(p["down_proj"], quant_act(hh, a_fmt)), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_params(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    h = cfg.n_heads
    dh = d // h
    return {
        "w_gates": ParamDef((4 * d, d), ("ffn", "embed"), dt),  # i, f, z, o from x
        "r_gates": ParamDef((h, 4 * dh, dh), (None, None, None), dt, "normal", 0.5),
        "b_gates": ParamDef((4 * d,), ("ffn",), "float32", "zeros"),
        "out_norm": {"scale": ParamDef((d,), ("embed",), dt, "ones")},
        # the post-cell gated FFN (projection factor 4/3, the xLSTM paper's)
        "ffn_up": ParamDef((2 * (4 * d // 3), d), ("ffn", "embed"), dt),
        "ffn_down": ParamDef((d, 4 * d // 3), ("embed", "ffn"), dt),
    }


def init_slstm_cache(cfg, batch: int, device=None):
    """A pristine state per row: c, m and h zeros and the normalizer n at
    1 (not 0), all f32 (B, d)."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.ones((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32), "h": torch.zeros((batch, d), **f32)}


def _slstm_cell(gx, state, r_gates, h_heads: int, dh: int):
    """One timestep. gx: (B, 4d) gate preactivations from x; state (c, n,
    m, h) of (B, d) each; r_gates (H, 4dh, dh) f32. Returns (state', h')."""
    c, n, m, h_prev = state
    b = gx.shape[0]
    rec = torch.einsum("bhd,hgd->bhg", h_prev.reshape(b, h_heads, dh), r_gates)
    pre = (gx + rec.reshape(b, 4 * h_heads * dh)).reshape(b, 4, h_heads * dh)
    i_t, f_t, z_t, o_t = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    lf = log_sigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    iw = torch.exp(i_t - m_new)
    fw = torch.exp(lf + m - m_new)
    c_new = fw * c + iw * xla_tanh(z_t)
    n_new = fw * n + iw
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_block(p, x, cfg, cache=None, a_fmt: Optional[str] = None):
    """x: (B, T, d) -> (y, new_cache): the cell one token at a time (a
    Python loop over T), then the post-cell norm and gated FFN.
    ``cache``: {'c', 'n', 'm', 'h'} per row, or None (the pristine state)."""
    d = cfg.d_model
    h_heads = cfg.n_heads
    dh = d // h_heads
    b, t, _ = x.shape
    gx = linear(p["w_gates"], quant_act(x, a_fmt)).float() + p["b_gates"]  # (B, T, 4d)
    if cache is not None:
        st = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        st = tuple(v for v in init_slstm_cache(cfg, b, x.device).values())
    r_gates = as_dense(p["r_gates"], torch.float32).float()
    hs = []
    for i in range(t):
        st, h_t = _slstm_cell(gx[:, i], st, r_gates, h_heads, dh)
        hs.append(h_t)
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B, T, d)
    y = norm(p["out_norm"], y, "rmsnorm", cfg.norm_eps)
    upd = linear(p["ffn_up"], quant_act(y, a_fmt))
    half = upd.shape[-1] // 2
    y = linear(p["ffn_down"], quant_act(
        silu32(upd[..., :half].float()).to(x.dtype) * upd[..., half:], a_fmt))
    new_cache = None
    if cache is not None:
        new_cache = dict(zip(("c", "n", "m", "h"), st))
    return y, new_cache
