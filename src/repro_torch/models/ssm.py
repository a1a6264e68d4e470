"""State-space / linear-attention substrate (port of ``repro.models.ssm``).

``gla_chunked`` is the chunkwise engine of the recurrence
    S_t = a_t * S_{t-1} + k_t v_t^T ,   y_t = q_t^T S_t
with a per-(head, step) scalar decay a_t = exp(log_a_t) <= 1: quadratic
attention with decay weights inside a chunk, the state carried from chunk
to chunk by a Python loop (``lax.scan``'s place). Every exponent is <= 0,
so no stabilizer is needed (Mamba2's SSD: a_t = exp(A * dt), A < 0).

The Mamba2 block: in_proj -> causal depthwise conv(4) -> SSD -> gated
RMSNorm -> out_proj, its single-step decode carrying (ssm state, conv
tail). The projections are quantizable linears (W4A8 on the serving path);
the recurrence runs in plain PyTorch in f32, as the reference runs it in
plain jnp.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import ParamDef, linear, norm, quant_act, softplus

__all__ = ["gla_chunked", "gla_step", "causal_conv", "mamba2_params", "mamba2_block",
           "init_mamba2_cache", "silu32"]


def silu32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu of an f32 tensor: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _pad_time(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``pad`` steps appended to axis 1 (time), filled with ``value``."""
    spec = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, spec, value=value)


# ---------------------------------------------------------------------------
# Chunkwise gated linear attention
# ---------------------------------------------------------------------------
def gla_chunked(q, k, v, log_a, s0=None, chunk: int = 256):
    """q, k: (B, T, H, dk); v: (B, T, H, dv); log_a: (B, T, H) (<= 0).
    ``s0``: the incoming state (B, H, dk, dv) or None (zeros). T is padded
    to whole chunks with decay 1 (log_a 0) and zero q, k, v on the pad.
    Returns (y (B, T, H, dv) in v's dtype, s_final (B, H, dk, dv) f32)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:
        q, k, v, log_a = (_pad_time(a, pad) for a in (q, k, v, log_a))
    qs = q.reshape(b, nc, chunk, h, dk).float()
    ks = k.reshape(b, nc, chunk, h, dk).float()
    vs = v.reshape(b, nc, chunk, h, dv).float()
    las = log_a.reshape(b, nc, chunk, h).float()
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device) if s0 is None
         else s0.float())
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    ys = []
    for ci in range(nc):
        qb, kb, vb, lab = qs[:, ci], ks[:, ci], vs[:, ci], las[:, ci]
        lcum = torch.cumsum(lab, dim=1)  # (B, c, H) inclusive
        ltot = lcum[:, -1]  # (B, H)
        # intra-chunk: w_ts = exp(L_t - L_s) * (q_t . k_s), s <= t
        scores = torch.einsum("bthd,bshd->bhts", qb, kb)
        lt = lcum.permute(0, 2, 1)  # (B, H, c)
        # mask s > t BEFORE the exp: the upper triangle's exponent is
        # positive, and inf * 0 would be NaN
        expo = lt[:, :, :, None] - lt[:, :, None, :]
        decay = torch.exp(torch.where(causal, expo, float("-inf")))
        y_intra = torch.einsum("bhts,bshd->bthd", scores * decay, vb)
        # inter-chunk: y_t += exp(L_t) q_t^T S_in
        y_inter = torch.einsum("bthd,bhdv->bthv", qb * torch.exp(lcum)[..., None], s)
        # S_out = exp(L_tot) S_in + sum_s exp(L_tot - L_s) k_s v_s^T
        kw = kb * torch.exp(ltot[:, None] - lcum)[..., None]
        s = s * torch.exp(ltot)[..., None, None] + torch.einsum("bshd,bshv->bhdv", kw, vb)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, dv)[:, :t]
    return y.to(v.dtype), s


def gla_step(q, k, v, log_a, s):
    """One recurrent step. q, k: (B, H, dk); v: (B, H, dv); log_a: (B, H);
    s: (B, H, dk, dv). Returns (y (B, H, dv) in v's dtype, s' f32)."""
    a = torch.exp(log_a.float())[..., None, None]
    s_new = s * a + torch.einsum("bhd,bhv->bhdv", k.float(), v.float())
    y = torch.einsum("bhd,bhdv->bhv", q.float(), s_new)
    return y.to(v.dtype), s_new


# ---------------------------------------------------------------------------
# Causal depthwise conv (width d_conv) with decode state
# ---------------------------------------------------------------------------
def causal_conv(x, w, conv_state=None):
    """x: (B, T, C); w: (d_conv, C); ``conv_state``: the previous d_conv - 1
    inputs (B, d_conv - 1, C) or None (zeros). Shifted adds in f32 (d_conv
    is 4), then silu. Returns (y in x's dtype, the new tail
    (B, d_conv - 1, C): the last d_conv - 1 inputs, the history's included
    when T is shorter)."""
    dconv, c = w.shape
    b, t, _ = x.shape
    hist = (torch.zeros((b, dconv - 1, c), dtype=x.dtype, device=x.device)
            if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([hist, x], dim=1)  # (B, T + dconv - 1, C)
    y = torch.zeros((b, t, c), dtype=torch.float32, device=x.device)
    for j in range(dconv):
        y = y + xp[:, j:j + t].float() * w[j].float()
    new_state = xp[:, xp.shape[1] - (dconv - 1):]
    return silu32(y).to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
def _mamba_dims(cfg):
    ssm = cfg.ssm
    d_in = cfg.d_model * ssm.expand
    return d_in, d_in // ssm.head_dim, ssm.d_state, ssm.head_dim, ssm.d_conv


def mamba2_params(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, h, n, _, dconv = _mamba_dims(cfg)
    proj_out = 2 * d_in + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": ParamDef((proj_out, d), ("ffn", "embed"), dt),
        "conv_w": ParamDef((dconv, d_in + 2 * n), ("conv", None), dt, "normal", 0.5),
        "dt_bias": ParamDef((h,), (None,), "float32", "zeros"),
        "a_log": ParamDef((h,), (None,), "float32", "ones"),
        "d_skip": ParamDef((h,), (None,), "float32", "ones"),
        "out_norm": {"scale": ParamDef((d_in,), ("ffn",), dt, "ones")},
        "out_proj": ParamDef((d, d_in), ("embed", "ffn"), dt),
    }


def init_mamba2_cache(cfg, batch: int, device=None):
    """A pristine state per row: the SSM state (B, H, N, P) and the conv
    tail (B, d_conv - 1, d_in + 2N), both f32 zeros."""
    d_in, h, n, p_dim, dconv = _mamba_dims(cfg)
    return {"ssm": torch.zeros((batch, h, n, p_dim), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, dconv - 1, d_in + 2 * n), dtype=torch.float32,
                                device=device)}


def mamba2_block(p, x, cfg, cache=None, a_fmt: Optional[str] = None):
    """x: (B, T, d). ``cache``: {'ssm', 'conv'} per row, or None (a whole
    sequence from a zero state). One token with a cache takes the
    recurrent step, anything else the chunked form (a prefill chunk of one
    token is a step too, as in the reference). Returns (y, new_cache)."""
    d_in, h, n, p_dim, _ = _mamba_dims(cfg)
    b, t, _ = x.shape
    zxbcdt = linear(p["in_proj"], quant_act(x, a_fmt))
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: 2 * d_in + 2 * n]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - h:]

    xbc, new_conv = causal_conv(xbc, p["conv_w"], None if cache is None else cache["conv"])
    xs = xbc[..., :d_in]
    b_in = xbc[..., d_in: d_in + n]  # (B, T, N), shared across heads (groups=1)
    c_in = xbc[..., d_in + n:]

    dt = softplus(dt_raw.float() + p["dt_bias"])  # (B, T, H)
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    log_decay = a[None, None, :] * dt  # (B, T, H) <= 0
    v = xs.reshape(b, t, h, p_dim).float() * dt[..., None]  # dt * x per head
    q = c_in[:, :, None, :].expand(b, t, h, n)
    k = b_in[:, :, None, :].expand(b, t, h, n)
    s0 = None if cache is None else cache["ssm"]
    if t == 1 and cache is not None:
        y1, s_new = gla_step(q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0], s0)
        y = y1[:, None]
    else:  # (B, H, dk, dv) layout: dk = N (state), dv = P (head channel)
        y, s_new = gla_chunked(q, k, v, log_decay, s0=s0, chunk=cfg.ssm.chunk)
    y = y + xs.reshape(b, t, h, p_dim).float() * p["d_skip"].float()[None, None, :, None]
    y = norm(p["out_norm"], y.reshape(b, t, d_in).to(x.dtype), "rmsnorm", cfg.norm_eps)
    y = y * silu32(z.float()).to(y.dtype)
    out = linear(p["out_proj"], quant_act(y, a_fmt))
    new_cache = None
    if cache is not None:
        new_cache = {"ssm": s_new, "conv": new_conv.to(cache["conv"].dtype)}
    return out, new_cache
