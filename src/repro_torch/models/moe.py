"""Mixture-of-Experts layer (port of ``repro.models.moe``: OLMoE 64 experts
top-8, DeepSeek-V3 256 experts top-8 + shared).

The capacity-bounded one-hot dispatch of the reference: tokens are taken in
groups of ``group_size``; each group sends at most C = group_size * top_k /
E * capacity_factor tokens to each expert, earlier tokens first, and a
dropped assignment lets the token's residual pass. The router is an f32
product with a softmax over the experts. Expert weights are stacked:
wg/wu (E, d_ff, d), wd (E, d, d_ff); the expert GEMMs run over the
expert-major layout (E, G*C, d) through ``layers.batched_linear``, so a
packed (W4A8) stack runs the batched W4A8 kernel with its in-kernel FP8
activation quantization (``kernels.ops.w4a8_matmul_batched``). Serving
passes ``group_size=1`` (see ``transformer.block_apply``): every token is
its own group, so each expert slab holds one row per token of the
program, zero where the token did not pick the expert. The expert-parallel
mesh paths (``moe_a2a``, ``moe_decode_ep``) come with the multi-device
slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import ParamDef, activation, batched_linear, linear, mlp, mlp_params, quant_act

__all__ = ["moe_params", "moe_layer", "top_k"]


def moe_params(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    m = cfg.moe
    e, ff = m.n_experts, m.d_ff
    p = {
        "router": ParamDef((e, d), ("expert", "embed"), dt, "normal", 1.0),
        "wu": ParamDef((e, ff, d), ("expert", "ffn", "embed"), dt),
        "wd": ParamDef((e, d, ff), ("expert", "embed", "ffn"), dt),
    }
    if cfg.mlp_gated:
        p["wg"] = ParamDef((e, ff, d), ("expert", "ffn", "embed"), dt)
    if m.n_shared_experts:
        shared_ff = (m.shared_d_ff or ff) * m.n_shared_experts
        p["shared"] = mlp_params(cfg, d_ff=shared_ff)
    return p


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, largest first, and their
    indices: ``jax.lax.top_k``'s order, where the lower index comes first
    among equal values (a stable descending sort; ``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_masks(logits: torch.Tensor, k: int, capacity: int):
    """logits: (G, S, E) f32 -> (dispatch (G, S, E, C), combine (G, S, E, C)
    f32, probs (G, S, E) f32). A token's position in its expert follows
    token order, then k-slot order (drop-late)."""
    g, s, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = top_k(probs, k)
    # normalize the chosen probabilities (deepseek/olmoe convention)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    ohf = F.one_hot(top_idx, e).float().reshape(g, s * k, e)
    pos = torch.cumsum(ohf, dim=1) - ohf  # position of each assignment in its expert
    keep = pos < capacity
    posc = torch.where(keep, pos, 0.0).long()
    pos_oh = F.one_hot(posc, capacity).float() * keep[..., None]
    disp = (ohf[..., None] * pos_oh).reshape(g, s, k, e, capacity)
    comb = disp * top_p[..., None, None]
    return disp.sum(2), comb.sum(2), probs


def moe_layer(p, x: torch.Tensor, cfg, a_fmt: Optional[str] = None, group_size: int = 1024):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    g = max(n // group_size, 1)
    sg = -(-n // g)
    pad = g * sg - n  # MTP paths feed S-1 tokens; pad to a full grid
    e = m.n_experts
    capacity = max(int(sg * m.top_k / e * m.capacity_factor), 1)

    xf = x.reshape(n, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    xf = xf.reshape(g, sg, d)
    logits = linear(p["router"], xf.float())  # router in f32
    dispatch, combine, probs = _dispatch_masks(logits, m.top_k, capacity)
    dispatch = dispatch.to(x.dtype)

    # expert inputs (G, E, C, d): one nonzero term per entry, so the f32
    # product rounds back to the bf16 input exactly
    xq = quant_act(xf, a_fmt)
    ex_in = torch.einsum("gsec,gsd->gecd", dispatch.float(), xq.float()).to(x.dtype)

    # expert-major layout (E, G*C, d): a packed expert stack runs the
    # batched W4A8 kernel directly
    xe = ex_in.transpose(0, 1).reshape(e, g * capacity, d)
    up = batched_linear(p["wu"], xe)  # (E, G*C, ff)
    if "wg" in p:
        h = activation(batched_linear(p["wg"], xe), cfg.act_kind) * up
    else:
        h = activation(up, cfg.act_kind)
    hq = quant_act(h, a_fmt)
    eo = batched_linear(p["wd"], hq)  # (E, G*C, d)
    ex_out = eo.reshape(e, g, capacity, d).transpose(0, 1)

    out = torch.einsum("gsec,gecd->gsd", combine, ex_out.float())
    out = out.reshape(g * sg, d)
    if pad:
        out = out[:n]
    out = out.reshape(b, s, d).to(x.dtype)

    if m.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg, a_fmt=a_fmt)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    frac_tokens = dispatch.float().sum(-1).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_probs).sum()
    return out, aux
