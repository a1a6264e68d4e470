"""Loss computation (port of ``repro.models.losses``): sequence-chunked
cross entropy, so the live logits buffer is (B, chunk, vocab) f32 and never
(B, S, vocab), and DeepSeek-V3's multi-token prediction loss."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["chunked_xent", "mtp_loss"]


class _HeadLogits(torch.autograd.Function):
    """f32 logits (B, c, V) of hidden (B, c, d) against the head (V, d),
    the products of their own dtype's values summed in f32 (the
    reference's ``dot_general`` with ``preferred_element_type=f32``). The
    backward is that dot's transpose: each operand's cotangent summed in
    f32 and rounded to its dtype, so a bf16 head takes a bf16 cotangent
    from every chunk, as the reference's scan adds them. Only the operands
    are kept for the backward pass, not their f32 copies."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.matmul(h.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = torch.matmul(g, w.float()).to(h.dtype)
        gw = torch.einsum("bcv,bcd->vd", g, h.float()).to(w.dtype)
        return gh, gw


def chunked_xent(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, chunk: int = 512):
    """hidden (B, S, d); head_w (V, d); labels (B, S) int; mask (B, S)
    float / bool or None. Returns (mean_nll, n_tokens), f32 scalars: the
    summed nll and token count accumulate chunk by chunk, as the
    reference's scan does (and so does the head's gradient, see
    ``_HeadLogits``)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    mask = (torch.ones((b, s), dtype=torch.float32, device=hidden.device) if mask is None
            else mask.to(torch.float32))
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tok_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, nc * chunk, chunk):
        logits = _HeadLogits.apply(hidden[:, c0:c0 + chunk], head_w)  # (B, c, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c0:c0 + chunk].long()[..., None])[..., 0]
        m = mask[:, c0:c0 + chunk]
        nll_sum = nll_sum + torch.sum((lse - gold) * m)
        tok_sum = tok_sum + torch.sum(m)
    return nll_sum / torch.clamp(tok_sum, min=1.0), tok_sum


def mtp_loss(params, cfg, hidden: torch.Tensor, tokens: torch.Tensor, labels: torch.Tensor,
             seg, block_apply_fn, head_w: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction at depth 1: h_t joined with the
    embedding of token t+1, padded one position back to S, projected by
    ``mtp/proj``, run through the unstacked ``mtp/block`` at positions
    0..S-1 without a cache and normed by ``mtp/ln``; its first S-1 rows
    predict ``labels[:, 1:]`` (the token two ahead). Returns the mean extra
    nll (the caller weights it)."""
    from .layers import embed_lookup, linear, norm

    p = params["mtp"]
    s = tokens.shape[1]
    nxt = embed_lookup(params["embed"], tokens[:, 1:])  # (B, S-1, d)
    h_in = torch.cat([hidden[:, :-1], nxt.to(hidden.dtype)], dim=-1)
    h_in = torch.nn.functional.pad(h_in, (0, 0, 0, 1))
    h_in = linear(p["proj"], h_in)
    h_out, _ = block_apply_fn(p["block"], h_in, cfg, seg,
                              torch.arange(s, device=hidden.device))
    h_out = norm(p["ln"], h_out, cfg.norm_kind, cfg.norm_eps)
    loss, _ = chunked_xent(h_out[:, :s - 1], head_w, labels[:, 1:], chunk=chunk)
    return loss
