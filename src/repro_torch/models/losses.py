"""Loss computation (port of ``repro.models.losses``): sequence-chunked
cross entropy, so the live logits buffer is (B, chunk, vocab) f32 and never
(B, S, vocab). Multi-token prediction's loss comes with training (ROADMAP
queue 1, item 13)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["chunked_xent"]


def chunked_xent(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, chunk: int = 512):
    """hidden (B, S, d); head_w (V, d); labels (B, S) int; mask (B, S)
    float / bool or None. Returns (mean_nll, n_tokens), f32 scalars: the
    summed nll and token count accumulate chunk by chunk, as the
    reference's scan does."""
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
    w = head_w.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tok_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, nc * chunk, chunk):
        logits = torch.matmul(hidden[:, c0:c0 + chunk].float(), w.t())  # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c0:c0 + chunk].long()[..., None])[..., 0]
        m = mask[:, c0:c0 + chunk]
        nll_sum = nll_sum + torch.sum((lse - gold) * m)
        tok_sum = tok_sum + torch.sum(m)
    return nll_sum / torch.clamp(tok_sum, min=1.0), tok_sum
