"""Model API (port of ``repro.models.api``): build, init, and the paged
serving step for the dense decoder family."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.kv_cache import PagedState

from . import transformer as _tf
from .params import init_tree

__all__ = ["build_def", "init_params", "decode_step"]


def build_def(cfg):
    return _tf.build_lm(cfg)


def init_params(cfg, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(seed)`` on ``device`` (the
    card unless ``device='cpu'``)."""
    return init_tree(build_def(cfg), seed, resolve_device(device))


@torch.no_grad()
def decode_step(params, cfg, tokens: torch.Tensor, caches, state: PagedState,
                a_fmt: Optional[str] = None) -> torch.Tensor:
    """One serving step over the paged pool (written in place): tokens
    (B, S) at per-row positions ``state.lengths``. A state with
    ``chunk_len`` is a bucketed prefill chunk, so the logits row is its last
    *true* token (``chunk_len - 1``); otherwise the last row. Returns
    (B, V) f32 logits."""
    hidden = _tf.lm_forward(params, cfg, tokens, caches, state, a_fmt=a_fmt)
    if state.chunk_len is not None:
        h_last = hidden[:, int(state.chunk_len[0]) - 1]
    else:
        h_last = hidden[:, -1]
    return _tf.lm_logits(params, cfg, h_last)
