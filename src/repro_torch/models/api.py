"""Model API (port of ``repro.models.api``): build, init, the paged
serving step, and the cache-free forward to final hidden states (dense
family: calibration and perplexity)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.kv_cache import PagedState

from . import transformer as _tf
from .params import init_tree

__all__ = ["build_def", "init_params", "decode_step", "forward_hidden"]


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
    (B, V) f32 logits. A mixed step (``state.prefill`` set, tokens the
    fused (1, slots + S) row) returns (slots + 1, V): one row per slot,
    then the chunk's last true token."""
    hidden = _tf.lm_forward(params, cfg, tokens, caches, state, a_fmt=a_fmt)
    if state.prefill is not None:
        nd = state.lengths.shape[0]
        h_pre = hidden[0, nd + int(state.prefill.chunk_len[0]) - 1]
        h_last = torch.cat([hidden[0, :nd], h_pre[None]], dim=0)
    elif state.chunk_len is not None:
        h_last = hidden[:, int(state.chunk_len[0]) - 1]
    else:
        h_last = hidden[:, -1]
    return _tf.lm_logits(params, cfg, h_last)


def _head_w(params, cfg) -> torch.Tensor:
    return params["embed"] if (cfg.tie_embeddings or "lm_head" not in params) else params["lm_head"]


@torch.no_grad()
def forward_hidden(params, cfg, batch: dict, a_fmt: Optional[str] = None):
    """The whole forward to final hidden states, no cache: ``batch["tokens"]``
    (B, S) at positions 0..S-1, moved to the params' device. Returns
    ``(hidden (B, S, d), None, aux)`` as the reference does; ``aux`` (the
    MoE balance loss) is 0 for the dense family, the only one ported here
    (MLA and MoE blocks raise, naming ROADMAP queue 1, item 13)."""
    if batch.get("patches") is not None or batch.get("frames_prefix") is not None:
        raise NotImplementedError("vision / audio prefixes are not ported yet "
                                  "(ROADMAP queue 1, item 12)")
    dev = params["embed"].device
    hidden = _tf.lm_forward(params, cfg, batch["tokens"].to(dev), a_fmt=a_fmt)
    return hidden, None, torch.zeros((), dtype=torch.float32, device=dev)
