"""Model API (port of ``repro.models.api``): build, init, the serving step
over the paged pool or over contiguous caches (``init_cache``,
``prefill``, and ``decode_step`` at a scalar index), the enc-dec
admission step, the forward to final hidden states (calibration and
perplexity) and the loss it feeds. The Zamba2 hybrid dispatches to
``models.hybrid``, the enc-dec family to ``models.encdec``, every other
decoder (xLSTM included) to ``models.transformer``."""
from __future__ import annotations

import operator
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.kv_cache import PagedState

from . import encdec as _encdec
from . import hybrid as _hybrid
from . import transformer as _tf
from .losses import chunked_xent, mtp_loss
from .params import init_tree

__all__ = ["build_def", "init_params", "loss_fn", "prefill", "decode_step", "encode_cross_pages",
           "forward_hidden", "init_cache"]


def _is_encdec(cfg) -> bool:
    return cfg.encoder_layers > 0


def _is_hybrid(cfg) -> bool:
    return cfg.ssm is not None and cfg.ssm.kind == "mamba2" and cfg.family == "hybrid"


def build_def(cfg):
    if _is_encdec(cfg):
        return _encdec.build_encdec(cfg)
    if _is_hybrid(cfg):
        return _hybrid.build_hybrid(cfg)
    return _tf.build_lm(cfg)


def encode_cross_pages(params, cfg, frames, cross_pool, cross_table, a_fmt=None):
    """Enc-dec admission step: run the encoder once and write every decoder
    layer's cross K/V into the request's write-once cross pages, in place
    (``models.encdec``)."""
    return _encdec.encode_cross_pages(params, cfg, frames, cross_pool, cross_table,
                                      a_fmt=a_fmt)


def init_params(cfg, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(seed)`` on ``device`` (the
    card unless ``device='cpu'``)."""
    return init_tree(build_def(cfg), seed, resolve_device(device))


def init_cache(cfg, batch: int, max_seq: int, device=None):
    """Zeroed contiguous caches for ``batch`` rows of up to ``max_seq``
    positions on ``device`` (the card unless ``device='cpu'``): a list of
    per-segment caches for a decoder LM (``transformer.init_lm_cache``),
    one tree for the enc-dec decoder and for the hybrid. Every layer's
    leaves have storage of their own."""
    dev = resolve_device(device)
    if _is_encdec(cfg):
        return _encdec.init_encdec_cache(cfg, batch, max_seq, device=dev)
    if _is_hybrid(cfg):
        return _hybrid.init_hybrid_cache(cfg, batch, max_seq, device=dev)
    return _tf.init_lm_cache(cfg, batch, max_seq, device=dev)


@torch.no_grad()
def prefill(params, cfg, batch: dict, max_seq: int, a_fmt: Optional[str] = None):
    """Run the prompt ``batch["tokens"]`` (B, S) (behind ``patches`` or
    ``frames_prefix``; an enc-dec model encodes ``batch["frames"]``) into
    fresh contiguous caches of ``max_seq`` positions on the params' device.
    Returns (the last position's f32 logits (B, V), caches)."""
    dev = params["embed"].device
    caches = init_cache(cfg, batch["tokens"].shape[0], max_seq, device=dev)
    hidden, caches, _ = forward_hidden(params, cfg, batch, a_fmt=a_fmt, caches=caches,
                                       cache_index=0)
    return _tf.lm_logits(params, cfg, hidden[:, -1]), caches


@torch.no_grad()
def decode_step(params, cfg, tokens: torch.Tensor, caches, state,
                a_fmt: Optional[str] = None, cross=None) -> torch.Tensor:
    """One serving step over contiguous caches or the paged pool, each
    written in place. An integer ``state`` is the contiguous caches' one
    synchronized index (``init_cache`` / ``prefill``'s): tokens (B, S) at
    positions index + j, logits of the last position; a step that would
    write past ``max_seq`` (or read past the learned positions) raises
    ``ValueError`` (ROADMAP queue 3, F10), as does a step of more than one
    token at an index past 0 on a family that attends (F11). Over the paged pool: tokens
    (B, S) at per-row positions ``state.lengths``. A state with
    ``chunk_len`` is a bucketed prefill chunk, so the logits row is its last
    *true* token (``chunk_len - 1``); otherwise the last row. Returns
    (B, V) f32 logits. A mixed step (``state.prefill`` set, tokens the
    fused (1, slots + S) row) returns (slots + 1, V): one row per slot,
    then the chunk's last true token. An enc-dec decoder also reads its
    cross pages: ``cross`` is the cross pool, ``state.cross_table`` /
    ``enc_lengths`` index it. A recurrent family reads and writes each
    row's state slab (``state.slabs``): ``caches`` holds its slab pools
    (the hybrid's {"mamba", "shared_kv"}; xLSTM's {"mlstm", "slstm"} a
    segment)."""
    if not isinstance(state, PagedState):
        hidden, _, _ = forward_hidden(params, cfg, {"tokens": tokens}, a_fmt=a_fmt,
                                      caches=caches, cache_index=operator.index(state))
        return _tf.lm_logits(params, cfg, hidden[:, -1])
    if _is_encdec(cfg):
        hidden = _encdec.encdec_forward(params, cfg, tokens, caches=caches, state=state,
                                        a_fmt=a_fmt, cross=cross)
    elif _is_hybrid(cfg):
        hidden = _hybrid.hybrid_forward(params, cfg, tokens, caches, state, a_fmt=a_fmt)
    else:
        hidden, _ = _tf.lm_forward(params, cfg, tokens, caches, state, a_fmt=a_fmt)
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


def forward_hidden(params, cfg, batch: dict, a_fmt: Optional[str] = None, remat: bool = False,
                   caches=None, cache_index: Optional[int] = None):
    """The whole forward to final hidden states: ``batch["tokens"]``
    (B, S) at positions 0..S-1 (from ``cache_index`` with ``caches``, the
    contiguous caches it writes in place), moved to the params' device, behind
    ``batch["patches"]`` (B, P, 1024) or ``batch["frames_prefix"]`` (B, P,
    d) when given; an enc-dec model encodes ``batch["frames"]`` first when
    the batch has them (a contiguous step without them reads the cross K/V
    its caches hold).
    Returns ``(hidden (B, S, d), caches, aux)`` as the reference does:
    ``aux`` the MoE balance loss summed over the layers, an f32 0-d tensor (0
    without an MoE layer). MLA runs its materialized form, MoE the grouped
    capacity dispatch; the recurrent families run from their pristine state
    (the chunked forms over the sequence), or from the caches' states.
    Autograd records the pass when
    a leaf requires a gradient (a caller who wants values only runs it
    under ``torch.no_grad()``); ``remat`` recomputes each block in the
    backward pass, as the reference's ``jax.checkpoint`` does."""
    dev = params["embed"].device
    tokens = batch["tokens"].to(dev)
    index = None if caches is None else operator.index(cache_index or 0)
    aux = 0.0
    if _is_encdec(cfg):
        enc = (_encdec.encode(params, cfg, batch["frames"], a_fmt=a_fmt, remat=remat)
               if "frames" in batch else None)
        hidden = _encdec.encdec_forward(params, cfg, tokens, enc, caches, index, a_fmt=a_fmt,
                                        remat=remat)
    elif _is_hybrid(cfg):
        hidden = _hybrid.hybrid_forward(params, cfg, tokens, caches, index, a_fmt=a_fmt,
                                        remat=remat)
    else:
        prefix = batch.get("patches")
        if prefix is None:
            prefix = batch.get("frames_prefix")
        hidden, aux = _tf.lm_forward(params, cfg, tokens, caches, index, a_fmt=a_fmt,
                                     embeds_prefix=prefix, remat=remat)
    if not torch.is_tensor(aux):  # no MoE layer: a zero made on the device, not copied there
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    return hidden, caches, aux.to(torch.float32)


def loss_fn(params, cfg, batch: dict, a_fmt: Optional[str] = None, remat: bool = True,
            aux_weight: float = 0.01, mtp_weight: float = 0.0):
    """The training loss (+ metrics), as the reference computes it: the
    chunked cross entropy of ``forward_hidden`` against ``batch["labels"]``
    (under ``batch["mask"]`` when given; a vision or audio prefix carries no
    loss and is trimmed), plus ``aux_weight`` times the MoE balance loss
    and, for a config with ``mtp_depth`` and ``mtp_weight`` set,
    ``mtp_weight`` times ``losses.mtp_loss``. Returns ``(total, {"nll",
    "aux", "tokens"[, "mtp"]})``. ``total.backward()`` gives every leaf
    that requires a gradient its gradient (``launch.steps.make_train_step``);
    ``remat`` recomputes each block in the backward pass. Under
    ``torch.no_grad()`` it is the loss's value alone."""
    hidden, _, aux = forward_hidden(params, cfg, batch, a_fmt=a_fmt, remat=remat)
    labels = batch["labels"].to(hidden.device)
    if hidden.shape[1] != labels.shape[1]:  # vision/audio prefix tokens carry no loss
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    mask = batch.get("mask")
    head_w = _head_w(params, cfg)
    loss, n_tok = chunked_xent(hidden, head_w, labels,
                               mask=None if mask is None else mask.to(hidden.device))
    total = loss + aux_weight * aux
    metrics = {"nll": loss, "aux": aux, "tokens": n_tok}
    if mtp_weight and cfg.mtp_depth and "mtp" in params:
        ml = mtp_loss(params, cfg, hidden, batch["tokens"].to(hidden.device), labels,
                      _tf.segments_for(cfg)[-1], _tf.block_apply, head_w)
        total = total + mtp_weight * ml
        metrics["mtp"] = ml
    return total, metrics
