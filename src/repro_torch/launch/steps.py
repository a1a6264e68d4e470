"""Step builders (port of ``repro.launch.steps``): the training state and
the training step, and the contiguous-cache serving steps
(``make_prefill_step``, ``make_serve_step``). The reference's
``value_and_grad`` becomes autograd over detached leaves of the same
params tree; its ``lax.scan`` over micro-batches a Python loop. The
sharding specs and the cell lowering (``train_state_shapes``,
``train_state_pspecs``, ``lower_cell``) wait for the multi-device port
(ROADMAP queue 1, item 14)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import api
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten, tree_zip
from repro_torch.optimizer import AdamWConfig, OptState, adamw_update

__all__ = ["TrainState", "make_train_step", "make_prefill_step", "make_serve_step"]


class TrainState(NamedTuple):
    params: object
    opt: OptState


def _value_and_grad(loss_of, params, batch):
    """(loss, metrics, grads) of ``loss_of(params, batch)``: each leaf's
    gradient in its own dtype (zeros where the loss does not read it),
    the loss and metrics detached."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = loss_of(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return (loss.detach(), {k: torch.as_tensor(v).detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg, opt_cfg: AdamWConfig, accum_steps: int = 1,
                    a_fmt: Optional[str] = None, grad_compress=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    (``api.loss_fn`` with ``remat`` on and, for a config with MTP,
    ``mtp_weight`` 0.3), its gradients, then one AdamW update. With
    ``accum_steps`` > 1 the batch splits along its first axis into that
    many micro-batches whose gradients add up in f32 (each divided by
    ``accum_steps``), the loss likewise, and the metrics are the last
    micro-batch's. ``grad_compress``: an optional (compress, decompress)
    pair from ``runtime.compress``, applied to the gradients before the
    update."""

    def loss_of(params, batch):
        return api.loss_fn(params, cfg, batch, a_fmt=a_fmt, remat=True,
                           mtp_weight=0.3 if cfg.mtp_depth else 0.0)

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            loss, metrics, grads = _value_and_grad(loss_of, state.params, batch)
        else:
            dev = tree_leaves(state.params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
                             state.params)
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in micro.items()}
                mloss, metrics, mgrads = _value_and_grad(loss_of, state.params, mb)
                loss = loss + mloss / accum_steps
                grads = tree_zip(lambda a, g: a + g.float() / accum_steps, grads, mgrads)
        if grad_compress is not None:
            compress, decompress = grad_compress
            grads = decompress(compress(grads))
        new_params, new_opt, om = adamw_update(state.params, grads, state.opt, opt_cfg)
        return TrainState(new_params, new_opt), dict(metrics, **om, loss=loss)

    return train_step


def make_prefill_step(cfg, max_seq: int, a_fmt: Optional[str] = None):
    """Returns ``prefill_step(params, batch) -> (last logits, caches)``:
    ``api.prefill`` into fresh contiguous caches of ``max_seq`` positions."""

    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch, max_seq, a_fmt=a_fmt)

    return prefill_step


def make_serve_step(cfg, a_fmt: Optional[str] = "fp8_e4m3"):
    """Returns ``serve_step(params, caches, tokens, cache_index) -> (logits,
    caches)``: one ``api.decode_step``; ``caches`` are the same objects,
    written in place. ``params`` is the packed serving checkpoint."""

    def serve_step(params, caches, tokens, cache_index):
        return api.decode_step(params, cfg, tokens, caches, cache_index, a_fmt=a_fmt), caches

    return serve_step
