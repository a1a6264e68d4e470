"""The port's copy of ``benchmarks/common.py``: a small trained LM, its
calibration and held-out data, and perplexity, for the ``torch_*``
examples. It imports nothing of JAX, of the JAX package or of
``benchmarks``.

The trained checkpoint is cached under ``.bench_cache/torch_opt_mini_<steps>``
(the port's ``checkpoint.manager``, the reference's on-disk format), so
repeated runs are fast. ``BENCH_TRAIN_STEPS`` sets the steps, as for the
reference.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.checkpoint.manager import latest_step, restore, save
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.models.losses import chunked_xent
from repro_torch.optimizer import AdamWConfig
from repro_torch.runtime.train import TrainLoopConfig, train_loop

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".bench_cache")

# OPT-mini: the paper family's shape at benchmark scale
BENCH_CFG = ArchConfig(
    name="opt-mini",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=4096,
    attn_kind="gqa",
    norm_kind="layernorm",
    act_kind="relu",
    mlp_gated=False,
    use_bias=True,
    pos_embedding="learned",
    tie_embeddings=True,
    max_position=512,
    attn_chunk=512,
)
SEQ = 128
TRAIN_STEPS = int(os.environ.get("BENCH_TRAIN_STEPS", "600"))


def data_cfg(seed=0):
    return DataConfig(vocab_size=BENCH_CFG.vocab_size, seq_len=SEQ, global_batch=16, seed=seed)


def trained_params(refresh: bool = False, device=None):
    """Train (or load the cached) benchmark model on ``device`` (the card
    unless ``device='cpu'``)."""
    os.makedirs(CACHE, exist_ok=True)
    ckpt_dir = os.path.join(CACHE, f"torch_opt_mini_{TRAIN_STEPS}")
    init = api.init_params(BENCH_CFG, 0, device)
    if not refresh and latest_step(ckpt_dir) is not None:
        return restore(ckpt_dir, init)
    oc = AdamWConfig(lr=6e-3, warmup=50, total_steps=TRAIN_STEPS)
    lc = TrainLoopConfig(steps=TRAIN_STEPS, log_every=50)
    state, hist = train_loop(BENCH_CFG, data_cfg(), oc, lc, device=device)
    save(ckpt_dir, TRAIN_STEPS, state.params)
    print(f"  [trained opt-mini: nll {hist[0]['nll']:.3f} -> {hist[-1]['nll']:.3f}]")
    return state.params


def calib_batches(n=8, seed=99):
    src = SyntheticLM(data_cfg(seed))
    return [{"tokens": src.batch(i)["tokens"]} for i in range(n)]


@torch.no_grad()
def eval_ppl(params, cfg=None, a_fmt=None, n_batches=4, seed=1777) -> float:
    """Perplexity of ``cfg`` (``BENCH_CFG`` when None) on held-out synthetic
    batches; ``a_fmt`` simulates the token-wise activation quantization at
    eval (the paper's A8)."""
    cfg = BENCH_CFG if cfg is None else cfg
    src = SyntheticLM(data_cfg(seed))
    total_nll, total_tok = 0.0, 0.0
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    for i in range(n_batches):
        b = src.batch(i)
        hidden, _, _ = api.forward_hidden(params, cfg, b, a_fmt=a_fmt)
        nll, ntok = chunked_xent(hidden, head, b["labels"].to(hidden.device))
        total_nll += float(nll) * float(ntok)
        total_tok += float(ntok)
    return float(np.exp(total_nll / total_tok))
