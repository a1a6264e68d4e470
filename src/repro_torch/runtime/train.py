"""The training loop (port of ``repro.runtime.train``): the step
function, checkpoints with resume, and the straggler record, on one
device (the card unless the caller asks for the CPU)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import api
from repro_torch.models.params import tree_map
from repro_torch.optimizer import AdamWConfig, adamw_init

from .straggler import StragglerPolicy

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    grad_compress: bool = False
    accum_steps: int = 1


def train_loop(cfg, data_cfg: DataConfig, opt_cfg: AdamWConfig, loop: TrainLoopConfig,
               device=None, on_metrics: Optional[Callable] = None,
               state: Optional[TrainState] = None):
    """Returns (final_state, history). The params come from
    ``api.init_params(cfg, loop.seed, device)`` with fresh AdamW state,
    unless ``state`` is given (moved to ``device``); a checkpoint under
    ``loop.ckpt_dir`` takes their place and the loop resumes after its
    step. Every ``log_every`` steps, and at the last, the history gets the
    step's metrics as floats (``nll``, ``aux``, ``tokens``, ``lr``,
    ``grad_norm``, ``loss``[, ``mtp``]) with its ``step`` and its seconds
    ``sec`` (the device synchronized)."""
    dev = resolve_device(device)
    if state is None:
        params = api.init_params(cfg, loop.seed, dev)
        state = TrainState(params=params, opt=adamw_init(params, opt_cfg))
    else:
        state = tree_map(lambda t: t.to(dev), state)

    grad_compress = None
    if loop.grad_compress:
        from .compress import make_fp8_compressor

        grad_compress = make_fp8_compressor()
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=loop.accum_steps,
                              grad_compress=grad_compress)

    mgr = None
    start = 0
    if loop.ckpt_dir:
        mgr = CheckpointManager(loop.ckpt_dir, every=loop.ckpt_every)
        state, start = mgr.resume_or(state)

    data = SyntheticLM(data_cfg)
    policy = StragglerPolicy(n_hosts=data_cfg.n_hosts)
    history = []
    for step in range(start, loop.steps):
        t0 = time.time()
        batch = {k: v.to(dev) for k, v in data.batch(step).items()}
        state, metrics = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        policy.record(data_cfg.host_index, dt)
        if step % loop.log_every == 0 or step == loop.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["sec"] = round(dt, 3)
            history.append(m)
            if on_metrics:
                on_metrics(m)
        if mgr:
            mgr.maybe_save(step + 1, state)
    return state, history
