"""End-to-end driver on the PyTorch port (the twin of
``examples/train_and_quantize.py``): train an LM for a few hundred steps,
then the paper's PTQ matrix on it (Table 2 + Table 3 shape).

    python examples/torch_train_and_quantize.py --preset small        # on the card
    python examples/torch_train_and_quantize.py --preset paper
    python examples/torch_train_and_quantize.py --device cpu --steps 20

``paper`` trains the ~100M opt-125m config (seq 512, batch 8); ``small``
(default) runs the same pipeline at benchmark scale. Results print as a
Table-2-shaped grid. Checkpoints go to ``.ckpt_<config name>`` in the
working directory, and a run resumes from the newest.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as common
from torch_common import BENCH_CFG, eval_ppl

from repro_torch.configs import get_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.ptq import gptq_quantize_lm
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.optimizer import AdamWConfig
from repro_torch.runtime.train import TrainLoopConfig, train_loop

MATRIX = [
    ("W16A16", None, None),
    ("W8A8  INT-INT", QuantPolicy(w_fmt="int8", a_fmt="int8", method="gptq"), "int8"),
    ("W8A8  FP-FP ", QuantPolicy(w_fmt="fp8_e4m3", a_fmt="fp8_e4m3", method="gptq"), "fp8_e4m3"),
    ("W4A8  INT-INT", QuantPolicy(w_fmt="int4", a_fmt="int8", method="gptq"), "int8"),
    ("W4A8  FP-FP ", QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq"), "fp8_e4m3"),
    ("W4A8L FP-FP ", QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq",
                                 lorc_rank=8), "fp8_e4m3"),
    ("W4A8L FP-FP M2", QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq",
                                   lorc_rank=8, scale_mode="m2"), "fp8_e4m3"),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["small", "paper"], default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card when not given (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.preset == "paper":
        # ~100M params: opt-125m config at seq 512
        cfg = get_config("opt-125m")
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=8)
    else:
        cfg = BENCH_CFG
        dc = common.data_cfg()

    n_params = cfg.param_count()
    print(f"== training {cfg.name} (~{n_params/1e6:.0f}M params) for {args.steps} steps ==")
    oc = AdamWConfig(lr=3e-3 if args.preset == "small" else 6e-4,
                     warmup=20, total_steps=args.steps)
    lc = TrainLoopConfig(steps=args.steps, log_every=25,
                         ckpt_dir=f".ckpt_{cfg.name}", ckpt_every=100)
    state, hist = train_loop(
        cfg, dc, oc, lc, device=dev,
        on_metrics=lambda m: print(f"  step {m['step']:4d} nll {m['nll']:.3f} "
                                   f"({m['sec']:.2f}s/step)"),
    )

    print("\n== PTQ matrix (GPTQ, group 256; LoRC rank 8; M2 pow-2 scales) ==")
    calib_src = SyntheticLM(dataclasses.replace(dc, seed=99))
    calib = [{"tokens": calib_src.batch(i)["tokens"]} for i in range(8)]
    print(f"{'scheme':16s} {'ppl':>9s} {'delta':>8s}")
    base = None
    rows = []
    for label, policy, a_fmt in MATRIX:
        if policy is None:
            p = state.params
        else:
            p = gptq_quantize_lm(state.params, cfg, calib, policy)
        ppl = eval_ppl(p, cfg=cfg, a_fmt=a_fmt)
        base = base or ppl
        rows.append((label, ppl))
        print(f"{label:16s} {ppl:9.3f} {(ppl / base - 1) * 100:+7.2f}%")
    return rows


if __name__ == "__main__":
    main()
