"""Quickstart on the PyTorch port: the paper's pipeline end-to-end on a
pocket-size model (the twin of ``examples/quickstart.py``).

    python examples/torch_quickstart.py                 # on the card
    python examples/torch_quickstart.py --device cpu

1. train a tiny OPT-style LM on the synthetic corpus,
2. PTQ it with the paper's headline scheme
   (W4 FP4-E2M1 / A8 FP8-E4M3, GPTQ group-256, LoRC rank 8, M2 scales),
3. compare perplexity FP16 vs W4A8,
4. pack to the deployment form and decode a few tokens with the serving
   engine (on the card, every packed matmul runs the fused W4A8 kernel).

``QUICKSTART_STEPS`` sets the training steps (200), as for the reference.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_common import BENCH_CFG, calib_batches, data_cfg, eval_ppl

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.ptq import gptq_quantize_lm, pack_params
from repro_torch.device import resolve_device
from repro_torch.optimizer import AdamWConfig
from repro_torch.runtime.serve import CachePolicy, Request, Server, ServerConfig
from repro_torch.runtime.train import TrainLoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card when not given (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. train ==")
    steps = int(os.environ.get("QUICKSTART_STEPS", "200"))
    oc = AdamWConfig(lr=3e-3, warmup=20, total_steps=steps)
    state, hist = train_loop(
        BENCH_CFG, data_cfg(), oc, TrainLoopConfig(steps=steps, log_every=50), device=dev,
        on_metrics=lambda m: print(f"  step {m['step']:4d} nll {m['nll']:.3f}"),
    )
    params = state.params

    print("== 2. PTQ (GPTQ + LoRC + M2 scales, W4A8 FP-FP) ==")
    policy = QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq",
                         scale_mode="m2", lorc_rank=8)
    qparams = gptq_quantize_lm(params, BENCH_CFG, calib_batches(4), policy)

    print("== 3. perplexity ==")
    ppl_fp16 = eval_ppl(params)
    ppl_w4a8 = eval_ppl(qparams, a_fmt="fp8_e4m3")
    print(f"  W16A16: {ppl_fp16:.3f}   W4A8(FP-FP+LoRC+M2): {ppl_w4a8:.3f} "
          f"(+{(ppl_w4a8 / ppl_fp16 - 1) * 100:.1f}%)")

    print("== 4. pack + serve ==")
    packed = pack_params(params, BENCH_CFG, policy, device=dev)
    server = Server(packed, BENCH_CFG,
                    ServerConfig(slots=2, max_seq=64, cache=CachePolicy(active_fmt="fp8_e4m3")),
                    device=dev)
    server.submit(Request(rid=0, prompt=[5, 17, 99, 3], max_new=8))
    server.submit(Request(rid=1, prompt=[1, 2, 3], max_new=8))
    reqs = [server.queue[0], server.queue[1]]
    for _ in range(20):
        if not server.step():
            break
    for r in reqs:
        print(f"  request {r.rid}: prompt {r.prompt} -> generated {r.out}")
    print("done.")
    return reqs


if __name__ == "__main__":
    main()
