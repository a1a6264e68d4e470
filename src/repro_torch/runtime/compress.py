"""Gradient compression (port of ``repro.runtime.compress``): each leaf
quantized per tensor to E4M3 under an M1 (power-of-two) scale and back,
the paper's FP machinery reused beyond the paper. The pair (compress,
decompress) plugs into ``launch.steps.make_train_step(grad_compress=...)``;
with a data-parallel reduction between the two (the multi-device port),
the scale factors out of the sum as an exponent shift."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.formats import FORMATS, quantize_to_grid
from repro_torch.core.scales import constrain_scales_m1
from repro_torch.models.params import tree_map, tree_zip

__all__ = ["make_fp8_compressor", "compress_tree", "decompress_tree"]


def _compress_leaf(g: torch.Tensor, fmt):
    g32 = g.float()
    absmax = torch.amax(g32.abs())
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=g.device)
    scale = constrain_scales_m1(torch.maximum(absmax * c(1.0 / fmt.max_value), c(1e-30))[None])[0]
    q = quantize_to_grid(g32 / scale, fmt)
    return q.to(torch.bfloat16), scale


def compress_tree(grads, fmt_name: str = "fp8_e4m3"):
    """Each leaf -> (values on the grid in bf16, its f32 M1 scale)."""
    fmt = FORMATS[fmt_name]
    return tree_map(lambda g: _compress_leaf(g, fmt), grads)


def decompress_tree(cgrads, like):
    """(q, scale) leaves back to values in ``like``'s dtypes."""
    return tree_zip(lambda g, qs: (qs[0].float() * qs[1]).to(g.dtype), like, cgrads)


def make_fp8_compressor(fmt_name: str = "fp8_e4m3") -> Tuple:
    """(compress, decompress) for make_train_step(grad_compress=...)."""

    def compress(grads):
        return compress_tree(grads, fmt_name), grads

    def decompress(arg):
        cgrads, like = arg
        return decompress_tree(cgrads, like)

    return compress, decompress
