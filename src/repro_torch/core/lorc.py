"""LoRC — low-rank compensation of the quantization error (port of
``repro.core.lorc``): E = W - W_q ~= (U_r sqrt(s_r)) (sqrt(s_r) V_r^T) = A B,
applied at inference as the side path y = W_q x + A (B x). The factors'
signs are implementation-defined, so A and B may differ from the
reference's in sign; the correction A·B is what the tests compare.

The reference takes a full SVD. Only the top ``rank`` singular triplets
are needed, so the port takes them from the eigendecomposition of the
smaller Gram matrix (E E^T or E^T E) in f64, whose top eigenvectors give
the truncated SVD to far below f32's resolution. On an NVIDIA H100 80GB
HBM3 at 700 W this is both faster and closer to the exact correction than
``torch.linalg.svd``, whose default CUDA driver (Jacobi, gesvdj) took
57 ms per 1024 x 2048 slice for a rank-8 correction 0.28 % from gesvd's
(154-172 ms a slice); the Gram route took 11.3-11.5 ms, 0.014 % from
gesvd's (``chip_smoke.py`` phase 9 prints the three).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .quantize import fake_quantize_weight

__all__ = ["LorcFactors", "lorc_compensate"]


class LorcFactors(NamedTuple):
    a: torch.Tensor  # (out, r)
    b: torch.Tensor  # (r, in)


# An error matrix above this many elements is taken to f64 a block at a
# time (its Gram matrix summed over the blocks), not whole: nemotron-4-340b's
# 73728 x 18432 MLP weight would need an 11 GB f64 copy
_F64_ELEMENTS = 1 << 28


def _blocks(err: torch.Tensor, axis: int):
    """f64 blocks of ``err`` along ``axis`` (-2 or -1), each of about
    _F64_ELEMENTS / 4 elements; the whole of it, once, when it is small."""
    if err.numel() <= _F64_ELEMENTS:
        return [err.to(torch.float64)]
    step = max(1, (_F64_ELEMENTS // 4) * err.shape[axis] // err.numel())
    return (b.to(torch.float64) for b in err.split(step, dim=axis))


def _truncated_svd_factors(err: torch.Tensor, rank: int):
    """(U_r sqrt(s_r), sqrt(s_r) V_r^T) of ``err`` (..., out, in), from the
    top eigenpairs of its smaller f64 Gram matrix; a component whose
    singular value is 0 gets zero factors. A large ``err`` goes to f64 in
    blocks along the Gram matrix's contracted axis (``_blocks``)."""
    wide = err.shape[-2] <= err.shape[-1]
    axis = -1 if wide else -2  # the axis the Gram matrix sums over
    gram = sum(b @ b.mT if wide else b.mT @ b for b in _blocks(err, axis))
    lam, vec = torch.linalg.eigh(gram)  # ascending
    del gram
    r = min(rank, lam.shape[-1])
    vec = vec[..., -r:].flip(-1)  # the top r, largest first, as the SVD orders them
    s = lam[..., -r:].flip(-1).clamp(min=0).sqrt()
    sq = s.sqrt()
    inv = torch.where(s > 0, 1 / sq, torch.zeros((), dtype=sq.dtype, device=sq.device))
    if wide:  # vec = U_r: B = S^-1/2 U_r^T E = S^1/2 V_r^T
        proj = torch.cat([vec.mT @ b for b in _blocks(err, -1)], dim=-1)
        a, b = vec * sq[..., None, :], inv[..., :, None] * proj
    else:  # vec = V_r: A = E V_r S^-1/2 = U_r S^1/2
        proj = torch.cat([b @ vec for b in _blocks(err, -2)], dim=-2)
        a, b = proj * inv[..., None, :], sq[..., :, None] * vec.mT
    return a.to(torch.float32), b.to(torch.float32)


def lorc_compensate(w: torch.Tensor, w_q: torch.Tensor, rank: int,
                    quantize_factors: Optional[str] = None,
                    factor_group: int = 0) -> LorcFactors:
    """Rank-``rank`` compensation of W - W_q, for one (out, in) weight or a
    stack (..., out, in) of them (one batched eigendecomposition, each
    slice as on its own)."""
    a, b = _truncated_svd_factors((w - w_q).to(torch.float32), rank)
    if quantize_factors:
        a = fake_quantize_weight(a, quantize_factors, group_size=factor_group or a.shape[-1])
        b = fake_quantize_weight(b, quantize_factors, group_size=factor_group or b.shape[-1])
    # the kernels take row-major factors
    return LorcFactors(a=a.contiguous(), b=b.contiguous())
