"""LoRC — low-rank compensation of the quantization error (port of
``repro.core.lorc``): E = W - W_q ~= (U_r sqrt(s_r)) (sqrt(s_r) V_r^T) = A B,
applied at inference as the side path y = W_q x + A (B x). The SVD's signs
are implementation-defined, so A and B may differ from the reference's in
sign; the correction A·B is what the tests compare."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .quantize import fake_quantize_weight

__all__ = ["LorcFactors", "lorc_compensate"]


class LorcFactors(NamedTuple):
    a: torch.Tensor  # (out, r)
    b: torch.Tensor  # (r, in)


def lorc_compensate(w: torch.Tensor, w_q: torch.Tensor, rank: int,
                    quantize_factors: Optional[str] = None,
                    factor_group: int = 0) -> LorcFactors:
    """Rank-``rank`` SVD compensation of W - W_q."""
    err = (w - w_q).to(torch.float32)
    u, s, vt = torch.linalg.svd(err, full_matrices=False)
    r = min(rank, s.shape[0])
    sq = torch.sqrt(s[:r])
    a = u[:, :r] * sq[None, :]
    b = sq[:, None] * vt[:r, :]
    if quantize_factors:
        a = fake_quantize_weight(a, quantize_factors, group_size=factor_group or a.shape[1])
        b = fake_quantize_weight(b, quantize_factors, group_size=factor_group or b.shape[1])
    # the SVD's factors come back column-major: the kernels take row-major
    return LorcFactors(a=a.contiguous(), b=b.contiguous())
