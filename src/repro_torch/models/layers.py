"""Shared layers (port of ``repro.models.layers``): norms, activations,
the MLP and the quantizable linear — where the W4A8 serving path plugs in.

Dtype flow follows the reference: the residual stream is bf16, matmuls
take bf16 operands and accumulate in f32 (done here as an f32 product of
bf16-valued tensors, which forms the same products), and each result is
cast back to the activation dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantize import fake_quantize_act

from .params import ParamDef

__all__ = ["PackedLinear", "linear", "quant_act", "norm", "norm_params",
           "activation", "mlp_params", "mlp"]


@dataclasses.dataclass
class PackedLinear:
    """W4A8-deployed linear, fields in the reference's layouts:

    codes:  (out, in/2) uint8 — two FP4 nibbles per byte
    scale:  (out, n_groups) f32 — real (M1/M2-constrained) scales
    s_max / shifts: (out, 1) f32 / (out, n_groups) int8 M2 split, or None
    lorc_a / lorc_b: (out, r) / (r, in) bf16 LoRC factors, or None

    Stacked per-segment weights carry a leading ``(L, ...)`` dim on every
    field; ``layer(i)`` takes one layer's view.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    s_max: Optional[torch.Tensor]
    shifts: Optional[torch.Tensor]
    lorc_a: Optional[torch.Tensor]
    lorc_b: Optional[torch.Tensor]
    w_fmt: str = "fp4_e2m1"
    a_fmt: Optional[str] = "fp8_e4m3"
    group_size: int = 256

    _FIELDS = ("codes", "scale", "s_max", "shifts", "lorc_a", "lorc_b")

    def apply(self, fn) -> "PackedLinear":
        """A copy with ``fn`` applied to every tensor field."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else fn(getattr(self, f))
            for f in self._FIELDS})

    def layer(self, i: int) -> "PackedLinear":
        return self.apply(lambda t: t[i])


def linear(w, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W^T [+ b]; ``w`` is a dense (out, in) tensor or a
    PackedLinear (W4A8: routed by device through ``kernels.ops``)."""
    if isinstance(w, PackedLinear):
        from repro_torch.kernels import ops

        y = ops.w4a8_matmul(x, w)
    else:
        y = torch.matmul(x.float(), w.float().t()).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def quant_act(x: torch.Tensor, a_fmt: Optional[str]) -> torch.Tensor:
    """Token-wise activation fake-quant used on the serving path."""
    return x if a_fmt is None else fake_quantize_act(x, a_fmt)


def norm_params(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm_kind == "rmsnorm":
        return {"scale": ParamDef((d,), ("embed",), cfg.param_dtype, "ones")}
    if cfg.norm_kind == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), cfg.param_dtype, "ones"),
                "bias": ParamDef((d,), ("embed",), cfg.param_dtype, "zeros")}
    if cfg.norm_kind == "nonparam_ln":
        return {}
    raise ValueError(cfg.norm_kind)


def norm(p, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    if kind == "rmsnorm":
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu":
        return torch.relu(x)
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


def mlp_params(cfg, d_ff=None):
    d, dtype = cfg.d_model, cfg.param_dtype
    d_ff = d_ff or cfg.d_ff
    p = {"up": ParamDef((d_ff, d), ("ffn", "embed"), dtype),
         "down": ParamDef((d, d_ff), ("embed", "ffn"), dtype)}
    if cfg.mlp_gated:
        p["gate"] = ParamDef((d_ff, d), ("ffn", "embed"), dtype)
    if cfg.use_bias:
        p["up_b"] = ParamDef((d_ff,), ("ffn",), dtype, "zeros")
        p["down_b"] = ParamDef((d,), ("embed",), dtype, "zeros")
    return p


def mlp(p, x: torch.Tensor, cfg, a_fmt=None) -> torch.Tensor:
    xq = quant_act(x, a_fmt)
    up = linear(p["up"], xq, p.get("up_b"))
    if "gate" in p:
        h = activation(linear(p["gate"], xq), cfg.act_kind) * up
    else:
        h = activation(up, cfg.act_kind)
    return linear(p["down"], quant_act(h, a_fmt), p.get("down_b"))
