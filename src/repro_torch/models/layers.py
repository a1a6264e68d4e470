"""Shared layers (port of ``repro.models.layers``): norms, activations,
the MLP and the quantizable linear — where the W4A8 serving path plugs in.

Dtype flow follows the reference: the residual stream is bf16, matmuls
take bf16 operands and accumulate in f32 (done here as an f32 product of
bf16-valued tensors, which forms the same products), and each result is
cast back to the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.quantize import fake_quantize_act

from .params import ParamDef

__all__ = ["PackedLinear", "linear", "embed_lookup", "as_dense", "batched_linear", "packed_head_view",
           "quant_act", "norm", "norm_params", "activation", "xla_tanh", "softplus", "log_sigmoid",
           "mlp_params", "mlp", "rope_freqs", "apply_rope"]


@dataclasses.dataclass
class PackedLinear:
    """W4A8-deployed linear, fields in the reference's layouts:

    codes:  (out, in/2) uint8 — two FP4 nibbles per byte
    scale:  (out, n_groups) f32 — real (M1/M2-constrained) scales
    s_max / shifts: (out, 1) f32 / (out, n_groups) int8 M2 split, or None
    lorc_a / lorc_b: (out, r) / (r, in) bf16 LoRC factors, or None

    Stacked per-segment weights carry a leading ``(L, ...)`` dim on every
    field; ``layer(i)`` takes one layer's view. A batched view (per-head
    ``(H, out, in)``, see ``packed_head_view``) has the same fields with a
    leading head dim, ``lorc_b`` as a stride-0 broadcast over the heads.
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


class _EmbedLookup(torch.autograd.Function):
    """Rows of ``w`` at ``idx``; the backward pass sums each row's
    cotangents in f32 and rounds once to ``w``'s dtype, so a token seen
    many times gets the same gradient on the card (f32 atomics) as on the
    CPU (autograd's own bf16 index backward adds the repeats one bf16
    rounding at a time on the CPU)."""

    @staticmethod
    def forward(ctx, w, idx):
        ctx.save_for_backward(idx)
        ctx.shape = w.shape
        return w[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_add_(0, idx.reshape(-1), g.reshape(-1, ctx.shape[-1]).float())
        return acc.to(g.dtype), None


def embed_lookup(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]`` for integer token ids (``_EmbedLookup``'s gradient)."""
    return _EmbedLookup.apply(w, idx.long())


def as_dense(w, dtype=torch.bfloat16) -> torch.Tensor:
    """A weight as a dense tensor: a PackedLinear (2-D or batched) is
    dequantized with its LoRC term (``ops.dequant_packed``), as the
    reference densifies the few weights its recurrent cells read whole
    (sLSTM's ``r_gates``); a dense one is returned as it is."""
    if isinstance(w, PackedLinear):
        from repro_torch.kernels import ops

        return ops.dequant_packed(w).to(dtype)
    return w


def batched_linear(w, x: torch.Tensor, transpose_w: bool = False,
                   quantize_acts: bool = True) -> torch.Tensor:
    """Per-head (or per-expert) linear over a leading batch axis. x:
    (E, M, D); ``w`` a stacked dense (E, N, K) tensor or a batched
    PackedLinear (codes (E, N, K/2)).
      normal:     y[e] = x[e] @ w[e]^T  (D == K)  -> (E, M, N)
      transposed: y[e] = x[e] @ w[e]    (D == N)  -> (E, M, K)
    A packed weight runs the batched W4A8 kernel (routed by device through
    ``kernels.ops``); ``quantize_acts=False`` skips the activation
    quantization (the MLA absorbed latent paths). Returns x.dtype."""
    if isinstance(w, PackedLinear):
        from repro_torch.kernels import ops

        return ops.w4a8_matmul_batched(x, w, transpose_w=transpose_w,
                                       quantize_acts=quantize_acts).to(x.dtype)
    eq = "emn,enk->emk" if transpose_w else "emk,enk->emn"
    return torch.einsum(eq, x.float(), w.float()).to(x.dtype)


def packed_head_view(w: PackedLinear, heads: int) -> PackedLinear:
    """(H*out, in) PackedLinear -> (H, out, in) batched view for per-head
    absorbed matmuls (MLA): reshapes of the packed fields, no copy;
    ``lorc_b`` (r, in) has no head dim and is broadcast over the heads as
    a stride-0 ``expand`` view."""
    assert w.codes.dim() == 2 and w.codes.shape[0] % heads == 0, tuple(w.codes.shape)
    resh = lambda a: None if a is None else a.reshape(heads, a.shape[0] // heads,
                                                       *a.shape[1:])
    lorc_b = None if w.lorc_b is None else w.lorc_b[None].expand(heads, *w.lorc_b.shape)
    return dataclasses.replace(w, codes=resh(w.codes), scale=resh(w.scale),
                               s_max=resh(w.s_max), shifts=resh(w.shifts),
                               lorc_a=resh(w.lorc_a), lorc_b=lorc_b)


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


# XLA's f32 tanh on the CPU: x * P(x^2) / Q(x^2), each Horner step one fused
# multiply-add, x itself below 0.0004 and +-1 above 7.99881172180175781.
# Held bit for bit against jax.numpy.tanh (tests/test_torch_gelu.py).
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)
_TANH_SMALL, _TANH_ONE = 0.0004, 7.99881172180175781


def _horner_fma(x2: torch.Tensor, coeffs) -> torch.Tensor:
    """f32 Horner steps p * x2 + c, each rounded once to f32 as an FMA
    rounds it (the f64 product of two f32 values is exact)."""
    x2d = x2.double()
    p = torch.full_like(x2d, float(torch.tensor(coeffs[0], dtype=torch.float32)))
    for c in coeffs[1:]:
        p = (p * x2d + float(torch.tensor(c, dtype=torch.float32))).float().double()
    return p.float()


def _xla_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    ax = x.abs()
    x2 = x * x
    r = x * _horner_fma(x2, _TANH_P) / _horner_fma(x2, _TANH_Q)
    r = torch.where(ax > _TANH_ONE, torch.sign(x), r)
    return torch.where(ax < _TANH_SMALL, x, r)


class _XlaTanh(torch.autograd.Function):
    """XLA's tanh rounded to ``x``'s dtype; its gradient is JAX's rule for
    tanh, (g + g*y) * (1 - y), each op in that dtype, not the derivative of
    the rational approximation and its clamps."""

    @staticmethod
    def forward(ctx, x):
        y = _xla_tanh_f32(x).to(x.dtype)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (g + g * y) * (1 - y)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh as XLA computes it on the CPU (the reference's backend): its
    f32 rational approximation, not torch's tanh, returned in f32."""
    return _XlaTanh.apply(x.float())


class _Cube(torch.autograd.Function):
    """``x ** 3`` as XLA expands it, x * (x * x), each product rounded to
    x.dtype; the gradient is JAX's ``integer_pow`` rule, g * (3 * (x * x))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (x * x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (3 * (x * x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True)'s op chain, each op rounded to
    x.dtype as the reference rounds it: its constants sqrt(2/pi) and 0.044715
    in x.dtype, x**3 as x * (x * x), tanh in f32 (XLA's) rounded once."""
    dt = x.dtype
    const = lambda v: torch.tensor(v, dtype=torch.float64).to(dt)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * _Cube.apply(x))
    return x * (0.5 * (1.0 + _XlaTanh.apply(inner)))


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus's forward, ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), NaN passed through; its gradient is logaddexp's
    custom JVP, g * exp(x - out) (an infinite x or out read as 0 there)."""

    @staticmethod
    def forward(ctx, x):
        zero = torch.zeros_like(x)
        out = torch.maximum(x, zero) + torch.log1p(torch.exp(-x.abs()))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        finite = lambda a: torch.where(torch.isinf(a), torch.zeros_like(a), a)
        return g * torch.exp(finite(x) - finite(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus (``_Softplus``)."""
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_sigmoid: -softplus(-x)."""
    return -softplus(-x)


class _Logistic(torch.autograd.Function):
    """``lax.logistic`` as XLA expands it, 1 / (1 + exp(-x)), each op
    rounded to x.dtype; the gradient is JAX's rule, g * (y * (1 - y))."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        # jax.nn.silu's op chain, x * logistic(x), each op rounded to
        # x.dtype as the reference rounds it (torch's fused silu rounds once)
        return x * _Logistic.apply(x)
    if kind == "gelu":
        return _gelu_tanh(x)
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


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (...,) int -> (..., dim/2) f32 angles."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over split halves (not interleaved pairs), as the
    reference: x (..., seq, heads, head_dim); positions (..., seq)."""
    ang = rope_freqs(positions, x.shape[-1], theta)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
