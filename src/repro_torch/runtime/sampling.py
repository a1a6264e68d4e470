"""Batched token sampling for the paged serving engine (port of
``repro.runtime.sampling``).

Temperature, top-k and top-p are per-row arrays: the engine keeps five
host arrays of one entry a slot (``slot_arrays``, ``fill_slot``,
``clear_slot``) and hands them to ``sample_tokens`` on the device with the
step's logits (``as_tuple``). A greedy row (``temperature == 0``) takes the
argmax; a step whose rows are all greedy never calls ``sample_tokens``.

Reproducibility: the key of a request's draw at emitted-token index ``i``
is ``fold_in(PRNGKey(seed), i)``, split per emitted-token index and not per
engine step, so the draw at index ``i`` is the same solo, batched, or after
a steal and resume. ``runtime.threefry`` repeats JAX's generator bit for
bit, so a stream equals the reference's wherever the logits do.

Masks, as in the reference: top-k keeps every logit ``>=`` the k-th largest
after temperature scaling (ties at the boundary are all kept); top-p keeps
the smallest prefix of the descending-sorted distribution whose exclusive
cumulative probability is still ``< p`` (so the top token always survives
and ``p = 1`` keeps everything). The softmax and its cumulative sum are
taken in f64: XLA's f32 ones (its exp, and its order of summation) cannot
be repeated by torch on either device, and f64 moves a top-p cut only where
the reference's own f32 mass sits within its rounding of ``p``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime import threefry

__all__ = ["SamplingParams", "greedy_tokens", "sampling_mask", "sample_tokens", "slot_arrays",
           "fill_slot", "clear_slot", "as_tuple"]

# the sampled branch divides by the temperature: a non-zero floor for greedy rows
_MIN_TEMP = 1e-6


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling spec. ``temperature == 0`` (the default) is
    greedy argmax; ``top_k == 0`` disables the top-k mask, ``top_p == 1.0``
    the nucleus mask; ``seed`` roots the request's RNG key."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def validate(self, rid: Optional[int] = None) -> "SamplingParams":
        """Bounds check as in the reference: temperature >= 0, 0 < top_p <= 1,
        top_k >= 0."""
        tag = f"request {rid}: " if rid is not None else ""
        if not self.temperature >= 0:  # NaN fails this comparison too
            raise ValueError(
                f"{tag}temperature={self.temperature} must be >= 0 (0 = greedy argmax)")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"{tag}top_p={self.top_p} must be in (0, 1]")
        if not self.top_k >= 0:
            raise ValueError(f"{tag}top_k={self.top_k} must be >= 0")
        return self


# -- host-side slot arrays ---------------------------------------------------------
def slot_arrays(n: int) -> dict:
    """Greedy-default per-slot sampling arrays for an ``n``-row step."""
    return {"temperature": np.zeros(n, np.float32), "top_k": np.zeros(n, np.int32),
            "top_p": np.ones(n, np.float32), "seed": np.zeros(n, np.uint32),
            "count": np.zeros(n, np.int32)}


def fill_slot(arrs: dict, i: int, sp: SamplingParams, emitted: int):
    """Load slot ``i`` with a request's params and its emitted-token count
    (the RNG key index of the token about to be drawn)."""
    arrs["temperature"][i] = sp.temperature
    arrs["top_k"][i] = sp.top_k
    arrs["top_p"][i] = sp.top_p
    arrs["seed"][i] = np.uint32(sp.seed & 0xFFFFFFFF)
    arrs["count"][i] = emitted


def clear_slot(arrs: dict, i: int):
    """Reset slot ``i`` to the greedy defaults (an idle row)."""
    arrs["temperature"][i] = 0.0
    arrs["top_k"][i] = 0
    arrs["top_p"][i] = 1.0
    arrs["seed"][i] = 0
    arrs["count"][i] = 0


def as_tuple(arrs: dict, device) -> tuple:
    """The arrays as ``sample_tokens``' positional tensors on ``device``
    (seeds widened to int64: torch has no general uint32 arithmetic)."""
    return tuple(torch.as_tensor(arrs[k].astype(np.int64) if k == "seed" else arrs[k]).to(device)
                 for k in ("temperature", "top_k", "top_p", "seed", "count"))


# -- sampling on the device -----------------------------------------------------------
def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) argmax ids (the first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)


def sampling_mask(scaled: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row keep mask over temperature-scaled logits. ``scaled``: (B, V)
    f32; ``top_ks``: (B,) ints (0 = off); ``top_ps``: (B,) in (0, 1].
    Both filters reduce to a threshold value from the descending sort,
    then one compare."""
    vocab = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (top_ks.long() - 1).clamp(0, vocab - 1)[:, None])
    keep_k = torch.where((top_ks > 0)[:, None], scaled >= kth, True)
    probs = torch.softmax(srt.double(), dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    n_keep = (exclusive < top_ps.double()[:, None]).sum(-1)  # >= 1 on a finite row
    cut = torch.gather(srt, -1, (n_keep - 1).clamp(min=0)[:, None])
    return keep_k & (scaled >= cut)


def sample_tokens(logits, temps, top_ks, top_ps, seeds, counts) -> torch.Tensor:
    """One token id a row. ``logits``: (B, V) f32; per-row ``temps`` f32 (0 =
    greedy), ``top_ks`` ints, ``top_ps`` f32, ``seeds`` (the request's RNG
    root, mod 2^32) and ``counts`` (its emitted-token index for this draw).
    Greedy rows take the argmax, sampled rows
    ``categorical(fold_in(PRNGKey(seed), count), masked / temperature)``. A
    non-finite row's token is garbage; the engine never appends it."""
    scaled = logits / torch.clamp(temps, min=_MIN_TEMP)[:, None]
    masked = torch.where(sampling_mask(scaled, top_ks, top_ps), scaled, -torch.inf)
    keys = threefry.fold_in(threefry.seed_key(seeds), counts)
    return torch.where(temps > 0, threefry.categorical(keys, masked), greedy_tokens(logits))
