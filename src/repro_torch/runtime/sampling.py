"""Token selection (port of ``repro.runtime.sampling``, greedy row only).

``SamplingParams`` keeps the reference's fields and bounds checks so that
requests read the same; ``temperature > 0`` raises ``NotImplementedError``:
sampled streams equal to the reference's need JAX's threefry ported
(ROADMAP queue 1, item 9)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "greedy_tokens"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 = greedy argmax
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def validate(self, rid: Optional[int] = None) -> "SamplingParams":
        """Bounds check as in the reference, then refuse what this slice
        cannot serve yet."""
        tag = f"request {rid}: " if rid is not None else ""
        if not self.temperature >= 0:  # NaN fails this comparison too
            raise ValueError(f"{tag}temperature={self.temperature} must be >= 0 (0 = greedy argmax)")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"{tag}top_p={self.top_p} must be in (0, 1]")
        if not self.top_k >= 0:
            raise ValueError(f"{tag}top_k={self.top_k} must be >= 0")
        if not self.greedy:
            raise NotImplementedError(
                f"{tag}temperature > 0: sampled decoding is not ported yet "
                "(ROADMAP queue 1, item 9)")
        return self


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) argmax ids (the first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)
