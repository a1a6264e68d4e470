"""QuantPolicy — one object describing a full PTQ configuration (a copy of
``repro.core.policy``, which the port may not import).

This is the user-facing axis of the paper's experiment matrix:
  weight format x activation format x group size x LoRC rank x scale mode
e.g. the paper's headline scheme is
  QuantPolicy(w_fmt='fp4_e2m1', a_fmt='fp8_e4m3', group_size=256,
              lorc_rank=8, scale_mode='m2', method='gptq')
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["QuantPolicy", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    # weight quantization
    w_fmt: Optional[str] = None  # None => keep fp16/bf16 weights
    group_size: int = 256
    method: str = "rtn"  # 'rtn' | 'gptq'
    scale_mode: str = "none"  # 'none' | 'm1' | 'm2'
    # activation quantization (token-wise)
    a_fmt: Optional[str] = None  # None => full precision activations
    # LoRC
    lorc_rank: int = 0
    lorc_fmt: Optional[str] = None  # quantize LoRC factors (e.g. 'int8')
    # GPTQ details
    damp: float = 0.01
    calib_tokens: int = 128 * 2048  # paper: 128 C4 sentences x 2048 tokens

    @property
    def quantizes_weights(self) -> bool:
        return self.w_fmt is not None

    @property
    def quantizes_acts(self) -> bool:
        return self.a_fmt is not None

    def describe(self) -> str:
        w = self.w_fmt or "fp16"
        a = self.a_fmt or "fp16"
        bits = {"fp4_e2m1": "W4", "fp4_e3m0": "W4", "int4": "W4", "int4_asym": "W4",
                "fp8_e4m3": "W8", "fp8_e5m2": "W8", "int8": "W8", "int8_asym": "W8"}
        abits = {"fp8_e4m3": "A8", "fp8_e5m2": "A8", "int8": "A8", "int8_asym": "A8"}
        tag = f"{bits.get(self.w_fmt, 'W16')}{abits.get(self.a_fmt, 'A16')}"
        extra = []
        if self.method == "gptq":
            extra.append("gptq")
        if self.lorc_rank:
            extra.append(f"lorc{self.lorc_rank}")
        if self.scale_mode != "none":
            extra.append(self.scale_mode)
        return f"{tag}[{w}/{a}]" + ("+" + "+".join(extra) if extra else "")


# Named presets mirroring the paper's table rows.
PRESETS = {
    "w16a16": QuantPolicy(),
    # W8A8 rows of Table 2
    "w8a8_int_int": QuantPolicy(w_fmt="int8", a_fmt="int8", method="gptq"),
    "w8a8_int_fp": QuantPolicy(w_fmt="int8", a_fmt="fp8_e4m3", method="gptq"),
    "w8a8_fp_fp": QuantPolicy(w_fmt="fp8_e4m3", a_fmt="fp8_e4m3", method="gptq"),
    # W4A8 rows of Table 2
    "w4a8_int_int": QuantPolicy(w_fmt="int4", a_fmt="int8", method="gptq"),
    "w4a8_int_fp": QuantPolicy(w_fmt="int4", a_fmt="fp8_e4m3", method="gptq"),
    "w4a8_fp_fp": QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq"),
    # + LoRC rows
    "w4a8_int_int_lorc": QuantPolicy(w_fmt="int4", a_fmt="int8", method="gptq", lorc_rank=8),
    "w4a8_int_fp_lorc": QuantPolicy(w_fmt="int4", a_fmt="fp8_e4m3", method="gptq", lorc_rank=8),
    "w4a8_fp_fp_lorc": QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq", lorc_rank=8),
    # Table 3: scale constraints on the FP-FP W4A8 scheme
    "w4a8_fp_fp_m1": QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq", scale_mode="m1"),
    "w4a8_fp_fp_m2": QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq", scale_mode="m2"),
    "w4a8_fp_fp_m1_lorc": QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq", scale_mode="m1", lorc_rank=8),
    "w4a8_fp_fp_m2_lorc": QuantPolicy(w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq", scale_mode="m2", lorc_rank=8),
    # Table A.1: E3M0 weight alternative
    "w4a8_e3m0_fp": QuantPolicy(w_fmt="fp4_e3m0", a_fmt="fp8_e4m3", method="gptq"),
    # deployment default (paper's recommendation)
    "deploy_w4a8": QuantPolicy(
        w_fmt="fp4_e2m1", a_fmt="fp8_e4m3", method="gptq", scale_mode="m2", lorc_rank=8
    ),
}
