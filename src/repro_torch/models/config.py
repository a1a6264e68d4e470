"""ArchConfig — one dataclass describing every supported architecture (a
copy of ``repro.models.config``: importing that module would run
``repro/models/__init__.py``, which imports jax).

Each architecture gets a module in ``configs/`` that instantiates this
dataclass with the exact published numbers plus a reduced smoke variant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "MoESpec", "MLASpec", "SSMSpec"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert intermediate size
    n_shared_experts: int = 0
    shared_d_ff: int = 0  # defaults to d_ff if 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    n_dense_layers: int = 0  # leading dense layers (deepseek-v3: 3)
    dense_d_ff: int = 0  # d_ff of the leading dense layers


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    kind: str  # 'mamba2' | 'xlstm'
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64  # mamba2 head dim
    d_conv: int = 4
    chunk: int = 256
    # zamba2-style hybrid: a single shared attention block applied every
    # `attn_every` ssm layers (0 = no shared attention)
    attn_every: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm' | 'audio'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    attn_kind: str = "gqa"  # 'gqa' | 'mla' | 'none'
    head_dim: int = 0  # 0 => d_model // n_heads
    rope_theta: float = 10000.0
    causal: bool = True
    attn_chunk: int = 1024  # kv-block size for chunked (flash-style) attention
    window: int = 0  # 0 = full attention; >0 = sliding window

    # norm / activation
    norm_kind: str = "rmsnorm"  # 'rmsnorm' | 'layernorm' | 'nonparam_ln'
    act_kind: str = "silu"  # 'silu' | 'gelu' | 'relu2'
    mlp_gated: bool = True
    use_bias: bool = False

    # optional sub-specs
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None

    # xlstm: alternate (mlstm, slstm) pairs when family == 'ssm' & kind xlstm
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder sequence (whisper: 1500 frames)

    # modality frontend stubs: 'none' | 'audio_frames' | 'vision_patches'
    frontend: str = "none"
    n_patches: int = 0  # vision_patches: patches prepended to the sequence

    # MTP (deepseek-v3): extra next^2-token prediction block
    mtp_depth: int = 0

    # embeddings
    tie_embeddings: bool = False
    pos_embedding: str = "rope"  # 'rope' | 'learned' | 'none'
    max_position: int = 524288

    # numeric
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # provenance tag, e.g. '[arXiv:2402.16819; unverified]'
    source: str = ""

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch run the long_500k shape? (SSM / hybrid backbones)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only archs in the assigned pool

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        for layer in range(self.n_layers):
            if self.attn_kind == "gqa":
                attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
            elif self.attn_kind == "mla":
                m = self.mla
                q_in = m.q_lora_rank or d
                attn = (
                    (d * m.q_lora_rank if m.q_lora_rank else 0)
                    + q_in * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            else:
                attn = 0
            if self.moe is not None and layer >= self.moe.n_dense_layers:
                e_ff = self.moe.d_ff
                mult = 3 if self.mlp_gated else 2
                mlp = self.moe.n_experts * mult * d * e_ff + d * self.moe.n_experts
                if self.moe.n_shared_experts:
                    mlp += self.moe.n_shared_experts * mult * d * (self.moe.shared_d_ff or e_ff)
            elif self.moe is not None:
                mlp = (3 if self.mlp_gated else 2) * d * (self.moe.dense_d_ff or self.d_ff)
            elif self.ssm is not None and self.ssm.kind == "mamba2":
                d_in = d * self.ssm.expand
                mlp = d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d
            elif self.ssm is not None and self.ssm.kind == "xlstm":
                mlp = 8 * d * d  # rough: mlstm up/down + gates
            else:
                mlp = (3 if self.mlp_gated else 2) * d * self.d_ff
            total += attn + mlp
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * hd * self.n_heads + 2 * d * self.d_ff)
            total += enc
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        mult = 3 if self.mlp_gated else 2
        n_moe_layers = self.n_layers - self.moe.n_dense_layers
        inactive = (
            n_moe_layers
            * (self.moe.n_experts - self.moe.top_k)
            * mult
            * d
            * self.moe.d_ff
        )
        return self.param_count() - int(inactive)
