"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + ONE shared attention+MLP block applied
every 6 layers (weight sharing; per-invocation KV caches).
[arXiv:2411.15242; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    attn_kind="gqa",
    ssm=SSMSpec(kind="mamba2", d_state=64, expand=2, head_dim=64, d_conv=4,
                chunk=256, attn_every=6),
    norm_kind="rmsnorm",
    act_kind="gelu",
    mlp_gated=False,
    tie_embeddings=True,
    source="[arXiv:2411.15242; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_chunk=32,
    ssm=SSMSpec(kind="mamba2", d_state=16, expand=2, head_dim=16, d_conv=4,
                chunk=32, attn_every=2),
)
