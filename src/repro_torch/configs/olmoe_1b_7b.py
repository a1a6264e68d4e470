"""olmoe-1b-7b [moe]: 16L d_model=2048 16H d_ff(expert)=1024 vocab=50304 —
64 experts top-8, SwiGLU, rmsnorm. [arXiv:2409.02060; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    attn_kind="gqa",
    moe=MoESpec(n_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25),
    norm_kind="rmsnorm",
    act_kind="silu",
    mlp_gated=True,
    source="[arXiv:2409.02060; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab_size=256, attn_chunk=32,
    moe=MoESpec(n_experts=8, top_k=2, d_ff=32, capacity_factor=1.25),
)
