"""olmo-1b [dense]: 16L d_model=2048 16H d_ff=8192 vocab=50304 —
non-parametric LayerNorm, SwiGLU, rope. [arXiv:2402.00838; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    attn_kind="gqa",
    norm_kind="nonparam_ln",
    act_kind="silu",
    mlp_gated=True,
    tie_embeddings=True,
    source="[arXiv:2402.00838; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=256, attn_chunk=32,
)
