"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron (squared-ReLU, LayerNorm).
[arXiv:2407.14679; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    attn_kind="gqa",
    norm_kind="layernorm",
    act_kind="relu2",
    mlp_gated=False,
    rope_theta=10000.0,
    source="[arXiv:2407.14679; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=256, attn_chunk=32,
)
