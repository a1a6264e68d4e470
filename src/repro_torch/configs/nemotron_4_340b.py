"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — squared-ReLU, LayerNorm. [arXiv:2402.16819; unverified]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    attn_kind="gqa",
    norm_kind="layernorm",
    act_kind="relu2",
    mlp_gated=False,
    rope_theta=10000.0,
    source="[arXiv:2402.16819; unverified]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_ff=384,
    vocab_size=256, attn_chunk=32,
)
