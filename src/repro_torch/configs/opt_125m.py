"""opt-125m — the paper's own experimental family (OPT), small config used
by the end-to-end train->PTQ example and the paper-table benchmarks.
12L d_model=768 12H d_ff=3072 vocab=50272, ReLU MLP, LayerNorm, learned pos.
[arXiv:2205.01068; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="opt-125m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50272,
    attn_kind="gqa",
    norm_kind="layernorm",
    act_kind="relu",       # OPT uses plain ReLU (drives the paper's fc2 skew)
    mlp_gated=False,
    use_bias=True,
    pos_embedding="learned",
    tie_embeddings=True,
    max_position=4096,
    source="[arXiv:2205.01068; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, attn_chunk=32,
)
