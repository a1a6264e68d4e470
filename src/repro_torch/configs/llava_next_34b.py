"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling frontend STUB (input_specs feeds patch
embeddings at the vision dim 1024). [hf:llava-hf/llava-v1.6; unverified]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    attn_kind="gqa",
    norm_kind="rmsnorm",
    act_kind="silu",
    mlp_gated=True,
    frontend="vision_patches",
    n_patches=576,         # one 24x24 CLIP tile (anyres stub)
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=256, n_patches=8, attn_chunk=32,
)
