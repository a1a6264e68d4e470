"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v 64).
[hf:openbmb/MiniCPM3-4B; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MLASpec

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    mla=MLASpec(
        q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
        v_head_dim=64,
    ),
    norm_kind="rmsnorm",
    act_kind="silu",
    mlp_gated=True,
    source="[hf:openbmb/MiniCPM3-4B; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_chunk=32,
    mla=MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                v_head_dim=8),
)
