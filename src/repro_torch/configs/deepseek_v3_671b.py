"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(moe)=2048
vocab=129280 — MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128),
1 shared + 256 routed experts top-8, 3 leading dense layers (d_ff 18432),
MTP depth 1. [arXiv:2412.19437; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MLASpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-layer FFN width
    vocab_size=129280,
    attn_kind="mla",
    mla=MLASpec(
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoESpec(
        n_experts=256, top_k=8, d_ff=2048, n_shared_experts=1,
        shared_d_ff=2048, capacity_factor=1.25, n_dense_layers=3,
        dense_d_ff=18432,
    ),
    norm_kind="rmsnorm",
    act_kind="silu",
    mlp_gated=True,
    mtp_depth=1,
    source="[arXiv:2412.19437; hf]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_chunk=32,
    mla=MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                v_head_dim=8),
    moe=MoESpec(n_experts=8, top_k=2, d_ff=32, n_shared_experts=1,
                shared_d_ff=32, capacity_factor=1.25, n_dense_layers=1,
                dense_d_ff=128),
)
