"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (projections internal to the blocks).
[arXiv:2405.04517; unverified]"""
import dataclasses

from repro_torch.models.config import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attn_kind="none",
    ssm=SSMSpec(kind="xlstm"),
    norm_kind="rmsnorm",
    tie_embeddings=True,
    pos_embedding="none",
    source="[arXiv:2405.04517; unverified]",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, vocab_size=256,
)
