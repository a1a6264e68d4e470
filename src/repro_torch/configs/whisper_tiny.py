"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
Enc-dec; conv frontend STUB (input_specs feeds frame embeddings).
[arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    encoder_layers=4,
    encoder_seq=1500,      # 30 s of audio at 50 Hz post-conv
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    attn_kind="gqa",
    norm_kind="layernorm",
    act_kind="gelu",
    mlp_gated=False,
    use_bias=True,
    pos_embedding="learned",
    tie_embeddings=True,
    max_position=65536,    # decode_32k needs learned positions up to 32k
    frontend="audio_frames",
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2, encoder_layers=2, encoder_seq=32, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=128, vocab_size=256, max_position=128, attn_chunk=32,
)
