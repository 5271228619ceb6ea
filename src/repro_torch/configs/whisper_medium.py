"""whisper-medium [audio]: enc-dec, 24L each side, d_model=1024 16H
d_ff=4096 vocab=51865, conv frontend STUB (input_specs supplies precomputed
frame embeddings). [arXiv:2212.04356; unverified]

Backbone only. LayerNorm + GELU (non-gated) MLPs.
Decoder decodes with self+cross KV; full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    encoder_decoder=True,
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm_style="layernorm",
    act="gelu",
    glu=False,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
