"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE (3-component), dynamic-resolution vision frontend
STUB (input_specs supplies patch embeddings + 3D position ids).
[arXiv:2409.12191; hf]

Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
