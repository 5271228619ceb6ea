"""zamba2-1.2b [hybrid]: 38 mamba2 blocks d_model=2048 + shared attention
block (32H) every 6 layers, d_ff=8192, vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]

Hybrid/SSM -> long_500k RUNS (O(1) mamba state; attention KV only at the
shared blocks).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(version=2, state_dim=64, conv_dim=4, expand=2,
                  head_dim=64, chunk=128),
    hybrid_attn_every=6,
    tie_embeddings=True,
)
