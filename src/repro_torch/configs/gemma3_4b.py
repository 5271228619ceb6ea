"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

long_500k RUNS for this arch: 29/34 layers are 1024-token sliding window
(bounded KV), only the 5 global layers carry full-length KV (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    local_global_pattern=5,  # 5 local then 1 global
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    tie_embeddings=True,
)
