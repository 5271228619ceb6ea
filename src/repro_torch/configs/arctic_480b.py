"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]

128 experts shard 8-per-chip over the 16-way model axis (expert
parallelism); Adafactor optimizer. Pure full attention -> long_500k
skipped.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    tie_embeddings=True,
    optimizer="adafactor",
    skip_shapes=("long_500k",),
)
