"""falcon-mamba-7b [ssm]: 64L mamba1 blocks (attn-free) d_model=4096,
ssm_state=16, vocab=65024. [arXiv:2410.05355; unverified]

Attention-free -> long_500k RUNS with O(1) recurrent state.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(version=1, state_dim=16, conv_dim=4, expand=2),
    tie_embeddings=True,
)
