"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA
(multi-head latent attention). [hf:openbmb/MiniCPM3-4B; hf]

MLA latent KV (kv_lora_rank + rope dims per token) is the arch's memory
feature; decode caches store latents only. Pure full attention ->
long_500k skipped (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,  # qk_nope(64) + qk_rope(32)
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
