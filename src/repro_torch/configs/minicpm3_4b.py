"""minicpm3-4b [dense, MLA] — hf:openbmb/MiniCPM3-4B.

Copy of ``repro/configs/minicpm3_4b.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.
62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448; Multi-head Latent
Attention (low-rank q/kv compression + decoupled RoPE; MLA dims from the
published checkpoint)."""
from .base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73448,
    head_dim=96,               # qk_nope (64) + qk_rope (32)
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                       d_ff=128, vocab_size=512, head_dim=24,
                       mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16))
