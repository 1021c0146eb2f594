"""gemma3-27b [dense] — 5:1 local:global, 128k; 62 layers (10 periods + 2).

Copy of ``repro/configs/gemma3_27b.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", num_layers=62, d_model=5376,
    num_heads=32, num_kv_heads=16, d_ff=21504, vocab_size=262144,
    head_dim=128, period_pattern=("local",) * 5 + ("attn",),
    window_size=1024, rope_theta=1_000_000.0, act="gelu", tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16, window_size=8)
