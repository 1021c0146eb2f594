"""gemma3-12b [dense] — 5:1 local:global interleave, 128k context.

Copy of ``repro/configs/gemma3_12b.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", num_layers=48, d_model=3840,
    num_heads=16, num_kv_heads=8, d_ff=15360, vocab_size=262144,
    head_dim=256, period_pattern=("local",) * 5 + ("attn",),
    window_size=1024, rope_theta=1_000_000.0, act="gelu", tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16, window_size=8)
