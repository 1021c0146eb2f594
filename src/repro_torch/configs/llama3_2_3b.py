"""llama3.2-3b [dense] — small llama3 (GQA kv=8).

Copy of ``repro/configs/llama3_2_3b.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=8192, vocab_size=128256,
    head_dim=128, rope_theta=500_000.0, tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16)
