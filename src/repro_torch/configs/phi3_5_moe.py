"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, every layer.

Copy of ``repro/configs/phi3_5_moe.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=6400, vocab_size=32064,
    head_dim=128, moe=MoEConfig(num_experts=16, top_k=2, every=1),
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16,
                       moe=MoEConfig(num_experts=4, top_k=2, every=1))
