"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + 1 shared expert, every

Copy of ``repro/configs/llama4_scout.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.
layer; early-fusion vision handled by the stubbed frontend."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=8192, vocab_size=202048,
    head_dim=128, rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, every=1, num_shared=1),
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16,
                       moe=MoEConfig(num_experts=4, top_k=1, every=1,
                                     num_shared=1))
