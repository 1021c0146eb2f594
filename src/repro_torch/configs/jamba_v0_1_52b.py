"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2

Copy of ``repro/configs/jamba_v0_1_52b.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.
every other layer (arXiv:2403.19887): period-8 blocks, attention at
position 3, 32 layers = 4 periods exactly."""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    head_dim=128,
    period_pattern=("mamba", "mamba", "mamba", "attn",
                    "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = CONFIG.replace(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16,
                       moe=MoEConfig(num_experts=4, top_k=2, every=2),
                       ssm=SSMConfig(d_state=4, d_conv=4, expand=2))
