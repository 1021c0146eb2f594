"""internvl2-76b [vlm] — InternViT + LLM backbone (arXiv:2404.16821).

Copy of ``repro/configs/internvl2_76b.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.
Backbone only (80L Llama3-70B-class decoder); the ViT frontend is a STUB:
input_specs() provides precomputed patch embeddings prepended to the text."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    head_dim=128, rope_theta=500_000.0, num_patches=1024,
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16, num_patches=16)
