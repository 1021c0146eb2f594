"""seamless-m4t-large-v2 [audio] — encoder-decoder transformer backbone

Copy of ``repro/configs/seamless_m4t_large_v2.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.
(arXiv:2308.11596).  24 encoder + 24 decoder layers, d=1024, 16H, ff=8192.
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model) for the encoder."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", num_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=8192,
    vocab_size=256206, head_dim=64, enc_layers=24, frame_input=True,
    act="relu",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                       d_ff=128, vocab_size=512, head_dim=16, enc_layers=2)
