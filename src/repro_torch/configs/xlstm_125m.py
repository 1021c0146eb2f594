"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517); 5:1

Copy of ``repro/configs/xlstm_125m.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.
mLSTM:sLSTM per period of 6, 12 layers = 2 periods.  Blocks carry their own
up/down projections (d_ff=0: no separate FFN)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", num_layers=12, d_model=768,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    head_dim=192,
    period_pattern=("mlstm",) * 5 + ("slstm",), tie_embeddings=True,
)

SMOKE = CONFIG.replace(num_layers=6, d_model=64, num_heads=4, num_kv_heads=4,
                       d_ff=0, vocab_size=512, head_dim=16)
