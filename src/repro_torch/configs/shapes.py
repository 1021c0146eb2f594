"""Assigned input shapes (paired with every architecture).

Copy of ``repro/configs/shapes.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout."""
from .base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", "train", seq_len=4096, global_batch=256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", seq_len=32768, global_batch=32)
DECODE_32K = ShapeConfig("decode_32k", "decode", seq_len=32768, global_batch=128)
LONG_500K = ShapeConfig("long_500k", "decode", seq_len=524288, global_batch=1)

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}

# long_500k runs only for sub-quadratic archs (see DESIGN.md shape-skip notes)
SUBQUADRATIC_ARCHS = {"gemma3-12b", "gemma3-27b", "jamba-v0.1-52b", "xlstm-125m"}


def shapes_for(arch_name: str) -> list[ShapeConfig]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_name in SUBQUADRATIC_ARCHS:
        out.append(LONG_500K)
    return out
