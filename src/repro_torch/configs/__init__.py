"""Architecture registry: --arch <id> resolves through ARCHS.

Copy of ``repro/configs/__init__.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout."""
from . import (minicpm3_4b, gemma3_12b, llama3_2_3b, gemma3_27b,
               jamba_v0_1_52b, phi3_5_moe, llama4_scout, xlstm_125m,
               seamless_m4t_large_v2, internvl2_76b)
from .base import ModelConfig, ShapeConfig, RunConfig, MoEConfig, MLAConfig, SSMConfig
from .shapes import SHAPES, shapes_for, SUBQUADRATIC_ARCHS

_MODULES = [minicpm3_4b, gemma3_12b, llama3_2_3b, gemma3_27b, jamba_v0_1_52b,
            phi3_5_moe, llama4_scout, xlstm_125m, seamless_m4t_large_v2,
            internvl2_76b]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}

# paper's own models ship as presets too (GNN side)
GNN_PRESETS = {"gcn": {"dims": [256, 256, 256]},
               "gin": {"dims": [256, 256, 256]},
               "ngcf": {"dims": [256, 256, 256]}}

__all__ = ["ARCHS", "SMOKES", "SHAPES", "shapes_for", "SUBQUADRATIC_ARCHS",
           "ModelConfig", "ShapeConfig", "RunConfig", "MoEConfig",
           "MLAConfig", "SSMConfig", "GNN_PRESETS"]
