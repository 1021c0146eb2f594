from .registry import KernelRegistry
from .dfg import DFG, Engine
from .xbuilder import XBuilder, Bitstream, shell_kernels, SHELL_DEVICE
from .service import HolisticGNNService, make_service_dfg
from . import gnn

__all__ = ["KernelRegistry", "DFG", "Engine", "XBuilder", "Bitstream",
           "shell_kernels", "SHELL_DEVICE", "HolisticGNNService",
           "make_service_dfg", "gnn"]
