from .kernel import LAUNCHES, lattice_rollup_cuda

__all__ = ["LAUNCHES", "lattice_rollup_cuda"]
