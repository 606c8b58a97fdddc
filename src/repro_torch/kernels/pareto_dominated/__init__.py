from .kernel import LAUNCHES, MAX_OBJECTIVES, pareto_dominated_cuda

__all__ = ["LAUNCHES", "MAX_OBJECTIVES", "pareto_dominated_cuda"]
