from .kernel import (LAUNCHES, MAX_OBJECTIVES, PASS_LAUNCHES, SCREEN_ROWS,
                     pareto_dominated_cuda, passes)

__all__ = ["LAUNCHES", "MAX_OBJECTIVES", "PASS_LAUNCHES", "SCREEN_ROWS",
           "pareto_dominated_cuda", "passes"]
