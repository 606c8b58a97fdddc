from .kernel import (LAUNCHES, MAX_OBJECTIVES, PASS_LAUNCHES, SCREEN_ROWS,
                     WIDE_STAGE, pareto_dominated_cuda, passes, screen_rows)

__all__ = ["LAUNCHES", "MAX_OBJECTIVES", "PASS_LAUNCHES", "SCREEN_ROWS",
           "WIDE_STAGE", "pareto_dominated_cuda", "passes", "screen_rows"]
