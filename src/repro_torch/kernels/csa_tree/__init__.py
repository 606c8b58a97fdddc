from .kernel import (CSA_MAX_ROWS, CSA_REG_ROWS, csa_tree_rows_cuda,
                     csa_tree_tiled_cuda)
from .ops import csa_tree_sum
from .ref import build_schedule, csa_tree_ref, reduce_lanes, reduce_levels

__all__ = ["CSA_MAX_ROWS", "CSA_REG_ROWS", "csa_tree_rows_cuda",
           "csa_tree_tiled_cuda", "csa_tree_sum", "csa_tree_ref",
           "build_schedule", "reduce_lanes", "reduce_levels"]
