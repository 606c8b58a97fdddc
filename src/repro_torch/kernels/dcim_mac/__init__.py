from .ops import dcim_matmul, dcim_matmul_int
from .kernel import LAUNCHES, dcim_mac_cuda, dcim_mac_int_cuda
from .plan import MacPlan, mac_plan, mac_route
from . import ref

__all__ = ["dcim_matmul", "dcim_matmul_int", "dcim_mac_cuda",
           "dcim_mac_int_cuda", "LAUNCHES", "MacPlan", "mac_plan",
           "mac_route", "ref"]
