from .ops import dcim_matmul, dcim_matmul_int
from .kernel import dcim_mac_cuda, dcim_mac_int_cuda
from . import ref

__all__ = ["dcim_matmul", "dcim_matmul_int", "dcim_mac_cuda",
           "dcim_mac_int_cuda", "ref"]
