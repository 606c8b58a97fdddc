from .kernel import ssm_scan_cuda
from .ops import ssm_scan
from .ref import (ssm_chunks, ssm_scan_assoc_ref, ssm_scan_chunked_ref,
                  ssm_scan_ref)

__all__ = ["ssm_scan_cuda", "ssm_scan", "ssm_chunks", "ssm_scan_assoc_ref",
           "ssm_scan_chunked_ref", "ssm_scan_ref"]
