"""NVIDIA H100 SXM5 80 GB figures for the roofline model.

Every figure is NVIDIA's data sheet for the H100 SXM at its maximum power
limit of 700 W (https://www.nvidia.com/en-us/data-center/h100/, the "H100
SXM" column), dense rates without sparsity.  A card set below 700 W
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) runs
slower under load than these.  The names keep the JAX package's
(``repro/roofline/hw.py``, TPU v5e); no TPU figure is carried over.
"""

#: bf16 tensor-core rate, FLOP/s per card: the data sheet's 1,979 TFLOPS
#: "with sparsity", halved (dense), H100 SXM at 700 W.
PEAK_BF16_FLOPS = 989e12

#: HBM3 bandwidth, bytes/s per card: 3.35 TB/s, H100 SXM at 700 W.
HBM_BW = 3.35e12

#: Device memory per card: 80 GB (data sheet), H100 SXM.
HBM_PER_CHIP = 80e9

#: NVLink bandwidth per card to the other cards of its host, both
#: directions together: 900 GB/s (data sheet), H100 SXM.  It takes the
#: place of the TPU's inter-chip links.
NVLINK_BW = 900e9


def compute_time_s(flops: float, chips: int) -> float:
    return flops / (chips * PEAK_BF16_FLOPS)


def memory_time_s(bytes_: float, chips: int) -> float:
    return bytes_ / (chips * HBM_BW)


def collective_time_s(coll_bytes_per_chip: float) -> float:
    """coll_bytes_per_chip: NVLink traffic already normalized per card and
    sent one way, at half of :data:`NVLINK_BW`."""
    return coll_bytes_per_chip / (NVLINK_BW / 2)
