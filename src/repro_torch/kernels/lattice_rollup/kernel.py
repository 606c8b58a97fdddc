"""ctypes binding of the CUDA lattice roll-up (``csrc/lattice_rollup.cu``),
row A1 of the kernel table.

The source is compiled for ``sm_90a`` with ``-fmad=false`` at first use
(:mod:`repro_torch.kernels.build`) and loaded once per process.
:func:`lattice_rollup_cuda` checks its operands, allocates the outputs with
``torch.empty`` on their device, launches one kernel for the whole spec
stack on torch's current stream without synchronising, raises if the
launch was refused, and adds one to :data:`LAUNCHES`.  It takes CUDA
tensors only: the dispatcher :func:`repro_torch.core.batched.eval_lattice`
runs the plain version (:func:`repro_torch.core.batched._eval_kernel`) for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library

#: Kernel launches, one per spec group.
LAUNCHES = {"rollup": 0}

#: The gather indices, the tables and the outputs, in the kernel's order.
INDICES = ("mem_i", "mm_i", "csa_j", "ofu_j", "prec_j")
TABLES = ("t_wl_mm", "csa_crit", "t_ofu", "a_array", "a_mult", "a_tree",
          "a_ofu", "a_align", "e_mm", "e_tree")
_OUTPUTS = ("mac_base", "ofu_base", "area", "sram_array", "multmux",
            "adder_tree", "ofu", "align")
_CONSTS = 8

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


class _Args(ctypes.Structure):
    """``RollupArgs`` of the source: every field 8 bytes, in its order."""

    _fields_ = [("idx", _P * len(INDICES)), ("tabs", _P * len(TABLES)),
                ("tab_len", _I64 * len(TABLES)), ("consts", _P),
                ("e_ofu", _P), ("e_align", _P), ("n_ofu", _I64),
                ("n_align", _I64), ("n", _I64), ("specs", _I64),
                ("modes", _I64), ("out", _P * len(_OUTPUTS)),
                ("e_cycle", _P)]


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build_library("lattice_rollup"))


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` (a build of ``csrc/lattice_rollup.cu`` or of
    a variant of its text with the same C interface), loaded and typed."""
    lib = ctypes.CDLL(str(path))
    lib.lattice_rollup.argtypes = [ctypes.POINTER(_Args), _P]
    lib.lattice_rollup.restype = ctypes.c_int
    lib.lattice_rollup_smem_bytes.argtypes = [ctypes.POINTER(_Args)]
    lib.lattice_rollup_smem_bytes.restype = _I64
    lib.lattice_rollup_error_string.argtypes = [ctypes.c_int]
    lib.lattice_rollup_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int,
           device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the indices on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lattice_rollup_cuda(idx, tabs, consts: torch.Tensor,
                        e_ofu_m: torch.Tensor, e_align_m: torch.Tensor
                        ) -> dict:
    """The roll-up of :func:`repro_torch.core.batched._eval_kernel` on the
    card, in one launch: ``idx`` the five int64 (n,) gather indices shared
    by the group, ``tabs`` the ten float64 (S, len) tables, ``consts`` (S,
    8), ``e_ofu_m`` (S, M, n_ofu) and ``e_align_m`` (S, M, n_align), all
    contiguous on one CUDA device.  Returns the plain version's outputs,
    laid out as it lays them out, with the same bits."""
    if len(idx) != len(INDICES) or len(tabs) != len(TABLES):
        raise ValueError(f"want {len(INDICES)} indices and {len(TABLES)} "
                         f"tables, got {len(idx)} and {len(tabs)}")
    if not idx[0].is_cuda:
        raise ValueError(f"mem_i must be a CUDA tensor, got {idx[0].device}")
    device = idx[0].device
    n = idx[0].shape[0] if idx[0].dim() == 1 else -1
    for name, t in zip(INDICES, idx):
        _check(name, t, torch.int64, 1, device)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} points, mem_i {n}")
    _check("consts", consts, torch.float64, 2, device)
    specs = consts.shape[0]
    if consts.shape[1] != _CONSTS:
        raise ValueError(f"consts must be (S, {_CONSTS}), got "
                         f"{tuple(consts.shape)}")
    for name, t in zip(TABLES, tabs):
        _check(name, t, torch.float64, 2, device)
        if t.shape[0] != specs or t.shape[1] < 1:
            raise ValueError(f"{name} must be ({specs}, len >= 1), got "
                             f"{tuple(t.shape)}")
    for name, t in (("e_ofu_m", e_ofu_m), ("e_align_m", e_align_m)):
        _check(name, t, torch.float64, 3, device)
        if t.shape[0] != specs or t.shape[2] < 1:
            raise ValueError(f"{name} must be ({specs}, M, len >= 1), got "
                             f"{tuple(t.shape)}")
    modes = e_ofu_m.shape[1]
    if e_align_m.shape[1] != modes:
        raise ValueError(f"e_ofu_m has {modes} modes, e_align_m "
                         f"{e_align_m.shape[1]}")

    outs = [torch.empty((specs, n), dtype=torch.float64, device=device)
            for _ in _OUTPUTS]
    e_cycle = torch.empty((specs, modes, n), dtype=torch.float64,
                          device=device)
    args = _Args(
        idx=(_P * len(INDICES))(*(t.data_ptr() for t in idx)),
        tabs=(_P * len(TABLES))(*(t.data_ptr() for t in tabs)),
        tab_len=(_I64 * len(TABLES))(*(t.shape[1] for t in tabs)),
        consts=consts.data_ptr(), e_ofu=e_ofu_m.data_ptr(),
        e_align=e_align_m.data_ptr(), n_ofu=e_ofu_m.shape[2],
        n_align=e_align_m.shape[2], n=n, specs=specs, modes=modes,
        out=(_P * len(_OUTPUTS))(*(t.data_ptr() for t in outs)),
        e_cycle=e_cycle.data_ptr())
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lattice_rollup(ctypes.byref(args), stream)
    if err != 0:
        msg = lib.lattice_rollup_error_string(err).decode()
        raise RuntimeError(
            f"lattice_rollup launch failed: CUDA error {err} ({msg}); "
            f"{lib.lattice_rollup_smem_bytes(ctypes.byref(args))} bytes of "
            "tables per spec")
    LAUNCHES["rollup"] += 1
    got = dict(zip(_OUTPUTS, outs))
    return {"mac_base": got["mac_base"], "ofu_base": got["ofu_base"],
            "area": got["area"],
            "breakdown": {
                "sram_array": got["sram_array"], "multmux": got["multmux"],
                "adder_tree": got["adder_tree"],
                "shift_adder": consts[:, 1:2].expand(-1, n),
                "ofu": got["ofu"], "align": got["align"],
                "drivers": consts[:, 2:3].expand(-1, n)},
            "e_cycle": e_cycle}
