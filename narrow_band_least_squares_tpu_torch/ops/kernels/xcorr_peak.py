"""Fused inverse-DFT correlation + masked first-max peak search.

Port of ``narrow_band_least_squares_tpu/ops/kernels/xcorr_peak.py::icorr_peak``
(Pallas, TPU) to a CUDA C++ kernel for Hopper, ``csrc/xcorr_peak.cu``.  For
every row r::

    peak[r] = max_{lo[r] <= l <= hi[r]} (cs2 @ e2)[r, l]
    idx[r]  = the first l that reaches it

The (R, nlag) correlation never reaches device memory.  A CUDA tensor always
goes to the kernel; a CPU tensor goes to ``icorr_peak_reference``, the plain
PyTorch version, which the tests hold against the JAX kernel and the card
holds the CUDA kernel against.  The kernel computes in fp32 whatever matmul
precision the caller names.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0

_bound = None


def icorr_peak_reference(
    cs2: torch.Tensor,       # (R, K2) float32
    e2: torch.Tensor,        # (K2, nlag) float32
    lo: torch.Tensor,        # (R,) int32
    hi: torch.Tensor,        # (R,) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: one fp32 matmul, a [lo, hi] mask, max, first argmax."""
    with fp32_matmul():
        cc = cs2 @ e2
    col = torch.arange(cc.shape[1], device=cc.device, dtype=torch.int32)
    valid = (col[None, :] >= lo[:, None]) & (col[None, :] <= hi[:, None])
    ccm = torch.where(valid, cc, torch.tensor(-torch.inf, dtype=cc.dtype,
                                              device=cc.device))
    peak = ccm.amax(dim=1)
    first = torch.where(ccm == peak[:, None], col[None, :],
                        torch.iinfo(torch.int32).max)
    idx = first.amin(dim=1)
    idx = torch.where(torch.isneginf(peak), torch.zeros_like(idx), idx)
    return peak, idx


def _check(cs2, e2, lo, hi) -> None:
    if cs2.dim() != 2 or e2.dim() != 2 or cs2.shape[1] != e2.shape[0]:
        raise ValueError(
            f"icorr_peak needs cs2 (R, K2) and e2 (K2, nlag); got "
            f"{tuple(cs2.shape)} and {tuple(e2.shape)}"
        )
    R = cs2.shape[0]
    if lo.shape != (R,) or hi.shape != (R,):
        raise ValueError(
            f"icorr_peak needs lo and hi of shape ({R},); got "
            f"{tuple(lo.shape)} and {tuple(hi.shape)}"
        )
    if cs2.dtype != torch.float32 or e2.dtype != torch.float32:
        raise TypeError(f"icorr_peak needs float32 cs2/e2; got {cs2.dtype}, {e2.dtype}")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise TypeError(f"icorr_peak needs int32 lo/hi; got {lo.dtype}, {hi.dtype}")
    devs = {t.device for t in (cs2, e2, lo, hi)}
    if len(devs) != 1:
        raise ValueError(f"icorr_peak inputs lie on several devices: {devs}")


def _lib():
    global _bound
    if _bound is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("xcorr_peak")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbls_icorr_peak_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        lib.nbls_icorr_peak_f32.restype = ctypes.c_int
        lib.nbls_icorr_peak_lag_tile.argtypes = []
        lib.nbls_icorr_peak_lag_tile.restype = ctypes.c_int
        _bound = lib
    return _bound


def icorr_peak(
    cs2: torch.Tensor,       # (R, K2) float32 stacked [Re(CS) | Im(CS)]
    e2: torch.Tensor,        # (K2, nlag) float32 stacked [Ec ; -Es]
    lo: torch.Tensor,        # (R,) int32 first valid lag index per row
    hi: torch.Tensor,        # (R,) int32 last valid lag index per row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``argmax_l (cs2 @ e2)[:, lo:hi]``.  Returns (peak (R,) f32, idx (R,) i32).

    Rows are masked by [lo, hi] only; zero-padded K2 columns are harmless.
    A row with no valid lag gives (-inf, 0).
    """
    global launches
    _check(cs2, e2, lo, hi)
    dev = cs2.device
    if dev.type == "cpu":
        return icorr_peak_reference(cs2, e2, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"icorr_peak runs on cuda or cpu tensors, not {dev}")
    for name, t in (("cs2", cs2), ("e2", e2), ("lo", lo), ("hi", hi)):
        if not t.is_contiguous():
            raise ValueError(f"icorr_peak needs a contiguous {name}")
    R, K2 = cs2.shape
    nlag = e2.shape[1]
    peak = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return peak, idx
    if nlag == 0:
        raise ValueError("icorr_peak needs at least one lag column")
    lib = _lib()
    ntiles = -(-nlag // lib.nbls_icorr_peak_lag_tile())
    if ntiles * R >= 2**31 or R * K2 >= 2**40:
        raise ValueError(f"icorr_peak shape out of range: R={R}, K2={K2}, nlag={nlag}")
    part_val = torch.empty((ntiles, R), dtype=torch.float32, device=dev)
    part_idx = torch.empty((ntiles, R), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nbls_icorr_peak_f32(
            cs2.data_ptr(), e2.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            peak.data_ptr(), idx.data_ptr(), part_val.data_ptr(),
            part_idx.data_ptr(), R, K2, nlag, stream,
        )
    if err != 0:
        raise RuntimeError(f"icorr_peak kernel launch failed: CUDA error {err}")
    launches += 1
    return peak, idx
