"""Fused inverse-DFT correlation + masked first-max peak search.

Port of ``narrow_band_least_squares_tpu/ops/kernels/xcorr_peak.py::icorr_peak``
(Pallas, TPU) to CUDA C++ kernels for Hopper.  For every row r::

    peak[r] = max_{lo[r] <= l <= hi[r]} (cs2 @ e2)[r, l]
    idx[r]  = the first l that reaches it

The (R, nlag) correlation never reaches device memory.  The product runs
at the caller's ``precision``, mapped from the TPU's as follows:

- ``'highest'``: IEEE fp32 on the CUDA cores, ``csrc/xcorr_peak.cu`` (the
  tile of ``csrc/simt_tile.cuh``), against ``e2`` with its lag axis padded
  to the 128-lag tile (`pad_lag_table`);
- ``'high'`` (bf16x3 on the TPU): 3xTF32 on the tensor cores, each operand
  split as ``hi = rna_tf32(x)``, ``lo = rna_tf32(x - hi)`` and the product
  taken as ``lo.hi + hi.lo + hi.hi`` in fp32, ``csrc/xcorr_peak_tc.cu``;
- ``'default'`` (one bf16 pass): 1xTF32, ``hi.hi``, the same kernel.

With ``neighbours=True`` (sub-sample delays) each row also gets the
correlations at ``idx - 1`` and ``idx + 1``, taken from the same product
as the peak, unmasked (they may lie outside ``[lo, hi]``), and 0 where the
neighbour is not a lag of the table (``idx`` 0 or ``nlag - 1``) or the row
has no valid lag.  On the card they come from the tile's own accumulators
(the neighbour epilogue of both routes), so they carry the peak's rounding,
and ``(peak, idx)`` are those of the integer search.

A CUDA tensor always goes to a kernel, and each route counts its launches
(``launches``: fp32; ``launches_tc``: tensor cores; ``launches_nb`` and
``launches_nb_tc``: the same routes with neighbours).  Each route reads e2
in its own layout, built once by `prepare` when the pipeline is built and
passed to every call as ``prepared``.  A CPU tensor goes to
``icorr_peak_reference`` in IEEE fp32 whatever the precision, as XLA on the
CPU ignores the hint: the port equals the JAX package there.
``icorr_peak_reference(..., precision=)`` emulates the split on any device;
the card holds the tensor-core kernel against it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as Fnn

from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul

PRECISIONS = ("highest", "high", "default")
# tf32 products per fp32 multiply-add on the tensor-core route
TF32_PRODUCTS = {"high": 3, "default": 1}
# lags per tile and K per block of the tensor-core kernel: the split e2
# table's row and column padding
LAG_TILE_TC = 128
K_BLOCK_TC = 32
# lags per tile and K per chunk of the fp32 kernel: the padded e2 table's
# column and row padding
LAG_TILE_F32 = 128
K_CHUNK_F32 = 16

# Launches of each CUDA route by the host since the count was last set to 0
# (a CUDA graph's replay launches them again uncounted: models/graphs.py).
launches = 0         # 'highest': the fp32 CUDA-core kernel
launches_tc = 0      # 'high' / 'default': the tensor-core kernel
launches_nb = 0      # 'highest' with neighbours
launches_nb_tc = 0   # 'high' / 'default' with neighbours

_bound = None
_bound_tc = None


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown matmul precision {precision!r}; expected one of {PRECISIONS}"
        )


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: integer operations on the fp32 bits.
    ±inf and NaN pass through; a value past the largest tf32 becomes inf."""
    b = x.contiguous().view(torch.int32)
    special = (b & 0x7F800000) == 0x7F800000
    r = torch.where(special, b, (b + 0x1000) & -0x2000)
    return r.view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with ``hi = rna(x)`` and ``lo = rna(x - hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def transpose_split_table(e2: torch.Tensor) -> torch.Tensor:
    """``e2 (K2, nlag)`` -> ``(2, nlag_p, K2_p)``: the split of ``e2ᵀ``
    (hi, lo), K-major as ``wgmma`` takes tf32 B, zero-padded to ``nlag_p``
    rows (``nlag`` rounded up to ``LAG_TILE_TC``) and ``K2_p`` columns
    (``K2`` rounded up to ``K_BLOCK_TC``; the pipeline's K2 is already a
    multiple of 128).  A constant of the pipeline, built once with it."""
    K2, nlag = e2.shape
    et = Fnn.pad(e2.t(), (0, _round_up(K2, K_BLOCK_TC) - K2,
                          0, _round_up(nlag, LAG_TILE_TC) - nlag))
    return torch.stack(tf32_split(et)).contiguous()


def pad_lag_table(e2: torch.Tensor) -> torch.Tensor:
    """``e2 (K2, nlag)`` -> ``(K2_p, nlag_p)``, zero-padded to ``nlag_p``
    columns (``nlag`` rounded up to ``LAG_TILE_F32``) and ``K2_p`` rows
    (``K2`` rounded up to ``K_CHUNK_F32``; the pipeline's K2 is already a
    multiple of 128): the operand of the fp32 route, whose tiles then load
    only aligned float4.  A constant of the pipeline, built once with it."""
    K2, nlag = e2.shape
    return Fnn.pad(e2, (0, _round_up(nlag, LAG_TILE_F32) - nlag,
                        0, _round_up(K2, K_CHUNK_F32) - K2)).contiguous()


def prepare(e2: torch.Tensor, precision: str) -> torch.Tensor:
    """The operand of ``e2`` that the card route of ``precision`` reads:
    `pad_lag_table` for the fp32 route, `transpose_split_table` for the
    tensor cores, on ``e2``'s device.  A constant of the pipeline, built
    once with it on the card and passed to `icorr_peak` as ``prepared``."""
    check_precision(precision)
    return pad_lag_table(e2) if precision == "highest" else transpose_split_table(e2)


def _product(cs2, e2, precision):
    """``cs2 @ e2`` at ``precision`` from fp32 matmuls: the split products
    summed small terms first, as the tensor-core kernel takes them."""
    with fp32_matmul():
        if precision == "highest":
            return cs2 @ e2
        a_hi, a_lo = tf32_split(cs2)
        b_hi, b_lo = tf32_split(e2)
        if precision == "default":
            return a_hi @ b_hi
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def icorr_peak_reference(
    cs2: torch.Tensor,       # (R, K2) float32
    e2: torch.Tensor,        # (K2, nlag) float32
    lo: torch.Tensor,        # (R,) int32
    hi: torch.Tensor,        # (R,) int32
    precision: str = "highest",
    neighbours: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain version: the product at ``precision`` (fp32 matmuls, the tf32
    split emulated bit for bit), a [lo, hi] mask, max, first argmax; with
    ``neighbours`` also (cm, cp), gathered from the unmasked product."""
    check_precision(precision)
    cc = _product(cs2, e2, precision)
    nlag = cc.shape[1]
    col = torch.arange(nlag, device=cc.device, dtype=torch.int32)
    valid = (col[None, :] >= lo[:, None]) & (col[None, :] <= hi[:, None])
    ccm = torch.where(valid, cc, torch.tensor(-torch.inf, dtype=cc.dtype,
                                              device=cc.device))
    peak = ccm.amax(dim=1)
    first = torch.where(ccm == peak[:, None], col[None, :],
                        torch.iinfo(torch.int32).max)
    idx = first.amin(dim=1)
    empty = torch.isneginf(peak)
    idx = torch.where(empty, torch.zeros_like(idx), idx)
    if not neighbours:
        return peak, idx
    zero = torch.zeros((), dtype=cc.dtype, device=cc.device)

    def at(k, ok):
        v = torch.gather(cc, 1, k.clamp(0, nlag - 1).long()[:, None])[:, 0]
        return torch.where(ok & ~empty, v, zero)

    return peak, idx, at(idx - 1, idx > 0), at(idx + 1, idx < nlag - 1)


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
        lib.nbls_icorr_peak_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.nbls_icorr_peak_f32.restype = ctypes.c_int
        lib.nbls_icorr_peak_f32_nb.argtypes = [p] * 11 + [i, i, i, i, p]
        lib.nbls_icorr_peak_f32_nb.restype = ctypes.c_int
        for fn, want in ((lib.nbls_icorr_peak_lag_tile, LAG_TILE_F32),
                         (lib.nbls_icorr_peak_k_chunk, K_CHUNK_F32)):
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"xcorr_peak's {fn.__name__} is {fn()}, the "
                                   f"padded e2 tables assume {want}")
        _bound = lib
    return _bound


def _lib_tc():
    global _bound_tc
    if _bound_tc is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("xcorr_peak_tc")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbls_icorr_peak_tc.argtypes = [p, p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, p]
        lib.nbls_icorr_peak_tc.restype = ctypes.c_int
        lib.nbls_icorr_peak_tc_nb.argtypes = [p] * 12 + [i, i, i, i, i, p]
        lib.nbls_icorr_peak_tc_nb.restype = ctypes.c_int
        lib.nbls_icorr_peak_tc_lag_tile.argtypes = []
        lib.nbls_icorr_peak_tc_lag_tile.restype = ctypes.c_int
        lib.nbls_icorr_peak_tc_smem_bytes.argtypes = [i]
        lib.nbls_icorr_peak_tc_smem_bytes.restype = ctypes.c_int
        if lib.nbls_icorr_peak_tc_lag_tile() != LAG_TILE_TC:
            raise RuntimeError(
                f"xcorr_peak_tc's lag tile is {lib.nbls_icorr_peak_tc_lag_tile()}, "
                f"the split tables are padded to {LAG_TILE_TC}"
            )
        _bound_tc = lib
    return _bound_tc


def _check_aligned(name, t):
    if t.data_ptr() % 16:
        raise ValueError(f"icorr_peak needs a 16-byte aligned {name}")


def _launch_f32(cs2, e2, e2p, lo, hi, peak, idx, nb=None):
    nlag = e2.shape[1]
    K2 = _round_up(cs2.shape[1], K_CHUNK_F32)
    if K2 != cs2.shape[1]:   # whole K chunks; zero columns add nothing
        cs2 = Fnn.pad(cs2, (0, K2 - cs2.shape[1]))
    R = cs2.shape[0]
    nlag_p = _round_up(nlag, LAG_TILE_F32)
    if (e2p.shape != (K2, nlag_p) or e2p.dtype != torch.float32
            or e2p.device != cs2.device or not e2p.is_contiguous()):
        raise ValueError(
            f"icorr_peak needs e2 padded to ({K2}, {nlag_p}) float32 "
            f"contiguous on {cs2.device} (prepare(e2, 'highest')); got "
            f"{tuple(e2p.shape)} {e2p.dtype} on {e2p.device}"
        )
    _check_aligned("cs2", cs2)
    _check_aligned("e2p", e2p)
    ntiles = nlag_p // LAG_TILE_F32
    if ntiles * R >= 2**31 or R * K2 >= 2**40:
        raise ValueError(f"icorr_peak shape out of range: R={R}, K2={K2}, nlag={nlag}")
    lib = _lib()
    part_val = torch.empty((ntiles, R), dtype=torch.float32, device=cs2.device)
    part_idx = torch.empty((ntiles, R), dtype=torch.int32, device=cs2.device)
    stream = torch.cuda.current_stream(cs2.device).cuda_stream
    if nb is not None:
        part_nb = torch.empty((4, ntiles, R), dtype=torch.float32, device=cs2.device)
        return lib.nbls_icorr_peak_f32_nb(
            cs2.data_ptr(), e2p.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            peak.data_ptr(), idx.data_ptr(), nb[0].data_ptr(), nb[1].data_ptr(),
            part_val.data_ptr(), part_idx.data_ptr(), part_nb.data_ptr(),
            R, K2, nlag, nlag_p, stream,
        )
    return lib.nbls_icorr_peak_f32(
        cs2.data_ptr(), e2p.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        peak.data_ptr(), idx.data_ptr(), part_val.data_ptr(),
        part_idx.data_ptr(), R, K2, nlag, nlag_p, stream,
    )


def _launch_tc(cs2, e2, e2t, lo, hi, peak, idx, nprod, nb=None):
    nlag = e2.shape[1]
    K2 = _round_up(cs2.shape[1], K_BLOCK_TC)
    if K2 != cs2.shape[1]:   # whole K blocks; zero columns add nothing
        cs2 = Fnn.pad(cs2, (0, K2 - cs2.shape[1]))
    R = cs2.shape[0]
    nlag_p = _round_up(nlag, LAG_TILE_TC)
    if (e2t.shape != (2, nlag_p, K2) or e2t.dtype != torch.float32
            or e2t.device != cs2.device or not e2t.is_contiguous()):
        raise ValueError(
            f"icorr_peak needs the split table of e2, (2, {nlag_p}, {K2}) "
            f"float32 contiguous on {cs2.device} (prepare(e2, precision)); got "
            f"{tuple(e2t.shape)} {e2t.dtype} on {e2t.device}"
        )
    ntiles = nlag_p // LAG_TILE_TC
    if ntiles * R >= 2**31 or max(R, nlag_p) * K2 >= 2**31:
        raise ValueError(f"icorr_peak shape out of range: R={R}, K2={K2}, nlag={nlag}")
    lib = _lib_tc()
    dev = cs2.device
    a_split = torch.empty((2 if nprod == 3 else 1, R, K2), dtype=torch.float32,
                          device=dev)
    part_val = torch.empty((ntiles, R), dtype=torch.float32, device=dev)
    part_idx = torch.empty((ntiles, R), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if nb is not None:
        part_nb = torch.empty((4, ntiles, R), dtype=torch.float32, device=dev)
        return lib.nbls_icorr_peak_tc_nb(
            cs2.data_ptr(), a_split.data_ptr(), e2t.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), peak.data_ptr(), idx.data_ptr(), nb[0].data_ptr(),
            nb[1].data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
            part_nb.data_ptr(), R, K2, nlag, nlag_p, nprod, stream,
        )
    return lib.nbls_icorr_peak_tc(
        cs2.data_ptr(), a_split.data_ptr(), e2t.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), peak.data_ptr(), idx.data_ptr(), part_val.data_ptr(),
        part_idx.data_ptr(), R, K2, nlag, nlag_p, nprod, stream,
    )


def icorr_peak(
    cs2: torch.Tensor,       # (R, K2) float32 stacked [Re(CS) | Im(CS)]
    e2: torch.Tensor,        # (K2, nlag) float32 stacked [Ec ; -Es]
    lo: torch.Tensor,        # (R,) int32 first valid lag index per row
    hi: torch.Tensor,        # (R,) int32 last valid lag index per row
    *,
    precision: str = "highest",
    prepared: Optional[torch.Tensor] = None,   # prepare(e2, precision)
    neighbours: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Fused ``argmax_l (cs2 @ e2)[:, lo:hi]``.  Returns (peak (R,) f32, idx
    (R,) i32), and with ``neighbours`` also (cm (R,), cp (R,)) f32, the
    correlations at idx -/+ 1 (module docstring).

    Rows are masked by [lo, hi] only; zero-padded K2 columns are harmless.
    A row with no valid lag gives (-inf, 0).  ``precision`` picks the CUDA
    route (module docstring); on the CPU the product is IEEE fp32 whatever
    it says.  On the card ``prepared`` must be ``prepare(e2, precision)``;
    off it, it is ignored.
    """
    global launches, launches_tc, launches_nb, launches_nb_tc
    check_precision(precision)
    _check(cs2, e2, lo, hi)
    dev = cs2.device
    if dev.type == "cpu":
        return icorr_peak_reference(cs2, e2, lo, hi, neighbours=neighbours)
    if dev.type != "cuda":
        raise ValueError(f"icorr_peak runs on cuda or cpu tensors, not {dev}")
    for name, t in (("cs2", cs2), ("e2", e2), ("lo", lo), ("hi", hi)):
        if not t.is_contiguous():
            raise ValueError(f"icorr_peak needs a contiguous {name}")
    R = cs2.shape[0]
    peak = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    nb = (torch.empty((2, R), dtype=torch.float32, device=dev)
          if neighbours else None)
    out = (peak, idx) if nb is None else (peak, idx, nb[0], nb[1])
    if R == 0:
        return out
    if e2.shape[1] == 0:
        raise ValueError("icorr_peak needs at least one lag column")
    if prepared is None:
        raise ValueError("icorr_peak on the card needs prepared=prepare(e2, "
                         f"{precision!r}), built once with the tables")
    with torch.cuda.device(dev):
        if precision == "highest":
            err = _launch_f32(cs2, e2, prepared, lo, hi, peak, idx, nb)
        else:
            err = _launch_tc(cs2, e2, prepared, lo, hi, peak, idx,
                             TF32_PRODUCTS[precision], nb)
    if err != 0:
        raise RuntimeError(
            f"icorr_peak ({precision}) kernel launch failed: "
            + {-1: "the driver has no cuTensorMapEncodeTiled",
               -2: "a TMA tensor map was refused"}.get(err, f"CUDA error {err}")
        )
    if precision == "highest":
        if neighbours:
            launches_nb += 1
        else:
            launches += 1
    elif neighbours:
        launches_nb_tc += 1
    else:
        launches_tc += 1
    return out
