"""The exact time-domain SOS recurrence, ``csrc/sosfilt.cu``.

The port's own CUDA kernel, not the counterpart of a TPU kernel: the JAX
package runs this recurrence with ``lax.scan``
(``narrow_band_least_squares_tpu/ops/filters.py::sosfilt_scan``) as the
cross-check of its frequency-domain filter bank.  For every row of x and
every sample, the second-order sections are cascaded in turn (transposed
direct-form II), in the JAX package's order of operations and with the
roundings of its compiled scan:

    ys = fma(b0, y, z1)
    z1 = fma(b1, y, -(a1 * ys)) + z2
    z2 = fma(b2, y, -(a2 * ys))

XLA's CPU backend contracts each statement's first product, the one with
the section's input y, into the add or subtract that takes it (one
rounding); ``a1 * ys`` and ``a2 * ys`` are rounded (read from the
optimized IR of ``lax.scan`` for 1, 2 and 4 sections and the zero-phase
pair, ``scripts/xla_contractions.py --sosfilt``).  In float64, which the
JAX package never scans (it runs float32), every multiply and add is
rounded on its own, as scipy's ``sosfilt`` does.

A CUDA tensor goes to the kernel (float32, one thread per row) and counts
a launch in ``launches``; a CPU tensor goes to ``sosfilt_reference``, a
loop over the samples on the exact float32 fused multiply-add of
`ops.kernels.lts_sweep.fma`, which the kernel equals bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from narrow_band_least_squares_tpu_torch.ops.kernels.lts_sweep import fma

# Launches of the kernel since the count was last set to 0.
launches = 0

_bound = None


def _lib():
    global _bound
    if _bound is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("sosfilt")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbls_sosfilt.argtypes = [p, p, p, i, i, ctypes.c_longlong, p]
        lib.nbls_sosfilt.restype = ctypes.c_int
        lib.nbls_sosfilt_max_sections.argtypes = []
        lib.nbls_sosfilt_max_sections.restype = ctypes.c_int
        _bound = lib
    return _bound


def sosfilt_reference(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: the recurrence as a loop over samples, the rows of
    ``x`` (..., T) at once; ``sos`` (S, 6) cast to x's dtype.  float32
    contracts the products with y (the module docstring), any other dtype
    rounds every operation."""
    sos = sos.to(dtype=x.dtype, device=x.device)
    T = x.shape[-1]
    xf = x.reshape(-1, T)
    S, N = sos.shape[0], xf.shape[0]
    b0, b1, b2, a1, a2 = (sos[:, k] for k in (0, 1, 2, 4, 5))
    z1 = [torch.zeros(N, dtype=x.dtype, device=x.device) for _ in range(S)]
    z2 = [torch.zeros(N, dtype=x.dtype, device=x.device) for _ in range(S)]
    out = torch.empty_like(xf)
    contract = x.dtype == torch.float32
    for t in range(T):
        y = xf[:, t]
        for s in range(S):
            if contract:
                ys = fma(b0[s], y, z1[s])
                z1[s] = fma(b1[s], y, -(a1[s] * ys)) + z2[s]
                z2[s] = fma(b2[s], y, -(a2[s] * ys))
            else:
                ys = b0[s] * y + z1[s]
                z1[s] = (b1[s] * y - a1[s] * ys) + z2[s]
                z2[s] = b2[s] * y - a2[s] * ys
            y = ys
        out[:, t] = y
    return out.reshape(x.shape)


def sosfilt(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cascade ``sos`` (S, 6) over the last axis of ``x`` (..., T):
    on the card the kernel (float32), on the CPU `sosfilt_reference`."""
    global launches
    if sos.dim() != 2 or sos.shape[1] != 6:
        raise ValueError(f"sosfilt needs sos of shape (S, 6); got {tuple(sos.shape)}")
    if x.device.type == "cpu":
        return sosfilt_reference(sos, x)
    if x.device.type != "cuda":
        raise ValueError(f"sosfilt runs on cuda or cpu tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"sosfilt on the card needs float32 x; got {x.dtype}")
    lib = _lib()
    S = sos.shape[0]
    if S > lib.nbls_sosfilt_max_sections():
        raise ValueError(f"sosfilt takes at most {lib.nbls_sosfilt_max_sections()} "
                         f"sections; got {S}")
    T = x.shape[-1]
    xf = x.reshape(-1, T).contiguous()
    coef = sos.to(dtype=torch.float32, device=x.device).contiguous()
    y = torch.empty_like(xf)
    if xf.numel() == 0:
        return y.reshape(x.shape)
    with torch.cuda.device(x.device):
        err = lib.nbls_sosfilt(xf.data_ptr(), y.data_ptr(), coef.data_ptr(), S,
                               xf.shape[0], T,
                               torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sosfilt kernel launch failed: CUDA error {err}")
    launches += 1
    return y.reshape(x.shape)
