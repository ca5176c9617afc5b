"""The lag search's operand ``cs2`` in one launch, ``csrc/pair_spectra.cu``.

The port's own kernel, not the counterpart of a TPU kernel: the JAX
package gathers the pairs' spectra and multiplies them in XLA
(``narrow_band_least_squares_tpu/ops/xcorr.py:214-220`` and ``:374-381``).
From the forward DFT's two products ``re = win @ Cf`` and ``s = win @ Sf``,
each (N, C, K) float32, and the (P, 2) pairs, it writes ``cs2``
(N * P, width): row ``n * P + p`` holds ``Re(F_j conj F_i)`` in columns
``[0, K)``, ``Im`` in ``[K, 2K)`` and zeros in ``[2K, width)``, where
``F = re - i s``.  The products and sums are rounded as the eager chain of
`pair_spectra_reference` rounds them, so the two agree bit for bit.

A CUDA tensor goes to the kernel and counts a launch in ``launches``; a CPU
tensor goes to `pair_spectra_reference`.  Both index the spectra as
PyTorch's indexing does: ``[-C, 0)`` counts from the end, and an index
outside ``[-C, C)`` is an error (on the card the kernel traps, which fails
the launch and leaves the CUDA context unusable, as a device-side assert
does).  The host never reads the pairs back from the card: a pipeline
checks them once, with `check_pairs`, where it builds them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as Fnn

# Launches of the kernel by the host since the count was last set to 0 (a
# CUDA graph's replay launches it again uncounted: models/graphs.py).
launches = 0

_bound = None


def _lib():
    global _bound
    if _bound is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("pair_spectra")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbls_pair_spectra.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        lib.nbls_pair_spectra.restype = ctypes.c_int
        lib.nbls_pair_spectra_max_elements.argtypes = []
        lib.nbls_pair_spectra_max_elements.restype = ctypes.c_int
        _bound = lib
    return _bound


def check_pairs(pairs, nchans: int) -> None:
    """Raises unless ``pairs`` is (P, 2) with every index in ``[0, nchans)``,
    on the host, so that no step reaches the kernel's trap."""
    a = np.asarray(pairs)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"pairs must be (P, 2); got {a.shape}")
    if a.size and (a.min() < 0 or a.max() >= nchans):
        raise ValueError(f"pair indices must lie in [0, {nchans}); got "
                         f"[{a.min()}, {a.max()}]")


def pair_spectra_reference(re: torch.Tensor, s: torch.Tensor, pairs: torch.Tensor,
                           width: int) -> torch.Tensor:
    """Plain version: the pair gathers, products and ``cat`` of the eager
    chain, then the zero columns up to ``width``."""
    ImF = -s
    i, j = pairs[:, 0], pairs[:, 1]
    ReI, ImI = re[:, i, :], ImF[:, i, :]
    ReJ, ImJ = re[:, j, :], ImF[:, j, :]
    ReCS = ReJ * ReI + ImJ * ImI                     # F_j * conj(F_i)
    ImCS = ImJ * ReI - ReJ * ImI
    K = ReCS.shape[-1]
    cs2 = torch.cat([ReCS, ImCS], dim=-1).reshape(-1, 2 * K)
    return Fnn.pad(cs2, (0, width - 2 * K))


def _check(re, s, pairs, width):
    if re.dim() != 3 or s.shape != re.shape:
        raise ValueError(f"pair_spectra needs re and s of one shape (N, C, K); got "
                         f"{tuple(re.shape)} and {tuple(s.shape)}")
    if pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"pair_spectra needs pairs (P, 2); got {tuple(pairs.shape)}")
    if re.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError(f"pair_spectra needs float32 re/s; got {re.dtype}, {s.dtype}")
    if pairs.dtype != torch.int64:
        raise TypeError(f"pair_spectra needs int64 pairs; got {pairs.dtype}")
    if int(width) < 2 * re.shape[2]:
        raise ValueError(f"pair_spectra needs width >= 2K = {2 * re.shape[2]}; "
                         f"got {width}")
    devs = {t.device for t in (re, s, pairs)}
    if len(devs) != 1:
        raise ValueError(f"pair_spectra inputs lie on several devices: {devs}")
    for name, t in (("re", re), ("s", s), ("pairs", pairs)):
        if not t.is_contiguous():
            raise ValueError(f"pair_spectra needs a contiguous {name}")


def pair_spectra(re: torch.Tensor, s: torch.Tensor, pairs: torch.Tensor,
                 width: int) -> torch.Tensor:
    """``cs2`` (N * P, width) from ``re``/``s`` (N, C, K) and ``pairs``
    (P, 2) int64 (module docstring): on the card the kernel, on the CPU
    `pair_spectra_reference`."""
    global launches
    _check(re, s, pairs, width)
    dev = re.device
    if dev.type == "cpu":
        return pair_spectra_reference(re, s, pairs, int(width))
    if dev.type != "cuda":
        raise ValueError(f"pair_spectra runs on cuda or cpu tensors, not {dev}")
    N, C, K = re.shape
    P = pairs.shape[0]
    out = torch.empty((N * P, int(width)), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    if C > lib.nbls_pair_spectra_max_elements():
        raise ValueError(f"pair_spectra takes at most "
                         f"{lib.nbls_pair_spectra_max_elements()} elements; got {C}")
    with torch.cuda.device(dev):
        err = lib.nbls_pair_spectra(re.data_ptr(), s.data_ptr(), pairs.data_ptr(),
                                    out.data_ptr(), N, C, P, K, int(width),
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_spectra kernel launch failed: CUDA error {err}")
    launches += 1
    return out
