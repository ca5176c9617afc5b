"""Fused window extraction, cross-correlation and peak search per bucket.

Port of ``narrow_band_least_squares_tpu/ops/kernels/fused_xcorr.py::
fused_xcorr_bucket`` (Pallas, TPU) to a CUDA C++ kernel for Hopper,
``csrc/fused_xcorr.cu``.  For every band row g of one window-length bucket,
window w and element pair p = (i, j)::

    win     = the window starting at min(w * hop[g], maxstart[g]),
              masked by len_mask[g] and demeaned over its valid samples
    F       = win @ [Cf | -Sf]                 (forward DFT)
    CS      = F_j * conj(F_i)                  (cross-spectrum)
    cc      = Re CS @ Ec - Im CS @ Es          (inverse DFT at the lags)
    idx     = the first lag in [lo[g], hi[g]] reaching max cc
    rho     = max cc / sqrt(E_i * E_j)

The two products run at the caller's ``precision``, mapped from the TPU's
as in `xcorr_peak` (the TPU kernel's ``_kdot``: bf16x3 at 'high'):

- ``'highest'``: IEEE fp32 on the CUDA cores (the ring tile of
  ``csrc/simt_ring.cuh``): each product's K parts (`k_parts`) are the CTAs
  of one thread-block cluster, added on chip in part order;
- ``'high'``: 3xTF32 and ``'default'``: one tf32 pass in both products, on
  the tensor cores (the tile of ``csrc/peak_tile.cuh``), against the
  transposed split tables of `prepare`, built once per bucket with the
  pipeline.  At 'default' the cross-spectra, themselves products of long
  sums, are rounded to tf32 once, so an implementation that sums in another
  order agrees with the kernel only to that rounding.

At every precision the windows, the spectra and the cross-spectra pass
through L2-resident scratch, one chunk of windows at a time (the chunk
chosen so that no scratch buffer exceeds ``SCRATCH_FLOATS``); the
correlation never reaches device memory.  A CUDA tensor always goes to
the kernel of its route, and each route counts its launches (``launches``:
fp32; ``launches_tc``: tensor cores).  A CPU tensor goes to
``fused_xcorr_bucket_reference`` in IEEE fp32 whatever the precision, as XLA
on the CPU ignores the hint; the tests hold it against the JAX kernel.
``fused_xcorr_bucket_reference(..., precision=)`` emulates the tf32 split on
any device; the card holds each route against it.

Where the TPU kernel selects the pairs' spectra with block-diagonal one-hot
matmuls (``sbi``/``sbj``, a Mosaic workaround), the port reads them by
index from ``pairs``, so its tables are only Cf/Sf/Ec/Es.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul

# Launches of each CUDA route since the count was last set to 0.
launches = 0      # 'highest': the fp32 CUDA-core tiles
launches_tc = 0   # 'high' / 'default': the tensor-core tiles

# Kp and the lag columns of the tables: multiples of the kernels' tiles
TILE = 128
# parts of the forward DFT's sum over the samples: fp32 tile, tensor cores
KSPLIT_F32, KSPLIT_TC = 4, 3
# samples (frequencies) per K chunk: fp32 tile, tensor cores; every K part
# is whole chunks
K_CHUNK_F32, K_CHUNK_TC = 16, 32
# parts of the inverse DFT's sum over the frequencies at 'highest' (the
# CTAs of a cluster: the Ec and the Es half; 1 on the tensor cores).  On an
# H100 4 parts fit fewer CTAs at once (496 against 528) and lost where the
# card is full, 1 lost the canonical plan's tail
KPARTS_INV_F32 = 2
# the most floats one scratch buffer of the card route holds: the launch
# runs over chunks of windows that fit (the canonical and 50-band buckets
# fit one chunk)
SCRATCH_FLOATS = 2**26
# the kernel's passes, as its error codes number them
_PASSES = {1: "window statistics", 2: "windows", 3: "forward DFT",
           4: "cross-spectra", 5: "inverse DFT", 6: "merge"}

_bound = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def precompute_fused_tables(
    Lg: int,
    pairs: np.ndarray,       # (P, 2) int
    nchans: int,
    max_lag: int | None = None,
    Kt: int = 128,
) -> Dict[str, object]:
    """Host-side tables for `fused_xcorr_bucket` (one bucket, length Lg).

    The DFT tables of `precompute_dft_tables` (nfft = 2*Lg, lags
    [-half, half]) with K zero-padded to a multiple of ``Kt`` and the lags
    to a multiple of 128, as in the JAX package: the extra k columns are
    zero in every table and add nothing, the extra lags lie outside every
    band's [lo, hi].  ``pairs`` must index the ``nchans`` channels.
    """
    from narrow_band_least_squares_tpu_torch.ops.xcorr import precompute_dft_tables

    pairs = np.asarray(pairs)
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.min() < 0 \
            or pairs.max() >= nchans:
        raise ValueError(f"pairs must be (P, 2) indices below {nchans}")
    tab = precompute_dft_tables(Lg, dtype=np.float32, max_lag=max_lag)
    Cf, Sf, Ec, Es = tab["Cf"], tab["Sf"], tab["Ec"], tab["Es"]
    K, nlag = Cf.shape[1], Ec.shape[1]
    Kp, nlagp = _round_up(K, Kt), _round_up(nlag, 128)
    return {
        "Cf": np.pad(Cf, ((0, 0), (0, Kp - K))),
        "Sf": np.pad(Sf, ((0, 0), (0, Kp - K))),
        "Ec": np.pad(Ec, ((0, Kp - K), (0, nlagp - nlag))),
        "Es": np.pad(Es, ((0, Kp - K), (0, nlagp - nlag))),
        "lag_min": tab["lag_min"], "nlag": nlag, "K": K,
    }


def fused_correlation(
    y: torch.Tensor,          # (Bg, C, T) filtered band rows
    hop: torch.Tensor,        # (Bg, 1) int32
    maxstart: torch.Tensor,   # (Bg, 1) int32
    len_mask: torch.Tensor,   # (Bg, Lg)
    Cf: torch.Tensor,         # (Lg, Kp)
    Sf: torch.Tensor,
    Ec: torch.Tensor,         # (Kp, nlagp)
    Es: torch.Tensor,
    pairs: torch.Tensor,      # (P, 2) int
    Wmax: int,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's correlation, step by step in the inputs' dtype,
    the two products at ``precision`` (the tf32 split emulated bit for bit
    in fp32 matmuls, as `xcorr_peak.icorr_peak_reference` does; off
    'highest' the inverse as one product of ``[Re CS | -Im CS]`` with
    ``[Ec ; Es]``, as the tensor-core route takes it).

    Returns ``cc (Bg, Wmax, P, nlagp)`` and ``denom = sqrt(E_i * E_j)
    (Bg, Wmax, P)``.
    """
    XP.check_precision(precision)
    Bg, C, T = y.shape
    Lg = len_mask.shape[1]
    dev = y.device
    w = torch.arange(Wmax, device=dev)
    start = torch.minimum(w[None, :] * hop.long(), maxstart.long())  # (Bg, W)
    t = start[:, :, None] + torch.arange(Lg, device=dev)              # (Bg, W, Lg)
    inside = t < T
    raw = torch.gather(
        y[:, None, :, :].expand(Bg, Wmax, C, T), 3,
        t.clamp(max=T - 1)[:, :, None, :].expand(Bg, Wmax, C, Lg),
    )
    raw = torch.where(inside[:, :, None, :], raw, torch.zeros((), dtype=y.dtype, device=dev))
    lm = len_mask[:, None, None, :]
    raw = raw * lm
    mean = raw.sum(-1, keepdim=True) / len_mask.sum(-1)[:, None, None, None]
    win = (raw - mean) * lm                                            # (Bg, W, C, Lg)
    energy = (win * win).sum(-1)                                       # (Bg, W, C)
    ReF = XP._product(win, Cf, precision)
    ImF = -XP._product(win, Sf, precision)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ReI, ImI, ReJ, ImJ = ReF[:, :, i], ImF[:, :, i], ReF[:, :, j], ImF[:, :, j]
    ReCS = ReJ * ReI + ImJ * ImI
    ImCS = ImJ * ReI - ReJ * ImI
    if precision == "highest":
        with fp32_matmul():
            cc = ReCS @ Ec - ImCS @ Es                                 # (Bg, W, P, nlagp)
    else:
        cc = XP._product(torch.cat([ReCS, -ImCS], dim=-1),
                         torch.cat([Ec, Es], dim=0), precision)
    denom = torch.sqrt(energy[:, :, i] * energy[:, :, j])
    return cc, denom


def fused_xcorr_bucket_reference(
    y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs, Wmax: int,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `fused_correlation` at ``precision``, then the masked
    first maximum over each band's [lo, hi] and ``rho = where(denom > 0,
    peak/denom, 0)``.  Returns ``(rho (Bg, Wmax, P), idx (Bg, Wmax, P)
    int32)``."""
    cc, denom = fused_correlation(y, hop, maxstart, len_mask, Cf, Sf, Ec, Es,
                                  pairs, Wmax, precision)
    col = torch.arange(cc.shape[-1], device=cc.device, dtype=torch.int32)
    valid = (col >= lo[:, :, None, None]) & (col <= hi[:, :, None, None])
    ccm = torch.where(valid, cc, torch.tensor(-torch.inf, dtype=cc.dtype,
                                              device=cc.device))
    peak = ccm.amax(dim=-1)
    first = torch.where(ccm == peak[..., None], col, torch.iinfo(torch.int32).max)
    idx = first.amin(dim=-1)
    idx = torch.where(torch.isneginf(peak), torch.zeros_like(idx), idx)
    rho = torch.where(denom > 0, peak / denom, torch.zeros_like(peak))
    return rho, idx


def _check(y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs, Wmax):
    if y.dim() != 3:
        raise ValueError(f"fused_xcorr_bucket needs y (Bg, C, T); got {tuple(y.shape)}")
    Bg, C, T = y.shape
    for name, t in (("hop", hop), ("maxstart", maxstart), ("lo", lo), ("hi", hi)):
        if tuple(t.shape) != (Bg, 1):
            raise ValueError(f"fused_xcorr_bucket needs {name} of shape ({Bg}, 1); "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"fused_xcorr_bucket needs int32 {name}; got {t.dtype}")
    if len_mask.dim() != 2 or len_mask.shape[0] != Bg:
        raise ValueError(f"fused_xcorr_bucket needs len_mask ({Bg}, Lg); "
                         f"got {tuple(len_mask.shape)}")
    Lg = len_mask.shape[1]
    if Cf.dim() != 2 or Cf.shape[0] != Lg or Sf.shape != Cf.shape:
        raise ValueError(f"fused_xcorr_bucket needs Cf and Sf ({Lg}, Kp); got "
                         f"{tuple(Cf.shape)} and {tuple(Sf.shape)}")
    Kp = Cf.shape[1]
    if Ec.dim() != 2 or Ec.shape[0] != Kp or Es.shape != Ec.shape:
        raise ValueError(f"fused_xcorr_bucket needs Ec and Es ({Kp}, nlag); got "
                         f"{tuple(Ec.shape)} and {tuple(Es.shape)}")
    if pairs.dim() != 2 or pairs.shape[1] != 2 or pairs.shape[0] == 0:
        raise ValueError(f"fused_xcorr_bucket needs pairs (P, 2); got {tuple(pairs.shape)}")
    if pairs.dtype != torch.int32:
        raise TypeError(f"fused_xcorr_bucket needs int32 pairs; got {pairs.dtype}")
    for name, t in (("y", y), ("len_mask", len_mask), ("Cf", Cf), ("Sf", Sf),
                    ("Ec", Ec), ("Es", Es)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_xcorr_bucket needs float32 {name}; got {t.dtype}")
    if int(Wmax) < 1 or min(C, T, Lg, Kp, Ec.shape[1]) < 1:
        raise ValueError(f"fused_xcorr_bucket needs non-empty shapes; got y "
                         f"{tuple(y.shape)}, Lg {Lg}, Kp {Kp}, nlag {Ec.shape[1]}, "
                         f"Wmax {Wmax}")
    devs = {t.device for t in (y, hop, maxstart, lo, hi, len_mask, Cf, Sf,
                               Ec, Es, pairs)}
    if len(devs) != 1:
        raise ValueError(f"fused_xcorr_bucket inputs lie on several devices: {devs}")


def prepare(Cf: torch.Tensor, Sf: torch.Tensor, Ec: torch.Tensor,
            Es: torch.Tensor, precision: str) -> Optional[Dict[str, torch.Tensor]]:
    """What the card route of ``precision`` reads besides the four tables,
    passed to `fused_xcorr_bucket` as ``prepared``.  On the tensor cores
    ('high', 'default') the B operands, transposed K-major and split as
    `xcorr_peak.transpose_split_table` does: ``"fwd"`` = split ``[Cf |
    Sf]ᵀ`` ``(2, 2 Kp, Lgp)`` (``Lg`` zero-padded to a multiple of 32) and
    ``"inv"`` = split ``[Ec ; Es]ᵀ`` ``(2, nlagp, 2 Kp)``, on the tables'
    device.  None on the fp32 route, which reads the tables as they are.
    Constants of a bucket, built once with the pipeline on the card."""
    XP.check_precision(precision)
    if precision == "highest":
        return None
    return {"fwd": XP.transpose_split_table(torch.cat([Cf, Sf], dim=1)),
            "inv": XP.transpose_split_table(torch.cat([Ec, Es], dim=0))}


def k_parts(Lg: int, Kp: int, precision: str,
            inverse_parts: Optional[int] = None) -> Dict[str, list]:
    """The K parts of both products on the card: ``{"forward": [(k0, k1),
    ...] over [0, Lgp), "inverse": [...] over [0, 2 Kp)}``, ascending whole
    K chunks.  Each part is one fmaf chain from 0 and the parts are added in
    order, so an output is fixed by its own row, the tables and this plan,
    which depends on the shapes alone (``inverse_parts``, default
    ``KPARTS_INV_F32`` at 'highest', 1 on the tensor cores, sets how many
    parts the inverse aims at)."""
    XP.check_precision(precision)
    highest = precision == "highest"
    q = K_CHUNK_F32 if highest else K_CHUNK_TC
    if inverse_parts is None:
        inverse_parts = KPARTS_INV_F32 if highest else 1

    def split(K, parts):
        kpart = -(-K // q // parts) * q
        return [(k, min(K, k + kpart)) for k in range(0, K, kpart)]

    return {"forward": split(XP._round_up(Lg, XP.K_BLOCK_TC),
                             KSPLIT_F32 if highest else KSPLIT_TC),
            "inverse": split(2 * Kp, inverse_parts)}


def _lib():
    global _bound
    if _bound is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("fused_xcorr")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbls_fused_xcorr.argtypes = [p] * 22 + [i] * 12 + [p]
        lib.nbls_fused_xcorr.restype = ctypes.c_int
        for fn, want in ((lib.nbls_fused_xcorr_lag_tile, TILE),
                         (lib.nbls_fused_xcorr_k_block, XP.K_BLOCK_TC)):
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"fused_xcorr's {fn.__name__} is {fn()}, the "
                                   f"tables assume {want}")
        lib.nbls_fused_xcorr_ksplit.argtypes = [i]
        lib.nbls_fused_xcorr_ksplit.restype = ctypes.c_int
        lib.nbls_fused_xcorr_k_chunk.argtypes = [i]
        lib.nbls_fused_xcorr_k_chunk.restype = ctypes.c_int
        lib.nbls_fused_xcorr_ring_smem.argtypes = []
        lib.nbls_fused_xcorr_ring_smem.restype = ctypes.c_int
        lib.nbls_fused_xcorr_max_clusters.argtypes = [i, i]
        lib.nbls_fused_xcorr_max_clusters.restype = ctypes.c_int
        for nprod, split, chunk in ((0, KSPLIT_F32, K_CHUNK_F32),
                                    (1, KSPLIT_TC, K_CHUNK_TC),
                                    (3, KSPLIT_TC, K_CHUNK_TC)):
            got = (lib.nbls_fused_xcorr_ksplit(nprod), lib.nbls_fused_xcorr_k_chunk(nprod))
            if got != (split, chunk):
                raise RuntimeError(f"fused_xcorr splits the forward DFT in {got[0]} "
                                   f"parts of {got[1]}-wide chunks at nprod {nprod}, "
                                   f"k_parts assumes {split} of {chunk}")
        _bound = lib
    return _bound


def _check_prepared(prepared, precision, Lg, Kp, nlag, dev):
    want = {"fwd": (2, 2 * Kp, XP._round_up(Lg, XP.K_BLOCK_TC)),
            "inv": (2, nlag, 2 * Kp)}
    for k, shape in want.items():
        t = None if prepared is None else prepared.get(k)
        if (t is None or tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            got = None if t is None else (tuple(t.shape), t.dtype, t.device)
            raise ValueError(f"fused_xcorr_bucket at {precision!r} on the card "
                             f"needs prepared[{k!r}] of shape {shape}, float32 "
                             f"contiguous on {dev} (prepare); got {got}")


def scratch_shapes(C: int, Lg: int, Kp: int, nlag: int, P: int, precision: str,
                   chunk: int) -> Dict[str, tuple]:
    """The card route's scratch shapes for ``chunk`` windows (g, w).  At
    'highest' the windows, spectra and cross-spectra are K-major, ``(Lgp or
    2 Kp, the chunk's rows rounded up to 4)``: the ring tile reads A so, and
    the spectra's K parts meet on chip, so they take one plane."""
    XP.check_precision(precision)
    planes = 2 if precision == "high" else 1
    Lgp = XP._round_up(Lg, XP.K_BLOCK_TC)
    ntiles = nlag // TILE
    out = {"mean": (C * chunk,), "energy": (C * chunk,),
           "part_val": (ntiles, P * chunk), "part_idx": (ntiles, P * chunk)}
    if precision == "highest":
        r4 = lambda rows: XP._round_up(rows * chunk, 4)
        out.update(win=(Lgp, r4(C)), spec=(2 * Kp, r4(C)), cs=(2 * Kp, r4(P)))
    else:
        out.update(win=(planes, C * chunk, Lgp), spec=(KSPLIT_TC, C * chunk, 2 * Kp),
                   cs=(planes, P * chunk, 2 * Kp))
    return out


def plan_chunks(Bg: int, C: int, T: int, Lg: int, W: int, Kp: int, nlag: int,
                P: int, precision: str,
                budget: Optional[int] = None) -> Tuple[int, Dict[str, tuple]]:
    """The card route's windows per chunk and its scratch shapes for one
    chunk (`scratch_shapes`): the most (g, w) windows, at least one, whose
    largest scratch buffer holds at most ``budget`` floats
    (``SCRATCH_FLOATS``).  Raises a ValueError that names the shape where a
    flat offset would need more than 32 bits: the band rows, the rows of
    rho, or one window's scratch."""
    budget = SCRATCH_FLOATS if budget is None else budget
    size = lambda shape: int(np.prod(shape, dtype=np.int64))
    largest = lambda n: max(map(size, scratch_shapes(C, Lg, Kp, nlag, P, precision,
                                                     n).values()))
    # one window's floats per buffer, without the K-major rows' rounding
    per_window = (largest(4) + 3) // 4
    for what, n in (("Bg*C*T", Bg * C * T), ("Bg*Wmax*C", Bg * W * C),
                    ("Bg*Wmax*P", Bg * W * P), ("the scratch of one window", per_window)):
        if n >= 2**31:
            raise ValueError(f"fused_xcorr_bucket: {what} = {n} needs 64-bit offsets "
                             f"(y ({Bg}, {C}, {T}), Wmax {W}, Kp {Kp}, nlag {nlag}, "
                             f"P {P})")
    chunk = max(1, min(Bg * W, budget // per_window))
    while chunk > 1 and largest(chunk) > budget:
        chunk -= 1   # the K-major rows' rounding
    return chunk, scratch_shapes(C, Lg, Kp, nlag, P, precision, chunk)


def fused_xcorr_bucket(
    y: torch.Tensor,          # (Bg, C, T) float32 filtered band rows
    hop: torch.Tensor,        # (Bg, 1) int32 hop per band [samples]
    maxstart: torch.Tensor,   # (Bg, 1) int32 the band's last window start (T - Lb)
    lo: torch.Tensor,         # (Bg, 1) int32 first valid lag index per band
    hi: torch.Tensor,         # (Bg, 1) int32 last valid lag index per band
    len_mask: torch.Tensor,   # (Bg, Lg) float32 valid samples per band
    Cf: torch.Tensor,         # (Lg, Kp) float32 forward cos table
    Sf: torch.Tensor,         # (Lg, Kp) float32 forward sin table
    Ec: torch.Tensor,         # (Kp, nlag) float32 inverse cos table
    Es: torch.Tensor,         # (Kp, nlag) float32 inverse sin table
    pairs: torch.Tensor,      # (P, 2) int32 element pairs (i, j)
    Wmax: int,                # windows per band row
    *,
    precision: str = "highest",
    prepared: Optional[Dict[str, torch.Tensor]] = None,  # prepare(..., precision)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delays of one window-length bucket.  Returns ``(rho (Bg, Wmax, P)
    float32, idx (Bg, Wmax, P) int32)``; ``idx`` indexes the lag columns of
    Ec/Es (``tau = (idx + lag_min) / fs``).

    ``precision`` picks the CUDA route (module docstring); on the CPU the
    products are IEEE fp32 whatever it says.  On the card ``prepared`` must
    be the bucket's ``prepare(Cf, Sf, Ec, Es, precision)``, and Kp and nlag
    multiples of 128, as `precompute_fused_tables` pads them; at 'highest'
    the card skips the rows of Ec and Es past the Lg + 1 frequencies, which
    that padding leaves zero."""
    global launches, launches_tc
    XP.check_precision(precision)
    _check(y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs, Wmax)
    dev = y.device
    if dev.type == "cpu":
        return fused_xcorr_bucket_reference(y, hop, maxstart, lo, hi, len_mask,
                                            Cf, Sf, Ec, Es, pairs, Wmax)
    if dev.type != "cuda":
        raise ValueError(f"fused_xcorr_bucket runs on cuda or cpu tensors, not {dev}")
    args = (y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs)
    names = ("y", "hop", "maxstart", "lo", "hi", "len_mask", "Cf", "Sf", "Ec",
             "Es", "pairs")
    for name, t in zip(names, args):
        if not t.is_contiguous():
            raise ValueError(f"fused_xcorr_bucket needs a contiguous {name}")
    Bg, C, T = y.shape
    Lg, (Kp, nlag), P, W = len_mask.shape[1], Ec.shape, pairs.shape[0], int(Wmax)
    if Kp % TILE or nlag % TILE:
        raise ValueError(f"fused_xcorr_bucket on the card needs Kp and the lag "
                         f"columns padded to multiples of {TILE} "
                         f"(precompute_fused_tables); got Kp {Kp}, nlag {nlag}")
    nprod = 0 if precision == "highest" else XP.TF32_PRODUCTS[precision]
    kpart_inv = k_parts(Lg, Kp, precision)["inverse"][0][1]
    lib = _lib()
    chunk, shapes = plan_chunks(Bg, C, T, Lg, W, Kp, nlag, P, precision)
    for name, t in zip(names, args):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_xcorr_bucket needs a 16-byte aligned {name}")
    fwd_t = inv_t = None
    if nprod:
        _check_prepared(prepared, precision, Lg, Kp, nlag, dev)
        fwd_t, inv_t = prepared["fwd"], prepared["inv"]
    f32 = dict(dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rho = torch.empty((Bg, W, P), **f32)
    idx = torch.empty((Bg, W, P), dtype=torch.int32, device=dev)
    scratch = [torch.empty(shapes[k], **f32)
               for k in ("mean", "energy", "win", "spec", "cs", "part_val")]
    part_idx = torch.empty(shapes["part_idx"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nbls_fused_xcorr(
            *(t.data_ptr() for t in args), ptr(fwd_t), ptr(inv_t),
            rho.data_ptr(), idx.data_ptr(), *(t.data_ptr() for t in scratch),
            part_idx.data_ptr(), Bg, C, T, Lg, W, Kp, nlag, P, nprod, chunk,
            kpart_inv, min(Kp, Lg + 1), stream,
        )
    if err != 0:
        stage, code = divmod(err, 10000)
        raise RuntimeError(
            f"fused_xcorr_bucket ({precision}) kernel launch failed in the "
            f"{_PASSES.get(stage, 'launch')} pass: "
            + {1001: "the driver has no cuTensorMapEncodeTiled",
               1002: "a TMA tensor map was refused"}.get(code, f"CUDA error {code}")
        )
    if nprod:
        launches_tc += 1
    else:
        launches += 1
    return rho, idx
