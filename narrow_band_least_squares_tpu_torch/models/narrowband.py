"""The narrow-band least-squares pipeline on the device.

Port of ``narrow_band_least_squares_tpu/models/narrowband.py``.  The whole
run is dense batched tensor work over the ``(band, window, element-pair)``
grid:

    raw (C, T) --rfft--> filter bank (B, C, T) --unfold--> (Bg, Wg, C, Lg)
      --DFT matmul + icorr_peak--> delays+MdCCM (B, W, P) --2x2 solve-->
      vel/baz/sigma_tau (B, W)

The solve is OLS (``alpha = 1``) or exact-enumeration LTS (``alpha < 1``,
`ops.lts.lts_solve`), which also flags the dropped pairs (B, W, P).

With ``xcorr_method='fused'`` the middle arrow is one ``fused_xcorr_bucket``
launch per bucket, from the band rows straight to (rho, lag index).

Ragged per-band window counts live in masks (the reference's dense-prefix +
``num_compute_list`` contract).  The host builds every constant once, in
float64, and keeps it on the device in float32: the filter bank, the solve
matrices (with LTS its candidate pairs and their inverses), and per
window-length bucket the DFT tables and lag bounds.  They
are the pipeline's state (`state_dict` / `load_state`).
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fnn

from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.models.graphs import CudaGraphs, StepGraphs
from narrow_band_least_squares_tpu_torch.ops import filters as F
from narrow_band_least_squares_tpu_torch.ops import lts as LTS
from narrow_band_least_squares_tpu_torch.ops import solve as SOLVE
from narrow_band_least_squares_tpu_torch.ops import xcorr as XC
from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
from narrow_band_least_squares_tpu_torch.ops.windows import (
    build_bucket_grids,
    build_window_grid,
    extract_windows,
    extract_windows_patches,
    extract_windows_strided,
    extract_windows_strided_rows,
)
from narrow_band_least_squares_tpu_torch.state import state_from_numpy
from narrow_band_least_squares_tpu_torch.utils.device import resolve_device
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray
from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan
from narrow_band_least_squares_tpu_torch.utils.profiling import span
from narrow_band_least_squares_tpu_torch.utils.timeutils import (
    epoch_to_datenum,
    stdict_timestamp_key,
)

logger = logging.getLogger("nbls_torch")

_OUTPUTS = ("vel", "baz", "sig_tau", "vel_uncert", "baz_uncert")

# Steps of `NarrowBandPipeline.run` since the counts were last set to 0:
# captured into CUDA graphs, replayed from them, run eagerly (on the CPU,
# a pipeline's first call on the card, after a fallback), and captures
# that raised, after which their pipeline runs eagerly.  A replay launches
# the step's kernels without advancing the kernels' launch counters
# (`ops.kernels.*.launches*`), which count launches by the host.
graph_captures = 0
graph_replays = 0
eager_steps = 0
graph_fallbacks = 0


@dataclass
class NarrowBandResult:
    """Dense results with the reference's pad-and-mask output contract."""

    vel_array: np.ndarray        # (B, width)
    baz_array: np.ndarray
    mdccm_array: np.ndarray
    t_array: np.ndarray          # matplotlib datenums
    sig_tau_array: np.ndarray
    vel_uncert_array: np.ndarray
    baz_uncert_array: np.ndarray
    num_compute_list: List[int]
    flags: Optional[np.ndarray]  # (B, Wmax, P) bool, LTS only
    pairs: np.ndarray            # (P, 2)
    nchans: int
    plan: NarrowBandPlan
    w_array: Optional[np.ndarray] = None  # (B, F) complex, filter response
    h_array: Optional[np.ndarray] = None

    def stdict(self, band_prefix: bool = True):
        """Materialize the reference's LTS flag dictionary (None for OLS)."""
        if self.flags is None:
            return None
        return flags_to_stdict(
            self.flags, self.t_array, self.num_compute_list, self.pairs,
            self.nchans, band_prefix=band_prefix,
        )


def band_limit_auto_db(bt_min: float) -> float:
    """BT-aware band-limit threshold (band_limit_db='auto').

    Neighbouring correlation lobes differ by ~1/(2BT), so the tolerable cc
    error, and with it the bin-truncation level, scales with the band's
    time-bandwidth product: ``db = 40 + 95*log10(4.6/BT)``, clipped to
    [40, 90] (the JAX package's calibration, kept so both give one result).
    """
    if bt_min >= 4.6:
        return 40.0
    return float(min(90.0, 40.0 + 95.0 * math.log10(4.6 / max(bt_min, 0.05))))


def flags_to_stdict(
    flags: np.ndarray,           # (B, Wmax, P) bool
    t_array: np.ndarray,         # (B, width) datenums
    num_compute_list: Sequence[int],
    pairs: np.ndarray,           # (P, 2) 0-based
    nchans: int,
    band_prefix: bool = True,
) -> Dict[str, object]:
    """Dense flag tensor -> the reference's string-keyed stdict.

    Keys are 7-decimal stringified window datenums, values 1-based element
    numbers (one entry per flagged pair touching the element), one 'size'
    key, and, when band_prefix, keys prefixed "NN_" by 1-based band number.
    """
    out: Dict[str, object] = {}
    B = flags.shape[0]
    for b in range(B):
        for w in range(int(num_compute_list[b])):
            flagged = np.where(flags[b, w])[0]
            elements: List[int] = []
            for p in flagged:
                i, j = pairs[p]
                elements.extend([int(i) + 1, int(j) + 1])
            key = stdict_timestamp_key(t_array[b, w])
            if band_prefix:
                key = str(b + 1).zfill(2) + "_" + key
            out[key] = np.asarray(elements, dtype=np.int64)
    out["size"] = int(nchans)
    return out


# dtypes narrower than float32 that the JAX package runs in places
# (check_dtype); every other computation of the port is float32
LOW_DTYPES = (torch.bfloat16, torch.float16)


def check_dtype(dtype, apply_filter: bool, xcorr_method: str) -> torch.dtype:
    """The dtype a pipeline computes in, by what the JAX package does with
    ``dtype``: float32 runs; float64 warns and computes float32 (the JAX
    package never enables x64, so it truncates to float32); bfloat16 and
    float16 run only with ``apply_filter=False`` and 'mxu' or 'pallas'
    and raise ``ValueError`` elsewhere, naming the JAX package's failure."""
    if dtype == torch.float32:
        return dtype
    if dtype == torch.float64:
        logger.warning(
            "dtype=torch.float64 computes float32: the JAX package does not "
            "enable x64 and truncates float64 to float32")
        return torch.float32
    if dtype not in LOW_DTYPES:
        raise ValueError(f"unsupported dtype {dtype}; expected torch.float32, "
                         f"float64, bfloat16 or float16")
    if apply_filter:
        raise ValueError(
            f"dtype={dtype} with apply_filter=True: the JAX package's filter "
            "bank fails here (RFFT input must be float32 or float64); filter "
            "in float32, or pass apply_filter=False with pre-filtered data")
    if xcorr_method == "fused":
        raise ValueError(
            f"dtype={dtype} with xcorr_method='fused': the JAX package's fused "
            "kernel fails here (Invalid dtype for swap); use 'mxu' or 'pallas'")
    if xcorr_method == "fft":
        raise ValueError(
            f"dtype={dtype} with xcorr_method='fft': the JAX package fails here "
            "(RFFT input must be float32 or float64); use 'mxu' or 'pallas'")
    return dtype


class NarrowBandPipeline:
    """Narrow-band least-squares pipeline (OLS or LTS) on one device.

    The constructor designs the filter bank, window grids and DFT tables on
    the host and moves them to ``device``; `run` / `run_raw` execute the step
    there.  The arguments are the JAX pipeline's.  In this port:

    - ``alpha < 1`` runs exact-enumeration LTS on the same device, with
      ``c_steps``, ``max_lts_candidates``, ``lts_candidate_chunk`` (set to
      4096 when there are more candidates) and ``lts_funnel_k`` (``'auto'``:
      ``max(16, ceil(Q/24))`` for Q candidates) as in the JAX package; at
      one band (float32, four C-steps, integer lags) the sweep takes the
      lags of the delays where the JAX package's one-band program contracts
      the delays' product into a residual (`_delay_sites`,
      `ops.lts.delay_contracted`);
    - ``subsample_delays=True`` with 'mxu' refines every integer-lag peak
      with the three-point parabola through its two neighbouring
      correlations, which the lag-search kernel returns beside the peak
      (`ops.xcorr.subsample_frac`); with 'pallas' and 'fused' the JAX
      package ignores it with a warning and 'fft' ignores it silently, and
      so does the port;
    - ``window_method='patches'`` (`ops.windows.extract_windows_patches`)
      turns bucketing off, as in the JAX package;
    - ``dtype`` (`check_dtype`): float64 warns and computes float32;
      bfloat16 and float16 need ``apply_filter=False`` and 'mxu' or
      'pallas'.  The step then holds the samples, windows, their
      energies, the DFT tables, the delays and the solve in that dtype, as
      the JAX step does; the spectra and the lag search run in float32 on
      the rounded windows and tables, and MdCCM is float32;
    - ``xcorr_method='fft'`` (`ops.xcorr.cross_correlate`, unbucketed, at
      ``nfft_corr = next_pow2(2 Lmax)``) with ``max_lag_s`` raises
      ``ValueError``: the JAX package fails there (its capped lag mask does
      not broadcast against the FFT's full lag axis);
    - ``xcorr_method`` 'mxu' and 'pallas' both search lags with the
      ``icorr_peak`` kernel, on the bucket's dense tables or its stacked
      ones; 'fused' runs each bucket in one ``fused_xcorr_bucket`` launch
      and always buckets the bands;
    - ``matmul_precision`` sets the lag search (`icorr_peak`) and both
      products of ``fused_xcorr_bucket`` on the card: 'highest' is IEEE
      fp32 on the CUDA cores, 'high' (the default; bf16x3 on the TPU) is
      3xTF32 and 'default' (one bf16 pass) is 1xTF32 on the tensor cores.
      On the CPU every precision computes IEEE fp32, as the JAX package
      does there.  The forward-DFT matmuls of 'mxu' and 'pallas' are IEEE
      fp32 at every precision;
    - ``xcorr_chunk_mb`` and ``xcorr_lag_tile`` are accepted and change
      nothing: they bound the (B, W, P, nlag) correlation on the TPU, and
      the kernel never forms it.

    ``device=None`` means ``"cuda"``; without CUDA that raises.  Pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    """

    def __init__(
        self,
        plan: NarrowBandPlan,
        rij: np.ndarray,
        filter_type: str = "cheby1",
        filter_order: int = 2,
        filter_ripple: float = 0.01,
        alpha: float = 1.0,
        apply_filter: bool = True,
        dtype=torch.float32,
        c_steps: int = 4,
        taper_percentage: float = 0.01,
        max_lts_candidates: int = 0,
        xcorr_method: str = "mxu",
        window_method: str = "strided",
        max_lag_s: float = None,
        matmul_precision: str = "high",
        lts_candidate_chunk: int = 0,
        lts_funnel_k: int = 0,
        subsample_delays: bool = False,
        bucket_bands: bool = True,
        bucket_ratio: float = 1.3,
        bucket_slack: float = 1.08,
        xcorr_chunk_mb: float = 16.0,
        xcorr_lag_tile: int = 512,
        band_limit_db: float = 0.0,
        *,
        device=None,
    ):
        if xcorr_method not in ("mxu", "pallas", "fused", "fft"):
            raise ValueError(f"unknown xcorr_method {xcorr_method!r}")
        if xcorr_method == "fft" and max_lag_s is not None:
            raise ValueError(
                "xcorr_method='fft' with max_lag_s: the JAX package fails here "
                "(its capped lag mask does not broadcast against the FFT's "
                "2*Lmax-1 lags); use xcorr_method='mxu' to cap the lags")
        if subsample_delays and xcorr_method in ("pallas", "fused"):
            logger.warning(
                "subsample_delays is ignored with xcorr_method=%r (the kernel "
                "returns integer-lag peaks); use xcorr_method='mxu' for "
                "parabolic sub-sample refinement", xcorr_method,
            )
        if window_method not in ("strided", "gather", "patches"):
            raise ValueError(f"unknown window_method {window_method!r}")
        dtype = check_dtype(dtype, apply_filter, xcorr_method)
        XP.check_precision(matmul_precision)
        del bucket_ratio, xcorr_chunk_mb, xcorr_lag_tile

        self.device = resolve_device(device)
        self.plan = plan
        self.rij = np.asarray(rij, dtype=np.float64)
        self.alpha = float(alpha)
        self.c_steps = int(c_steps)
        self.max_lts_candidates = int(max_lts_candidates)
        self.lts_candidate_chunk = int(lts_candidate_chunk)
        self.lts_funnel_k = "auto" if lts_funnel_k == "auto" else int(lts_funnel_k)
        self.apply_filter = apply_filter
        self.filter_type = filter_type
        self.filter_order = filter_order
        self.filter_ripple = filter_ripple
        self.dtype = dtype
        self.subsample_delays = bool(subsample_delays) and xcorr_method == "mxu"
        self.xcorr_method = xcorr_method
        self.window_method = window_method
        self.max_lag_s = max_lag_s
        self.matmul_precision = matmul_precision
        self.nchans = self.rij.shape[1]
        self.band_limit_db = (
            "auto" if band_limit_db == "auto" else float(band_limit_db)
        )
        st: Dict[str, np.ndarray] = {}   # host constants, see state_dict()

        # ---- geometry / solver constants ----
        X, pairs = coarray(self.rij)
        self.X64 = X
        self.pairs_np = pairs
        st.update(self._host_solve_constants(X))
        self.XtX_inv64 = st["XtX_inv"]
        if self.alpha < 1.0:
            self.h = LTS.lts_h(self.alpha, X.shape[0])
            Q = len(st["cand"])
            if self.lts_funnel_k == "auto":
                self.lts_funnel_k = max(16, -(-Q // 24))
            # bound the (B, W, Q, P) sweep by chunking the candidates
            # (identical results without the funnel), never by dropping them
            if not self.lts_candidate_chunk and Q > 4096:
                self.lts_candidate_chunk = 4096
        elif self.lts_funnel_k == "auto":
            self.lts_funnel_k = 0      # OLS: no LTS sweep to funnel
        # the sweep's sites whose residuals the JAX package's program takes
        # from the unrounded delays: its one-band programs fuse the delays'
        # product into the sweep (ops.lts, module docstring); read for four
        # C-steps in float32, without sub-sample delays
        self._delay_sites = frozenset()
        if (self.alpha < 1.0 and plan.nbands == 1 and dtype == torch.float32
                and self.c_steps == 4 and not self.subsample_delays):
            self._delay_sites = LTS.delay_contracted(X.shape[0], LTS.lts_schedule(
                Q, self.lts_candidate_chunk, self.lts_funnel_k, self.c_steps))

        # ---- filter bank ----
        self.zerophase = filter_type == "butter"
        self.sos_list = None
        if apply_filter:
            edges = [plan.edges(b) for b in range(plan.nbands)]
            h_bank, self.sos_list, L = F.build_filter_bank(
                edges, filter_type, filter_order, filter_ripple,
                plan.fs, plan.npts,
            )
            st["h_bank"] = h_bank
            self.nfft_filter = F.next_pow2(plan.npts + L)
            for b, bt in enumerate(plan.bt_products()):
                if bt < 5.0:
                    lo, hi = plan.edges(b)
                    logger.warning(
                        "CAUTION: BT < 5! Band between %s Hz and %s Hz has BT = %s",
                        lo, hi, bt,
                    )
        st["taper"] = F.taper_window(plan.npts, taper_percentage)

        # ---- window grid ----
        grid = build_window_grid(plan)
        self.grid = grid
        st["win_mask"] = grid.win_mask
        max_lag = None
        if max_lag_s is not None:
            max_lag = min(int(max_lag_s * plan.fs), grid.Lmax - 1)
        if self.band_limit_db and (xcorr_method != "mxu" or self.sos_list is None):
            logger.warning(
                "band_limit_db needs xcorr_method='mxu' and an in-pipeline "
                "filter bank (apply_filter=True); ignoring"
            )
            self.band_limit_db = 0.0

        def tables(Lmax, lengths, band_idx):
            bml = min(max_lag, Lmax - 1) if max_lag is not None else None
            if xcorr_method == "fft":
                return {}, -(Lmax - 1)
            if xcorr_method == "pallas":
                tab = XC.precompute_pallas_tables(
                    Lmax, lengths, dtype=np.float32, max_lag=bml,
                )
                return {k: tab[k] for k in ("Cf", "Sf", "e2", "lo", "hi")}, \
                    tab["lag_min"]
            tab = XC.precompute_dft_tables(Lmax, dtype=np.float32, max_lag=bml)
            if self.band_limit_db:
                if self.band_limit_db == "auto":
                    bts = plan.bt_products()
                    db = band_limit_auto_db(min(bts[int(b)] for b in band_idx))
                else:
                    db = float(self.band_limit_db)
                kmin, kmax = XC.band_limit_bins(
                    self.sos_list, band_idx, tab["nfft"], plan.fs, db,
                    zerophase=self.zerophase,
                )
                tab = XC.slice_tables_bins(tab, kmin, kmax)
            return {k: tab[k] for k in ("Cf", "Sf", "Ec", "Es")}, tab["lag_min"]

        def fused_tables(g):
            # the JAX package's _fused_buckets: each band's windows start at
            # w*hop clamped to its own T - Lb, never the bucket's T - Lg
            bml = min(max_lag, g.Lmax - 1) if max_lag is not None else None
            tab = FX.precompute_fused_tables(g.Lmax, pairs, self.nchans, max_lag=bml)
            half = g.Lmax - 1 if bml is None else bml
            lengths = g.lengths.astype(np.int64)
            bh = np.minimum(lengths - 1, half)
            col = lambda v: np.asarray(v, dtype=np.int32)[:, None]
            out = {k: tab[k] for k in ("Cf", "Sf", "Ec", "Es")}
            out["hop"] = col([plan.windows[int(b)].hop for b in g.band_idx])
            out["maxstart"] = col(plan.npts - lengths)
            out["lo"], out["hi"] = col(half - bh), col(half + bh)
            out["len_mask"] = g.len_mask.reshape(len(g.band_idx), g.Lmax)
            return out, tab["lag_min"]

        # the fused kernel works per bucket, so 'fused' always buckets;
        # 'fft' and 'patches' never do (as in the JAX package)
        self.nfft_corr = F.next_pow2(2 * grid.Lmax)
        self.bucket_bands = ((bool(bucket_bands) and xcorr_method in ("mxu", "pallas")
                              and window_method != "patches")
                             or xcorr_method == "fused")
        self._buckets: List[dict] = []
        if self.bucket_bands:
            bgrids = build_bucket_grids(plan, max_lag=max_lag, slack=bucket_slack)
            for i, g in enumerate(bgrids):
                pre = f"bucket{i}."
                if xcorr_method == "fused":
                    tab, lag_min = fused_tables(g)
                else:
                    tab, lag_min = tables(g.Lmax, g.lengths, g.band_idx)
                    tab["len_mask"] = g.len_mask
                    tab["lengths"] = g.lengths.astype(np.float64)
                    if xcorr_method == "mxu":
                        tab["lag_mask"] = g.lag_mask
                    if window_method == "gather":
                        tab["idx"] = g.idx
                for k, v in tab.items():
                    st[pre + k] = v
                self._buckets.append({"grid": g, "prefix": pre,
                                      "lag_min": lag_min})
            order = np.concatenate([g.band_idx for g in bgrids])
            st["bucket_inv_perm"] = np.argsort(order).astype(np.int32)
        else:
            tab, self._lag_min = tables(grid.Lmax, grid.lengths,
                                        range(plan.nbands))
            for k, v in tab.items():
                st["tables." + k] = v
            st["tables.len_mask"] = grid.len_mask
            st["tables.lengths"] = grid.lengths.astype(np.float64)
            if xcorr_method in ("mxu", "fft"):
                lag_mask = grid.lag_mask
                if max_lag is not None:
                    c = grid.Lmax - 1
                    lag_mask = lag_mask[:, c - max_lag: c + max_lag + 1]
                st["tables.lag_mask"] = lag_mask
            if window_method == "gather":
                st["tables.idx"] = grid.idx

        # ---- window timestamps (host) ----
        self._t_epoch_rel = np.zeros((plan.nbands, plan.width))
        for b, wp in enumerate(plan.windows):
            self._t_epoch_rel[b, : wp.n_windows] = wp.end_times_epoch(0.0, plan.fs)

        self._pairs = torch.as_tensor(pairs, dtype=torch.int64, device=self.device)
        self._pairs32 = self._pairs.to(torch.int32)
        # `run`'s CUDA graphs (`_run_step`): on the card only
        self._graph_backend = CudaGraphs(self.device) if self.device.type == "cuda" else None
        self._runs, self._x_static, self._graphs_failed = 0, None, False
        # one `run` at a time: a replay's outputs are the graphs' own tensors
        self._run_lock = threading.Lock()
        self.load_state(state_from_numpy(st))

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The pipeline's host-built constants, by name (tensors on its device).

        ``h_bank``, ``taper``, ``X``, ``pinv``, ``XtX_inv``, ``win_mask``;
        with ``alpha < 1`` the LTS candidates ``cand`` (Q, 2) int32, their
        2x2 inverses ``Ainv`` (Q, 2, 2) and ``cand_ok`` (Q,) bool; with
        bucketing, per bucket ``bucket{i}.`` + ``Cf``/``Sf`` and ``Ec``/``Es``
        ('mxu') or ``e2``/``lo``/``hi`` ('pallas'), ``len_mask``, ``lengths``,
        ``lag_mask`` ('mxu'), ``idx`` ('gather'), and ``bucket_inv_perm``;
        without bucketing the same names under ``tables.``.  With 'fused',
        per bucket ``Cf``/``Sf``/``Ec``/``Es`` (padded, `precompute_fused_tables`),
        and per band of the bucket, as ``(Bg, 1)`` int32 columns, ``hop``,
        ``maxstart`` (the band's last window start, ``T - Lb``) and the lag
        bounds ``lo``/``hi``, with ``len_mask`` ``(Bg, Lg)``.
        """
        return dict(self._state)

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Replace the constants with ``state`` (same names and shapes as
        `state_dict`), moved to this pipeline's device."""
        if hasattr(self, "_state"):
            missing = set(self._state) - set(state)
            if missing:
                raise KeyError(f"state lacks {sorted(missing)}")
            for k, v in state.items():
                if k in self._state and tuple(v.shape) != tuple(self._state[k].shape):
                    raise ValueError(
                        f"state[{k!r}] has shape {tuple(v.shape)}, "
                        f"expected {tuple(self._state[k].shape)}"
                    )
        self._state = {k: v.to(self.device) for k, v in state.items()}
        self._geometry = self._solve_constants(self._state)
        self._graphs = None     # they read the old state's tensors
        # the device constants a step reads besides the state, built here:
        # a captured step may not copy from the host
        self._fused_rows = {}   # per (bucket, arrays), see _fused_inputs
        self._band_rows = {}    # per bucket prefix, its bands ('gather')
        if self.xcorr_method == "fused":
            for i in range(len(self._buckets)):
                self._fused_inputs(i, 1)
        elif self.window_method == "gather":
            self._band_rows = {
                bk["prefix"]: torch.as_tensor(bk["grid"].band_idx, dtype=torch.int64,
                                              device=self.device)
                for bk in self._buckets}
        # per table prefix, the lag search's tables: Cf/Sf and the
        # inverse-DFT operand e2 of icorr_peak (derived from Ec/Es with
        # 'mxu'), rounded to a narrow dtype's values where the JAX step
        # holds them in it; on the card only, what the kernel of the
        # precision's route reads (its module's `prepare`)
        self._xtab, self._prepared = {}, {}
        card = self.device.type == "cuda"
        prec = self.matmul_precision
        if self.xcorr_method == "fused":
            for pre in ([b["prefix"] for b in self._buckets] if card else []):
                self._prepared[pre] = FX.prepare(
                    *(self._state[pre + k] for k in ("Cf", "Sf", "Ec", "Es")), prec)
            return
        if self.xcorr_method == "fft":
            return
        narrow = self.dtype in LOW_DTYPES
        rnd = (lambda t: t.to(self.dtype).to(t.dtype)) if narrow else (lambda t: t)
        for pre in ([b["prefix"] for b in self._buckets]
                    if self.bucket_bands else ["tables."]):
            s = self._state
            e2 = (s[pre + "e2"] if self.xcorr_method == "pallas" else
                  XC.stack_inverse_table(s[pre + "Ec"], s[pre + "Es"]))
            tab = {"Cf": rnd(s[pre + "Cf"]), "Sf": rnd(s[pre + "Sf"]), "e2": rnd(e2)}
            if self.xcorr_method == "pallas":
                tab.update(lo=s[pre + "lo"], hi=s[pre + "hi"])
            self._xtab[pre] = tab
            if card:
                self._prepared[pre] = XP.prepare(tab["e2"], prec)

    # ------------------------------------------------------------------
    def _xcorr(self, win: torch.Tensor, pre: str, lag_min: int):
        s = self._state
        prec = self.matmul_precision
        if self.xcorr_method == "fft":
            return XC.cross_correlate(win, self._pairs, s[pre + "lag_mask"],
                                      self.nfft_corr, self.plan.fs)
        tab = dict(self._xtab[pre], lag_min=lag_min,
                   prepared=self._prepared.get(pre))
        if self.xcorr_method == "pallas":
            return XC.cross_correlate_pallas(win, self._pairs, tab, self.plan.fs,
                                             precision=prec)
        return XC.cross_correlate_mxu(win, self._pairs, s[pre + "lag_mask"],
                                      tab, self.plan.fs, precision=prec,
                                      subsample=self.subsample_delays)

    def _extract(self, y: torch.Tensor, bk: Optional[dict] = None):
        """Windows of one array's filtered bank (B, C, T): over the global
        grid, or over bucket ``bk``'s compact (Bg, Wg, C, Lg) grid."""
        with span("nbls.windows"):
            s, pre = self._state, "tables." if bk is None else bk["prefix"]
            if self.window_method == "patches":      # never bucketed
                return extract_windows_patches(y, self.plan, s[pre + "len_mask"],
                                               s[pre + "lengths"])
            if self.window_method == "strided":
                if bk is None:
                    return extract_windows_strided(y, self.plan, s[pre + "len_mask"],
                                                   s[pre + "lengths"])
                g = bk["grid"]
                return extract_windows_strided_rows(
                    y, g.band_idx, [self.plan.windows[int(b)].hop for b in g.band_idx],
                    g.Wmax, g.Lmax, s[pre + "len_mask"], s[pre + "lengths"],
                )
            if bk is not None:
                y = y[self._band_rows[bk["prefix"]]]
            return extract_windows(y, s[pre + "idx"], s[pre + "len_mask"],
                                   s[pre + "lengths"])

    def _delays(self, y: torch.Tensor):
        """Filtered bank (B, C, T) -> (tau, rho, mdccm) over the window grid."""
        return tuple(v[0] for v in self._delays_merged(y[None]))

    def _delays_batched(self, y: torch.Tensor):
        """Filtered banks of A arrays (A, B, C, T) -> (tau, rho, mdccm) of
        shape (A, B, Wmax, P) / (A, B, Wmax), the arrays merged into one
        batch: the window axis for 'mxu' and 'pallas', the band rows of each
        fused launch for 'fused'.  Each array's result is the single-array
        one (bit for bit with 'fused')."""
        if self.xcorr_method == "pallas" and self.bucket_bands:
            raise ValueError(
                "multi-array delays with xcorr_method='pallas' need "
                "bucket_bands=False: the JAX package merges bucketed arrays "
                "through its 'mxu' correlator, which needs the Ec/Es tables "
                "that 'pallas' buckets do not carry (it fails there with "
                "KeyError: 'Ec')"
            )
        return self._delays_merged(y)

    def _delays_merged(self, y: torch.Tensor):
        A = y.shape[0]
        if self.xcorr_method == "fused":
            return self._xcorr_fused(y.reshape((-1,) + tuple(y.shape[2:])), arrays=A)
        Wmax = self.plan.max_windows

        def merged(bk):
            # A x (Bg, Wg, C, Lg) -> (Bg, A*Wg, C, Lg): window a*Wg + w
            wins = [self._extract(y[a], bk) for a in range(A)]
            return wins[0] if A == 1 else torch.cat(wins, dim=1)

        def split(t):
            # (Bg, A*Wg, ...) -> (A, Bg, Wmax, ...), zero-padded windows
            Bg, Wg = t.shape[0], t.shape[1] // A
            t = t.reshape((Bg, A, Wg) + tuple(t.shape[2:])).transpose(0, 1)
            pad = Wmax - Wg
            return Fnn.pad(t, (0, 0) * (t.dim() - 3) + (0, pad)) if pad else t

        if not self.bucket_bands:
            return tuple(split(v) for v in self._xcorr(merged(None), "tables.",
                                                       self._lag_min))
        outs = [[split(v) for v in self._xcorr(merged(bk), bk["prefix"],
                                               bk["lag_min"])]
                for bk in self._buckets]
        return self._bucket_order(outs)

    def _bucket_order(self, outs):
        """Per-bucket (tau, rho, mdccm), each (A, Bg, Wmax, ...), -> the full
        (A, B, Wmax, ...) grid in band order."""
        inv = self._state["bucket_inv_perm"].long()
        return tuple(torch.cat(v, dim=1)[:, inv] for v in zip(*outs))

    def _fused_inputs(self, i: int, arrays: int):
        """Bucket i's band rows in the (A*B, C, T) stack and its per-band
        columns tiled over the A arrays (cached until `load_state`)."""
        key = (i, arrays)
        if key not in self._fused_rows:
            bk, s, B = self._buckets[i], self._state, self.plan.nbands
            pre, band_idx = bk["prefix"], bk["grid"].band_idx
            rows = np.concatenate([a * B + band_idx for a in range(arrays)])
            self._fused_rows[key] = (
                torch.as_tensor(rows, dtype=torch.int64, device=self.device),
                *(s[pre + k].repeat(arrays, 1).contiguous()
                  for k in ("hop", "maxstart", "lo", "hi", "len_mask")),
            )
        return self._fused_rows[key]

    def _xcorr_fused(self, y: torch.Tensor, arrays: int = 1):
        """Fused delays: (A*B, C, T) band rows of A arrays -> (tau, rho,
        mdccm) of shape (A, B, Wmax, P) / (A, B, Wmax).

        One `fused_xcorr_bucket` launch per window-length bucket, at the
        pipeline's ``matmul_precision``, covers the bucket's bands of every
        array (rows a*B + band)."""
        plan, s, A = self.plan, self._state, arrays
        outs = []
        for i, bk in enumerate(self._buckets):
            pre, g = bk["prefix"], bk["grid"]
            rows, hop, maxstart, lo, hi, len_mask = self._fused_inputs(i, A)
            yb = y[rows]
            with span("nbls.lag_search"):
                rho, idx = FX.fused_xcorr_bucket(
                    yb, hop, maxstart, lo, hi, len_mask,
                    s[pre + "Cf"], s[pre + "Sf"], s[pre + "Ec"], s[pre + "Es"],
                    self._pairs32, g.Wmax, precision=self.matmul_precision,
                    prepared=self._prepared.get(pre),
                )
            tau = XC.lag_seconds(idx.to(y.dtype) + bk["lag_min"], plan.fs)
            md = XC.median_last(rho)
            pad = plan.max_windows - g.Wmax
            if pad:
                tau = Fnn.pad(tau, (0, 0, 0, pad))
                rho = Fnn.pad(rho, (0, 0, 0, pad))
                md = Fnn.pad(md, (0, pad))
            outs.append([v.reshape((A, -1) + tuple(v.shape[1:]))
                         for v in (tau, rho, md)])
        return self._bucket_order(outs)

    def _host_solve_constants(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        """One co-array's solve constants on the host, by state name: X,
        pinv, XtX_inv and, with LTS, its candidates under this pipeline's
        ``max_lts_candidates`` (cand, Ainv, cand_ok)."""
        lsq = SOLVE.precompute_lstsq(X)
        out = {k: lsq[k] for k in ("X", "pinv", "XtX_inv")}
        if self.alpha < 1.0:
            ci = LTS.precompute_candidates(X, max_candidates=self.max_lts_candidates)
            out.update(cand=ci["cand"], Ainv=ci["Ainv"], cand_ok=ci["ok"])
        return out

    def _solve_constants(self, s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One array's solve constants from state-named tensors ``s``:
        X, pinv, XtX_inv and, with LTS, cand (int64 for indexing), Ainv,
        cand_ok; the floats in the pipeline's dtype."""
        g = {k: s[k].to(self.dtype) for k in ("X", "pinv", "XtX_inv")}
        if self.alpha < 1.0:
            g.update(cand=s["cand"].long(), Ainv=s["Ainv"].to(self.dtype),
                     cand_ok=s["cand_ok"])
        return g

    def _solve_masked(self, tau, mdccm, geometry=None, win_mask=None, fused=True):
        """Slowness solve + window-validity masking; ``geometry`` is an
        array's `_solve_constants` and ``win_mask`` (B, Wmax) its valid
        windows, the pipeline's own by default.  ``fused``: tau comes
        straight from the delay stage, so the JAX program fuses its product
        into the sweep at `_delay_sites` (False: the merged multi-array
        program's delays of several merge chunks, concatenated first).
        With LTS the result also holds ``flags`` (B, Wmax, P): the dropped
        pairs of valid windows."""
        with span("nbls.solve"):
            g = geometry or self._geometry
            if self.alpha < 1.0:
                sites, lag = self._delay_sites if fused else frozenset(), None
                if sites:
                    # integer lags: tau = lag * (1/fs) rounded, so this is exact
                    lag = torch.round(tau.double() * self.plan.fs).to(tau.dtype)
                out = LTS.lts_solve(
                    tau, g["X"], g["cand"], g["Ainv"], g["cand_ok"], self.h,
                    self.c_steps, candidate_chunk=self.lts_candidate_chunk,
                    funnel_k=self.lts_funnel_k, lag=lag, inv_fs=1.0 / self.plan.fs,
                    delay_sites=sites,
                )
            else:
                out = SOLVE.ols_solve(tau, g["X"], g["pinv"], g["XtX_inv"])
            wm = self._state["win_mask"] if win_mask is None else win_mask
            zero = torch.zeros((), dtype=tau.dtype, device=tau.device)
            res = {k: torch.where(wm, out[k], zero) for k in _OUTPUTS}
            res["mdccm"] = torch.where(wm, mdccm, zero)
            if self.alpha < 1.0:
                res["flags"] = ~out["retained"] & wm[..., None]
            return res

    def _filter(self, x: torch.Tensor, nfft: Optional[int] = None,
                halo: int = 0) -> torch.Tensor:
        """Raw rows (C, T) -> the filtered bank (B, C, T - halo).

        ``nfft`` (default ``nfft_filter``) is the FFT length of the filter
        bank; the first ``halo`` samples, which only warm the filter, are
        dropped, and only then is the pipeline's taper applied.  Any dtype
        of ``x`` is cast to the pipeline's on its device first."""
        s = self._state
        with span("nbls.filter"):
            x = x.to(self.dtype)
            if self.apply_filter:
                y = F.filter_bank_fft(x, s["h_bank"], None, nfft or self.nfft_filter,
                                      self.zerophase)
                return y[..., halo:] * s["taper"]
            # ltsva contract: the caller already filtered and tapered the data
            return x[None].expand((self.plan.nbands,) + tuple(x.shape))

    def _step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        tau, rho, mdccm = self._delays(self._filter(x))
        return self._solve_masked(tau, mdccm)

    def _to_device(self, data: np.ndarray) -> torch.Tensor:
        # cast on the host, as the JAX pipeline does, then copy
        with span("nbls.h2d"):
            return torch.as_tensor(np.asarray(data, dtype=np.float32)).to(self.device)

    def _to_static(self, data: np.ndarray) -> torch.Tensor:
        """`_to_device` into the one input buffer that `run`'s graphs read."""
        with span("nbls.h2d"):
            host = torch.as_tensor(np.asarray(data, dtype=np.float32))
            if self._x_static is None:
                self._x_static = torch.empty(host.shape, dtype=host.dtype,
                                             device=self.device)
            return self._x_static.copy_(host)

    def _run_step(self, data: np.ndarray) -> Dict[str, torch.Tensor]:
        """`run`'s step.  Eager on the CPU and on a pipeline's first call on
        the card, which loads the kernels and builds cuFFT's and cuBLAS's
        plans.  The second call captures the step into CUDA graphs
        (`models.graphs.StepGraphs`, on `_to_static`'s buffer) and replays
        them; later calls replay, until `load_state` drops the graphs.  A
        capture that raises logs a warning, and the pipeline runs eagerly
        from then on.  The outputs of a replay are the graphs' own tensors,
        which the next replay overwrites."""
        global eager_steps, graph_captures, graph_replays, graph_fallbacks
        self._runs += 1
        shape = tuple(np.shape(data))
        if (self._graph_backend is None or self._runs == 1 or self._graphs_failed
                or (self._x_static is not None and shape != tuple(self._x_static.shape))):
            eager_steps += 1
            return self._step(self._to_device(data))
        x = self._to_static(data)
        if self._graphs is None:
            try:
                with span("nbls.graph.capture"):
                    self._graphs = StepGraphs(self._graph_backend, self._step, x)
            except Exception as e:   # whatever the capture met: run eagerly instead
                self._graphs_failed = True
                graph_fallbacks += 1
                logger.warning("capturing the step into CUDA graphs failed (%s: %s); "
                               "this pipeline runs its steps eagerly",
                               type(e).__name__, e)
                eager_steps += 1
                return self._step(x)
            graph_captures += 1
        with span("nbls.graph.replay"):
            self._graphs.replay()
        graph_replays += 1
        return self._graphs.outputs

    # ------------------------------------------------------------------
    def run(self, st: ArrayStream, freq_resp_list: Optional[np.ndarray] = None
            ) -> NarrowBandResult:
        """Execute on one ArrayStream (shape-checked against the plan).  On
        the card the step is replayed from CUDA graphs from the second call
        on (`_run_step`)."""
        if st.npts != self.plan.npts:
            raise ValueError(
                f"stream has {st.npts} samples but plan was built for {self.plan.npts}"
            )
        with self._run_lock:
            with span("nbls.step"):
                dev = self._run_step(st.data)
            return self._package(dev, st.start_epoch, freq_resp_list)

    def run_raw(self, data: np.ndarray) -> Dict[str, torch.Tensor]:
        """Raw device outputs for one (C, T) array (benchmark path), from an
        eager step: the tensors are the caller's to keep."""
        with span("nbls.step"):
            return self._step(self._to_device(data))

    def run_batch_raw(self, data: np.ndarray) -> Dict[str, torch.Tensor]:
        """Raw device outputs for a batch (A, C, T) of arrays, stacked on a
        leading axis (eager steps)."""
        x = self._to_device(data)
        outs = [self._step(x[a]) for a in range(x.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    # ------------------------------------------------------------------
    def _package(
        self, dev: Dict[str, torch.Tensor], start_epoch: float,
        freq_resp_list: Optional[np.ndarray],
    ) -> NarrowBandResult:
        with span("nbls.package"):
            plan = self.plan
            B, width, Wmax = plan.nbands, plan.width, plan.max_windows
            t_array = epoch_to_datenum(
                np.where(self._t_epoch_rel > 0, self._t_epoch_rel + start_epoch, 0.0)
            )
            w_array = h_array = None
            if self.sos_list is not None and freq_resp_list is not None:
                with span("nbls.freqz"):
                    w_array, h_array = F.sosfreqz_bank(
                        self.sos_list, np.asarray(freq_resp_list), plan.fs
                    )
            # the host work above overlaps the step's tail on the device;
            # the copies wait for it
            dense = {}
            with span("nbls.d2h"):
                for name in _OUTPUTS + ("mdccm",):
                    dense[name] = np.zeros((B, width))
                    dense[name][:, :Wmax] = dev[name].detach().cpu().double().numpy()
                flags = dev["flags"].cpu().numpy() if "flags" in dev else None
            return NarrowBandResult(
                vel_array=dense["vel"],
                baz_array=dense["baz"],
                mdccm_array=dense["mdccm"],
                t_array=t_array,
                sig_tau_array=dense["sig_tau"],
                vel_uncert_array=dense["vel_uncert"],
                baz_uncert_array=dense["baz_uncert"],
                num_compute_list=list(plan.num_compute_list),
                flags=flags,
                pairs=self.pairs_np,
                nchans=self.nchans,
                plan=plan,
                w_array=w_array,
                h_array=h_array,
            )
