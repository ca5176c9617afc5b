"""Window extraction: the ragged (band, window) grid as dense tensors + masks.

Port of ``narrow_band_least_squares_tpu/ops/windows.py``.  The host grids
(``WindowGrid``, ``BucketGrid``, cost bucketing) are the same code.  Band b
has its own window length and hop, so the (band, window) space is padded to
``(B, Wmax, C, Lmax)`` with a valid-window and a valid-sample mask.

The strided extractor is a right zero-pad and ``Tensor.unfold`` (a view);
the JAX package's interleaved-reshape form existed only to avoid an XLA
gather.  Window w of a band starts at ``w * hop`` in both, so the two agree
on every slot, the padded ones (w >= n_windows) included.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as Fnn

from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan


@dataclass(frozen=True)
class WindowGrid:
    """Static gather plan for the dense (band, window, sample) grid."""

    idx: np.ndarray          # (B, Wmax, Lmax) int32 gather indices into T
    win_mask: np.ndarray     # (B, Wmax) bool — window exists for this band
    len_mask: np.ndarray     # (B, 1, 1, Lmax) float — sample within band winlen
    lengths: np.ndarray      # (B,) int32 winlensamp per band
    lag_mask: np.ndarray     # (B, 2*Lmax-1) bool — |lag| <= winlensamp-1
    Wmax: int
    Lmax: int

    @property
    def nbands(self) -> int:
        return self.idx.shape[0]


def build_window_grid(plan: NarrowBandPlan) -> WindowGrid:
    B = plan.nbands
    Wmax = plan.max_windows
    Lmax = plan.max_winlensamp

    idx = np.zeros((B, Wmax, Lmax), dtype=np.int32)
    win_mask = np.zeros((B, Wmax), dtype=bool)
    len_mask = np.zeros((B, Lmax), dtype=np.float64)
    lengths = np.zeros((B,), dtype=np.int32)
    lag_mask = np.zeros((B, 2 * Lmax - 1), dtype=bool)
    lags = np.arange(-(Lmax - 1), Lmax)

    for b, wp in enumerate(plan.windows):
        L = wp.winlensamp
        lengths[b] = L
        len_mask[b, :L] = 1.0
        lag_mask[b] = np.abs(lags) <= (L - 1)
        for w, s0 in enumerate(wp.starts):
            win_mask[b, w] = True
            # out-of-range tail samples clamp to the window start (masked out)
            idx[b, w, :L] = s0 + np.arange(L)
            idx[b, w, L:] = s0
    return WindowGrid(
        idx=idx,
        win_mask=win_mask,
        len_mask=len_mask.reshape(B, 1, 1, Lmax),
        lengths=lengths,
        lag_mask=lag_mask,
        Wmax=Wmax,
        Lmax=Lmax,
    )


@dataclass(frozen=True)
class BucketGrid:
    """One window-length bucket of bands: a compact sub-grid.

    Bands whose window lengths are close share one padded (Wmax_g, Lmax_g)
    grid, so a dense-band sweep does not pad every band to the globally
    largest window and window count."""

    band_idx: np.ndarray     # (Bg,) int32 band indices into the full plan
    idx: np.ndarray          # (Bg, Wmax_g, Lmax_g) gather indices
    len_mask: np.ndarray     # (Bg, 1, 1, Lmax_g) float
    lengths: np.ndarray      # (Bg,) int32
    lag_mask: np.ndarray     # (Bg, nlag_g) bool
    Wmax: int
    Lmax: int


def bucket_by_cost(
    lens: np.ndarray,        # (n,) window length per item, any order
    wins: np.ndarray,        # (n,) window count per item
    slack: float = 1.08,
) -> list:
    """Group items (bands or band-slots) into padded-shape buckets by cost.

    Items are walked in descending window length; an item joins the current
    bucket only while the bucket's *padded* xcorr cost (items x Wmax x
    Lmax^2) stays within ``slack`` of the sum of per-item true costs.
    Returns a list of index groups (into the input arrays).
    """
    lens = np.asarray(lens, dtype=np.int64)
    wins = np.asarray(wins, dtype=np.int64)
    order = np.argsort(-lens, kind="stable")
    groups: list = []
    cur: list = []
    cur_true = 0.0
    for i in order:
        i = int(i)
        cand = cur + [i]
        Lg = int(lens[cand].max())
        Wg = int(wins[cand].max())
        true = cur_true + float(wins[i]) * float(lens[i]) ** 2
        padded = len(cand) * float(Wg) * float(Lg) ** 2
        if not cur or padded <= slack * true:
            cur = cand
            cur_true = true
        else:
            groups.append(cur)
            cur = [i]
            cur_true = float(wins[i]) * float(lens[i]) ** 2
    if cur:
        groups.append(cur)
    return groups


def build_bucket_grids(
    plan: NarrowBandPlan,
    ratio: float = 1.3,
    max_lag: int | None = None,
    slack: float = 1.08,
) -> list:
    """Partition bands into window-length buckets and build each sub-grid.

    With ``max_lag`` the per-bucket lag range is capped to
    ``[-max_lag, max_lag]`` (clamped to the bucket's own Lmax-1).
    ``ratio`` is kept for signature parity with the JAX package; it does
    not drive the grouping.
    """
    lens = np.array([wp.winlensamp for wp in plan.windows])
    wins = np.array([wp.n_windows for wp in plan.windows])
    buckets = bucket_by_cost(lens, wins, slack=slack)

    grids = []
    for band_list in buckets:
        wps = [plan.windows[b] for b in band_list]
        Lmax = max(wp.winlensamp for wp in wps)
        Wmax = max(wp.n_windows for wp in wps)
        half = Lmax - 1 if max_lag is None else min(int(max_lag), Lmax - 1)
        nlag = 2 * half + 1
        lags = np.arange(-half, half + 1)

        Bg = len(band_list)
        idx = np.zeros((Bg, Wmax, Lmax), dtype=np.int32)
        len_mask = np.zeros((Bg, Lmax), dtype=np.float64)
        lengths = np.zeros((Bg,), dtype=np.int32)
        lag_mask = np.zeros((Bg, nlag), dtype=bool)
        for g, wp in enumerate(wps):
            L = wp.winlensamp
            lengths[g] = L
            len_mask[g, :L] = 1.0
            lag_mask[g] = np.abs(lags) <= (L - 1)
            for w, s0 in enumerate(wp.starts):
                idx[g, w, :L] = s0 + np.arange(L)
                idx[g, w, L:] = s0
        grids.append(BucketGrid(
            band_idx=np.asarray(band_list, dtype=np.int32),
            idx=idx,
            len_mask=len_mask.reshape(Bg, 1, 1, Lmax),
            lengths=lengths,
            lag_mask=lag_mask,
            Wmax=Wmax,
            Lmax=Lmax,
        ))
    return grids


def mask_demean(
    win: torch.Tensor,       # (B, Wmax, C, Lmax) raw windows
    len_mask: torch.Tensor,  # (B, 1, 1, Lmax)
    lengths: torch.Tensor,   # (B,) float — winlensamp per band
) -> torch.Tensor:
    """Shared tail of every extractor: zero-pad + per-window demean, in the
    windows' dtype (the mask and lengths are cast to it)."""
    len_mask, lengths = len_mask.to(win.dtype), lengths.to(win.dtype)
    win = win * len_mask
    mean = torch.sum(win, dim=-1, keepdim=True) / lengths[:, None, None, None]
    return (win - mean) * len_mask


def _strided_band(yb: torch.Tensor, hop: int, Wmax: int, Lmax: int) -> torch.Tensor:
    """One band's windows (C, T) -> (Wmax, C, Lmax); window w starts at w*hop."""
    need = (Wmax - 1) * hop + Lmax
    pad = need - yb.shape[-1]
    if pad > 0:
        yb = Fnn.pad(yb, (0, pad))
    return yb.unfold(-1, Lmax, hop)[:, :Wmax].transpose(0, 1)


def extract_windows_strided(
    y: torch.Tensor,         # (B, C, T) filtered waveforms
    plan: NarrowBandPlan,
    len_mask: torch.Tensor,  # (B, 1, 1, Lmax)
    lengths: torch.Tensor,   # (B,) float
) -> torch.Tensor:
    """Gather-free extraction over the global grid; same result as
    `extract_windows` on every valid window."""
    Wmax, Lmax = plan.max_windows, plan.max_winlensamp
    win = torch.stack(
        [_strided_band(y[b], wp.hop, Wmax, Lmax)
         for b, wp in enumerate(plan.windows)],
        dim=0,
    )
    return mask_demean(win, len_mask, lengths)


def extract_windows_strided_rows(
    y: torch.Tensor,         # (B, C, T) filtered waveforms
    rows,                    # R row indices into y
    hops,                    # R hops: the hop of the band each row holds
    Wmax: int,
    Lmax: int,
    len_mask: torch.Tensor,  # (R, 1, 1, Lmax) each row's own length
    lengths: torch.Tensor,   # (R,) float
) -> torch.Tensor:
    """Strided extraction of rows ``rows`` of ``y`` on one (Wmax, Lmax)
    grid: row r's windows start every ``hops[r]`` samples and are masked to
    its own length -> (R, Wmax, C, Lmax).  A window-length bucket passes its
    bands and their hops; a slot template of the band-sharded pipeline its
    slots' rows.  Gather extraction over a per-slot ``idx`` is
    `extract_windows` on the same rows."""
    win = torch.stack(
        [_strided_band(y[int(r)], int(h), Wmax, Lmax) for r, h in zip(rows, hops)],
        dim=0,
    )
    return mask_demean(win, len_mask, lengths)


def extract_windows_patches(
    y: torch.Tensor,         # (B, C, T) filtered waveforms
    plan: NarrowBandPlan,
    len_mask: torch.Tensor,  # (B, 1, 1, Lmax)
    lengths: torch.Tensor,   # (B,) float
) -> torch.Tensor:
    """Im2col extraction (``window_method='patches'``): each band's rows,
    zero-padded by Lmax at the end, cut into Lmax-wide patches every hop
    samples (``Tensor.unfold``, the JAX package's
    ``conv_general_dilated_patches`` with VALID padding), the first Wmax
    kept (zero patches past the last).  Same demean/mask contract as
    `extract_windows`; equal to `extract_windows_strided` on every window."""
    Wmax, Lmax = plan.max_windows, plan.max_winlensamp
    ypad = Fnn.pad(y, (0, Lmax))
    per_band = []
    for b, wp in enumerate(plan.windows):
        pats = ypad[b].unfold(-1, Lmax, wp.hop)[:, :Wmax]     # (C, W', Lmax)
        if pats.shape[1] < Wmax:
            pats = Fnn.pad(pats, (0, 0, 0, Wmax - pats.shape[1]))
        per_band.append(pats.transpose(0, 1))                # (Wmax, C, Lmax)
    return mask_demean(torch.stack(per_band, dim=0), len_mask, lengths)


def extract_windows(
    y: torch.Tensor,         # (B, C, T) filtered waveforms
    idx: torch.Tensor,       # (B, Wmax, Lmax) int64 gather indices
    len_mask: torch.Tensor,  # (B, 1, 1, Lmax)
    lengths: torch.Tensor,   # (B,) float — winlensamp per band
) -> torch.Tensor:
    """Gather, demean (over valid samples) and mask windows.

    Returns (B, Wmax, C, Lmax); padded samples are exactly zero.
    """
    B, C, T = y.shape
    _, W, L = idx.shape
    win = torch.gather(
        y[:, :, None, :].expand(B, C, W, T), -1,
        idx.long()[:, None, :, :].expand(B, C, W, L),
    )                                                  # (B, C, W, L)
    return mask_demean(win.transpose(1, 2), len_mask, lengths)


def split_windows(t: torch.Tensor, n: int, Wmax: int) -> torch.Tensor:
    """``(R, n*W, ...) -> (n, R, Wmax, ...)``: the window axis of ``n``
    batches merged into one lag search (window ``i*W + w`` of row r is
    batch i's window w: arrays, or a rank's segments) split out in front,
    zero-padded to ``Wmax`` windows."""
    R, W = t.shape[0], t.shape[1] // n
    t = t.reshape((R, n, W) + tuple(t.shape[2:])).transpose(0, 1)
    pad = Wmax - W
    return Fnn.pad(t, (0, 0) * (t.dim() - 3) + (0, pad)) if pad else t
