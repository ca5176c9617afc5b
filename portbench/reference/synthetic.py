# Frozen copy of narrow_band_least_squares_tpu_torch/io/synthetic.py at
# commit 3ee1e9bea504232cbf251ade8fbcb464f796f707, with its imports
# rewritten to portbench.reference.  The benchmark's yardstick: later
# changes to the port do not move it.  Edit it only with the benchmark.
"""Synthetic plane-wave generator for tests, examples and benchmarks.

The reference validates itself only against a recorded IRIS event
(reference ``example.py:40-47``); with zero network egress we instead
synthesize an acoustic plane wave crossing a small-aperture array with a
known back-azimuth and trace velocity, which gives analytic ground truth for
delay, velocity and azimuth recovery tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from portbench.reference.geometry import get_rij


@dataclass
class SyntheticStream:
    """The generator's output: what the copied original returned as the
    port's ``ArrayStream``, without importing the port."""

    data: np.ndarray
    fs: float
    start_epoch: float
    latitudes: List[float]
    longitudes: List[float]
    ids: List[str] = field(default_factory=list)


def default_array_coords(
    nchans: int = 8, aperture_km: float = 2.0,
    lat0: float = 64.8738, lon0: float = -147.8614,
) -> Tuple[list, list]:
    """A rough ring array of `nchans` elements around (lat0, lon0)."""
    # ~111.32 km per degree latitude; longitude scaled by cos(lat)
    lats, lons = [], []
    rng = np.random.default_rng(1234)
    for k in range(nchans):
        ang = 2 * np.pi * k / nchans
        r = aperture_km / 2.0 * (1.0 + 0.15 * rng.standard_normal())
        dn = r * np.cos(ang)  # north km
        de = r * np.sin(ang)  # east km
        lats.append(lat0 + dn / 111.32)
        lons.append(lon0 + de / (111.32 * np.cos(np.radians(lat0))))
    return lats, lons


def synthetic_plane_wave(
    nchans: int = 8,
    duration_s: float = 1200.0,
    fs: float = 20.0,
    baz_deg: float = 230.0,
    trace_vel_kms: float = 0.34,
    f0: float = 0.5,
    bandwidth: float = 1.5,
    snr: float = 10.0,
    aperture_km: float = 2.0,
    start_epoch: float = 1545183900.0,  # 2018-12-19T01:45:00Z, the reference event
    seed: int = 0,
    lats: Optional[Sequence[float]] = None,
    lons: Optional[Sequence[float]] = None,
    outlier_channels: Sequence[int] = (),
) -> SyntheticStream:
    """Synthesize a band-limited plane wave crossing the array.

    The wave propagates *from* back-azimuth ``baz_deg`` (degrees clockwise
    from north) at ``trace_vel_kms``; the same filtered-noise source signal is
    delayed per element according to the plane-wave model
    ``arrival(k) = t0 + r_k . s`` (see utils.geometry.coarray), implemented
    exactly via Fourier-domain fractional delays.  ``outlier_channels`` get an
    independent noise realization instead of the coherent signal — useful for
    LTS flag tests.
    """
    rng = np.random.default_rng(seed)
    npts = int(round(duration_s * fs))

    if lats is None or lons is None:
        lats, lons = default_array_coords(nchans, aperture_km)
    lats, lons = list(lats), list(lons)
    rij = get_rij(lats, lons, nchans)  # (2, N) km, x=east, y=north

    # Slowness vector pointing in the propagation direction (away from source):
    # the wave arrives FROM baz, so it propagates TOWARD baz+180.
    az_prop = np.radians((baz_deg + 180.0) % 360.0)
    s = np.array([np.sin(az_prop), np.cos(az_prop)]) / trace_vel_kms  # (sx, sy) s/km

    # Band-limited random source signal (filtered white noise + a tone).
    src = rng.standard_normal(npts)
    freqs = np.fft.rfftfreq(npts, d=1.0 / fs)
    S = np.fft.rfft(src)
    lo, hi = max(f0 - bandwidth / 2, 1e-3), f0 + bandwidth / 2
    bandmask = ((freqs >= lo) & (freqs <= hi)).astype(float)
    # soften the brick wall to avoid ringing
    from numpy import convolve
    k = np.hanning(9) / np.hanning(9).sum()
    bandmask = convolve(bandmask, k, mode="same")
    S *= bandmask
    src = np.fft.irfft(S, n=npts)
    src /= (np.std(src) + 1e-30)

    data = np.zeros((nchans, npts))
    Ssrc = np.fft.rfft(src)
    for c in range(nchans):
        delay_s = float(rij[0, c] * s[0] + rij[1, c] * s[1])  # r_k . s
        if c in outlier_channels:
            data[c] = rng.standard_normal(npts)
        else:
            phase = np.exp(-2j * np.pi * freqs * delay_s)
            data[c] = np.fft.irfft(Ssrc * phase, n=npts)
        data[c] += rng.standard_normal(npts) / snr

    return SyntheticStream(
        data=data,
        fs=fs,
        start_epoch=start_epoch,
        latitudes=lats,
        longitudes=lons,
        ids=[f"SYN.EL{c:02d}..BDF" for c in range(nchans)],
    )
