# Frozen copy of narrow_band_least_squares_tpu_torch/utils/geometry.py at
# commit 3ee1e9bea504232cbf251ade8fbcb464f796f707, with its imports
# rewritten to portbench.reference.  The benchmark's yardstick: later
# changes to the port do not move it.  Edit it only with the benchmark.
"""Array geometry: lat/lon -> local Cartesian element coordinates -> co-array.

The reference obtains element positions with ObsPy's Vincenty inverse on the
WGS84 ellipsoid and converts the geodesic azimuth into the math convention
``(450 - az) % 360`` before projecting to x/y in km and removing the mean
(reference ``helpers.py:239-283``).  ObsPy is not a dependency here, so the
Vincenty inverse is implemented directly (standard iterative formula on
WGS84).  This is host-side setup code: it runs once per array in NumPy.
A copy of ``narrow_band_least_squares_tpu/utils/geometry.py``: the port
imports nothing of the JAX package, so it keeps its own.

Conventions (identical to the reference):
    - ``rij`` is a ``(2, N)`` array in **km**; row 0 is Cartesian X (east),
      row 1 is Cartesian Y (north); columns are zero-mean.
    - The co-array is built from all N(N-1)/2 element pairs ``(i, j)`` with
      ``i < j`` in lexicographic order.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# WGS84 ellipsoid (same ellipsoid ObsPy defaults to; reference helpers.py:270).
WGS84_A = 6378137.0                 # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563      # flattening
WGS84_B = WGS84_A * (1.0 - WGS84_F)


def vincenty_inverse(
    lat1: float, lon1: float, lat2: float, lon2: float,
    tol: float = 1e-12, max_iter: int = 200,
) -> Tuple[float, float, float]:
    """Geodesic distance and azimuths between two points on WGS84.

    Returns ``(distance_m, azimuth_a2b_deg, azimuth_b2a_deg)`` with azimuths
    in degrees clockwise from north, matching the contract of ObsPy's
    ``calc_vincenty_inverse`` used at reference ``helpers.py:271-272``.
    """
    if lat1 == lat2 and lon1 == lon2:
        return 0.0, 0.0, 0.0

    phi1, phi2 = math.radians(lat1), math.radians(lat2)
    L = math.radians(lon2 - lon1)
    U1 = math.atan((1.0 - WGS84_F) * math.tan(phi1))
    U2 = math.atan((1.0 - WGS84_F) * math.tan(phi2))
    sinU1, cosU1 = math.sin(U1), math.cos(U1)
    sinU2, cosU2 = math.sin(U2), math.cos(U2)

    lam = L
    for _ in range(max_iter):
        sin_lam, cos_lam = math.sin(lam), math.cos(lam)
        sin_sigma = math.sqrt(
            (cosU2 * sin_lam) ** 2
            + (cosU1 * sinU2 - sinU1 * cosU2 * cos_lam) ** 2
        )
        if sin_sigma == 0.0:
            return 0.0, 0.0, 0.0  # coincident points
        cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * cos_lam
        sigma = math.atan2(sin_sigma, cos_sigma)
        sin_alpha = cosU1 * cosU2 * sin_lam / sin_sigma
        cos2_alpha = 1.0 - sin_alpha**2
        if cos2_alpha == 0.0:  # equatorial line
            cos_2sigma_m = 0.0
        else:
            cos_2sigma_m = cos_sigma - 2.0 * sinU1 * sinU2 / cos2_alpha
        C = WGS84_F / 16.0 * cos2_alpha * (4.0 + WGS84_F * (4.0 - 3.0 * cos2_alpha))
        lam_prev = lam
        lam = L + (1.0 - C) * WGS84_F * sin_alpha * (
            sigma
            + C * sin_sigma * (
                cos_2sigma_m + C * cos_sigma * (-1.0 + 2.0 * cos_2sigma_m**2)
            )
        )
        if abs(lam - lam_prev) < tol:
            break

    u2 = cos2_alpha * (WGS84_A**2 - WGS84_B**2) / WGS84_B**2
    A = 1.0 + u2 / 16384.0 * (4096.0 + u2 * (-768.0 + u2 * (320.0 - 175.0 * u2)))
    Bc = u2 / 1024.0 * (256.0 + u2 * (-128.0 + u2 * (74.0 - 47.0 * u2)))
    delta_sigma = Bc * sin_sigma * (
        cos_2sigma_m
        + Bc / 4.0 * (
            cos_sigma * (-1.0 + 2.0 * cos_2sigma_m**2)
            - Bc / 6.0 * cos_2sigma_m
            * (-3.0 + 4.0 * sin_sigma**2)
            * (-3.0 + 4.0 * cos_2sigma_m**2)
        )
    )
    distance = WGS84_B * A * (sigma - delta_sigma)

    alpha1 = math.atan2(
        cosU2 * math.sin(lam),
        cosU1 * sinU2 - sinU1 * cosU2 * math.cos(lam),
    )
    alpha2 = math.atan2(
        cosU1 * math.sin(lam),
        -sinU1 * cosU2 + cosU1 * sinU2 * math.cos(lam),
    )
    az12 = math.degrees(alpha1) % 360.0
    az21 = (math.degrees(alpha2) + 180.0) % 360.0
    return distance, az12, az21


def get_rij(latlist: Sequence[float], lonlist: Sequence[float], nchans: int) -> np.ndarray:
    """Project element lat/lons to zero-mean X/Y coordinates in km.

    Mirrors reference ``helpers.py:239-283``: Vincenty inverse from element 0
    to each element j, azimuth converted with ``(450 - az) % 360``, distances
    in km, then mean removal.  Raises ``ValueError`` on a length mismatch
    (reference ``helpers.py:262-263``).
    """
    if (len(latlist) != nchans) or (len(lonlist) != nchans):
        raise ValueError(
            "Mismatch between the number of stream channels and the latitude "
            "or longitude list length."
        )
    xnew = np.zeros((nchans,))
    ynew = np.zeros((nchans,))
    for jj in range(1, nchans):
        delta, az, _ = vincenty_inverse(
            latlist[0], lonlist[0], latlist[jj], lonlist[jj]
        )
        az = (450.0 - az) % 360.0
        xnew[jj] = delta / 1000.0 * np.cos(az * np.pi / 180.0)
        ynew[jj] = delta / 1000.0 * np.sin(az * np.pi / 180.0)
    xnew -= np.mean(xnew)
    ynew -= np.mean(ynew)
    return np.array([xnew, ynew])


def pair_indices(n: int) -> np.ndarray:
    """All (i, j) element pairs with i < j, lexicographic.  Shape (P, 2)."""
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return np.asarray(pairs, dtype=np.int32)


def coarray(rij: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Co-array design matrix for the slowness inversion.

    For each pair ``p = (i, j)`` with ``i < j``, row p of ``X`` is
    ``r_j - r_i`` in km (x=east, y=north).  With the plane-wave model
    ``arrival_time(k) = t0 + r_k . s`` (s the slowness vector pointing in the
    propagation direction, |s| = 1/v), the inter-element delays satisfy
    ``tau = X @ s`` where ``tau_p = arrival(j) - arrival(i)``.

    Returns ``(X, pairs)`` with ``X`` of shape ``(P, 2)`` and ``pairs`` of
    shape ``(P, 2)``.
    """
    rij = np.asarray(rij, dtype=np.float64)
    n = rij.shape[1]
    pairs = pair_indices(n)
    X = (rij[:, pairs[:, 1]] - rij[:, pairs[:, 0]]).T  # (P, 2)
    return X, pairs


def slowness_to_vel_baz(sx: np.ndarray, sy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Slowness vector [s/km] -> (trace velocity [km/s], back-azimuth [deg]).

    The back-azimuth points *toward the source*, i.e. along ``-s``, measured
    in degrees clockwise from north (matching the reference's 0-360 plotting
    convention, ``plotting.py:104``).
    """
    smag = np.sqrt(sx**2 + sy**2)
    with np.errstate(divide="ignore", invalid="ignore"):
        vel = np.where(smag > 0, 1.0 / smag, np.nan)
    baz = (np.degrees(np.arctan2(-sx, -sy))) % 360.0
    return vel, baz
