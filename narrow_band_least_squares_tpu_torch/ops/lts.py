"""Vectorized exact LTS (least trimmed squares) slowness estimation.

Port of ``narrow_band_least_squares_tpu/ops/lts.py``.  The reference's
robust mode runs FAST-LTS per window: elemental subsets plus concentration
C-steps over the n(n-1)/2 delay equations.  The slowness has two
components, so elemental subsets are *pairs of equations*: every C(P,2)
candidate is enumerated and solved as a closed-form 2x2 system, and the
C-steps become batched masked normal-equation refits over every (band,
window, candidate) at once.

Retained-set size: ``h = clamp(floor(ALPHA * P), 3, P)`` equations.  The
equations outside the optimal subset are the flagged pairs of the
reference's stdict.

The flags hang on the last bits of the squared residuals at the h
boundary, so the sweep computes the float32 bits of the JAX package's
``lts_solve`` as XLA compiles it on the CPU, on the card and on the CPU
alike.  XLA's CPU backend lets LLVM contract a multiply into an add or a
subtract of the same basic block whose only use it is (one rounding), and
the sweep's programs contract at these sites, the product named first
left unrounded:

- the residuals, ``_residuals2`` and the final subset (``einsum`` over k =
  2): ``r = tau - fma(X[p,1], s1, X[p,0] * s0)``, then ``r * r``;
- the elemental solves (``einsum`` over j = 2): ``fma(Ainv[q,i,1], t1,
  Ainv[q,i,0] * t0)``;
- the refit (`ops.solve.masked_refit`): the first level of each halving
  tree, ``fma(u[i], v[i], u[i+h] * v[i+h])`` (later levels add sums),
  except the sums `UNCONTRACTED` lists; then ``det = fma(m00, m11, -(m01
  m01))`` and the two numerators alike;
- the objective's tree over ``sel * r2``: its first level contracts too,
  but ``sel`` is 0 or 1, so each product is exact and a plain tree gives
  the same bits.

Everything else rounds each operation, and a dtype narrower than float32
contracts nothing.  `ops.kernels.lts_sweep` computes the contracted sites,
with a kernel on the card (``csrc/lts_sweep.cu``) and an exact float32
fused multiply-add on the CPU; compared sums are fixed trees
(`ops.kernels.lts_sweep.tree_sum_last`), ranks are comparison counts and
ties resolve by index.  On the card the C-steps and the trimmed objective
of a candidate block are one launch (`ops.kernels.lts_sweep.sweep`), whose
plain version composes those pieces, and so is the final subset at up to 64
equations (`ops.kernels.lts_sweep.final`: the first minimum, the retained
subset, its refit, sigma_tau and the uncertainty ellipse; `sigma_tau`'s and
the ellipse's sums are fixed trees there).  The model holds in ``lts_solve``
jitted alone and in the
pipeline's step, the chunked ``lax.map`` sweep, the funnel, the merged
multi-array program and the sharded step.

The one-band programs (``ltsva``, ``narrow_band_loop``, the broadband
pipeline, a one-band pipeline, merged multi-array program or sharded step)
also fuse the delays' product ``lag * (1/fs)`` into the sweep's fusions
that follow the candidate loop, and where the product and the residual's
subtraction share a basic block XLA contracts them: the residual is
``fma(lag, 1/fs, -xs)``, from the unrounded delay.  Which residuals do is
a property of the program's loops, so it is a table (`delay_contracted`),
read from the optimized IR of those programs for 3 to 16 elements and 20
on streams of 15 windows, and for 4 to 11 elements on streams of 27 and
39 windows compiled for 3 and 8 CPUs, where it is the same
(``scripts/xla_contractions.py --ltsva [--duration S] [--threads N]``,
which checks the table against the installed jaxlib).  Its sites:

- ``objective``: the trimmed objective of the candidates after their
  C-steps (with the funnel: after the lone first step), as the rank keys
  ``i`` (the key ranked: ``x_j < x_i`` counts against i) and ``j`` (the
  keys it is counted against, the diagonal included) and the halves ``lo``
  and ``hi`` of the objective tree's first level ``v[k] + v[k + half]``;
- ``single``: the rank keys of the funnel's lone first C-step;
- ``survivors``: the funnel's objective over its survivors;
- ``final``: the ranks of the retained subset;
- ``sigma2``: the retained subset's residuals in ``sigma_tau``.

The C-steps inside a ``fori_loop`` and every site of a chunked sweep
(inside ``lax.map``) take the rounded delays: there the delays enter as a
loop operand.  A pipeline passes the lags only where the JAX program fuses
them (`NarrowBandPipeline`'s one-band rule), recovered from its integer-lag
delays; ``lts_solve`` without them is the jitted solve's model.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
from narrow_band_least_squares_tpu_torch.ops.solve import (
    SIGMA_TAU_DOF_SHIFT,
    degrees,
    masked_refit,
    vel_baz_from_slowness,
)

# The refit sums whose first tree level the JAX package's jitted lts_solve
# does not contract, by P and site, as jaxlib 0.9.0 compiles it for an x86
# CPU with FMA: there XLA fused the padded products into the tree's first
# level, whose add then sits in another basic block than the product.  A
# site is "loop" (C-steps of a fori_loop of two steps or more), "single" (a
# C-step alone: the funnel's first) or "final" (the refit of the retained
# subset).  Read from the optimized LLVM IR of lts_solve jitted alone
# (exhaustive, chunked, funnel) for 3 to 16 elements and 20
# (`scripts/xla_contractions.py`, which also checks this table against the
# installed jaxlib), and of the pipeline's step and the merged multi-array
# program at 6, 8 and 16 elements and the sharded step at 6 and 8, which
# agree; every other site of those P contracts, and so does any P not read.
UNCONTRACTED = {
    28: {"single": ("b0", "b1"), "final": ("b0", "b1")},
    78: {"loop": ("m01",)},
    91: {"loop": ("m01",)},
    105: {"loop": ("m01",)},
    120: {"loop": ("m01",)},
    190: {"loop": ("m00", "m11", "b0", "b1")},
}


# The roles of the one-band programs' objective whose residuals take the
# unrounded delay, by P: the rank keys "i" and "j" and the tree halves "lo"
# and "hi" (`delay_contracted` gives every site).  Read with jaxlib 0.9.0
# for 3 to 14 elements and, with the candidates capped at 2048 (more than
# 4096 are chunked), 16; any other P takes the entry of the largest P
# below it, which the readings at 15 and 20 elements (capped) confirm.
DELAY_OBJECTIVE = {
    3: "i", 6: "i", 10: "i", 15: "i",
    21: "i lo hi", 28: "i lo hi",
    36: "i j lo", 45: "i j lo", 55: "i j lo",
    66: "i j lo hi", 78: "i j lo hi", 91: "i j lo hi", 120: "i j lo hi",
}


def lts_schedule(Q: int, candidate_chunk: int, funnel_k: int, c_steps: int) -> str:
    """"chunk" (candidate blocks in a loop, funnel or not), "funnel" or
    "exhaustive": how the JAX package sweeps Q candidates with these
    options."""
    if candidate_chunk and candidate_chunk < Q:
        return "chunk"
    return "funnel" if funnel_k and funnel_k < Q and c_steps > 1 else "exhaustive"


def delay_contracted(P: int, schedule: str) -> frozenset:
    """The sites (``"site.role"``, the module docstring's names) whose
    residuals the JAX package's one-band program at P and ``schedule``
    computes from the unrounded delay, with four C-steps: the retained
    subset's ranks and ``sigma2`` always; unchunked, the objective's roles
    of `DELAY_OBJECTIVE`, and with the funnel the same for its survivors
    and the rank keys among them for its lone first C-step."""
    out = {"final.i", "final.j", "sigma2"}
    if schedule == "chunk":
        return frozenset(out)
    roles = DELAY_OBJECTIVE[max(k for k in DELAY_OBJECTIVE if k <= max(P, 3))].split()
    out |= {f"objective.{r}" for r in roles}
    if schedule == "funnel":
        out |= {f"survivors.{r}" for r in roles}
        out |= {f"single.{r}" for r in roles if r in ("i", "j")}
    return frozenset(out)


def refit_contractions(P: int, site: str) -> int:
    """The ``contract`` bits of `masked_refit` at a site of the sweep."""
    off = UNCONTRACTED.get(P, {}).get(site, ())
    return LS.ALL_CONTRACTED & ~sum(1 << LS.SUMS.index(k) for k in off)


# Byte budget of the (rows, P, P) boolean temporary of one
# `_rank_along_last` chunk (the final subset's ranks; the sweep's plain
# version takes `ops.kernels.lts_sweep.RANK_CHUNK_BYTES`).
RANK_CHUNK_BYTES = LS.RANK_CHUNK_BYTES


def lts_h(alpha: float, P: int) -> int:
    return max(3, min(int(np.floor(alpha * P)), P))


def precompute_candidates(
    X: np.ndarray, max_candidates: int = 0, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Host-side elemental 2-subset enumeration and 2x2 inverses.

    ``max_candidates = 0`` (the default) enumerates all C(P,2) elemental
    2-subsets: exhaustive LTS; callers bound memory with
    ``candidate_chunk``.  ``> 0`` subsamples to that many with
    ``default_rng(seed)``, the JAX package's draw, so both pick the same
    candidates.
    """
    P = X.shape[0]
    cand = np.array(list(combinations(range(P), 2)), dtype=np.int32)
    if max_candidates and len(cand) > max_candidates:
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(cand), size=max_candidates, replace=False)
        keep.sort()
        cand = cand[keep]
    A = X[cand]                       # (Q, 2, 2)
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    ok = np.abs(det) > 1e-12
    safe = np.where(ok, det, 1.0)
    Ainv = np.empty_like(A)
    Ainv[:, 0, 0] = A[:, 1, 1] / safe
    Ainv[:, 0, 1] = -A[:, 0, 1] / safe
    Ainv[:, 1, 0] = -A[:, 1, 0] / safe
    Ainv[:, 1, 1] = A[:, 0, 0] / safe
    return {"cand": cand, "Ainv": Ainv, "ok": ok}


def _rank_along_last(x: torch.Tensor, against: torch.Tensor = None) -> torch.Tensor:
    """Stable rank along the last axis, x_i ranked against ``against``
    (`ops.kernels.lts_sweep.rank_along_last`), in chunks of
    `RANK_CHUNK_BYTES`."""
    return LS.rank_along_last(x, against, RANK_CHUNK_BYTES)


def _residuals2(tau: torch.Tensor, X: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Squared residuals (..., Q, P) of the candidate fits s (..., Q, 2)."""
    return LS.residuals2(tau, X, s)


class _Delay:
    """The lags (..., P) that the delays are ``lag * inv_fs`` of and the
    sites (`delay_contracted`) whose residuals take them unrounded."""

    def __init__(self, lag: torch.Tensor, inv_fs: float, sites):
        self.lag, self.inv_fs, self.sites = lag, float(inv_fs), frozenset(sites)

    def residuals2(self, keys, tau, X, s):
        """The squared residuals (..., Q, P) of the fits s (..., Q, 2), one
        a key (``"site.role"`` or ``"sigma2"``): from the lags where the key
        is a site, else from the rounded delays; each computed once."""
        un = (LS.residuals2_lag(self.lag, self.inv_fs, X, s)
              if any(k in self.sites for k in keys) else None)
        rounded = _residuals2(tau, X, s) if any(k not in self.sites for k in keys) else None
        return tuple(un if k in self.sites else rounded for k in keys)


def _site_residuals2(tau, X, s, delay, site, roles=("i", "j", "lo", "hi")):
    """The squared residuals of ``site`` for each of ``roles`` (an empty
    role: the site itself), `_Delay.residuals2`; all rounded without
    ``delay``."""
    if delay is None:
        return (_residuals2(tau, X, s),) * len(roles)
    return delay.residuals2([f"{site}.{r}" if r else site for r in roles], tau, X, s)


def sweep_roles(sites, step_site=None, objective_site="objective") -> int:
    """The ``roles`` bits (`ops.kernels.lts_sweep.ROLES`) of one
    `lts_sweep.sweep` whose C-steps are ``step_site`` (None: a step of the
    C-step loop, which takes the rounded delays) and whose objective is
    ``objective_site``: those of the `delay_contracted` ``sites``."""
    names = {"step": step_site, "objective": objective_site}
    roles = 0
    for k, role in enumerate(LS.ROLES):
        where, r = role.split(".")
        if names[where] and f"{names[where]}.{r}" in sites:
            roles |= 1 << k
    return roles


def _sweep(tau, X, s, h, n_steps, delay=None, step_site=None, objective_site="objective"):
    """``n_steps`` concentration steps on a candidate block s (..., Q, 2)
    and the trimmed objective of the result (the sum of the h smallest
    squared residuals as a fixed tree, NaN -> inf), one `lts_sweep.sweep`:
    (s, obj); ``delay`` (`_Delay`) gives the unrounded residuals of the
    sites' roles (`sweep_roles`)."""
    contract = refit_contractions(tau.shape[-1], "single" if n_steps == 1 else "loop")
    roles = 0 if delay is None else sweep_roles(delay.sites, step_site, objective_site)
    return LS.sweep(tau, X, s, h, n_steps, contract, True,
                    lag=delay.lag if roles else None,
                    inv_fs=delay.inv_fs if roles else 0.0, roles=roles)


def _take(s: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """s (..., Q, 2) at candidate indices i (..., K) -> (..., K, 2)."""
    return s.gather(-2, i[..., None].expand(i.shape + (2,)))


def _survivors(obj: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) of the k smallest objectives, in ascending order and
    among equal ones lower index first: the order of the JAX package's
    ``lax.top_k(-obj, k)``, which ``torch.topk`` does not promise on CUDA."""
    return torch.sort(obj, dim=-1, stable=True).indices[..., :k]


def _candidate_sweep(tau, X, cand, Ainv, cand_ok, h, c_steps, funnel_k=0, delay=None):
    """Elemental solves + C-steps for one candidate block.

    ``funnel_k > 0`` applies the FAST-LTS funnel: one C-step on every
    candidate, then the remaining ``c_steps - 1`` only on the ``funnel_k``
    best by trimmed objective (`_survivors`).  ``delay`` (`_Delay`) gives
    the objective, lone-step and survivor sites' unrounded residuals.
    Returns (obj (..., K), s (..., K, 2)).
    """
    s = LS.elemental(tau, cand, Ainv)                 # (..., Q, 2)
    inf = torch.full((), float("inf"), dtype=tau.dtype, device=tau.device)

    if funnel_k and funnel_k < cand.shape[0] and c_steps > 1:
        s, obj = _sweep(tau, X, s, h, 1, delay, "single")
        obj = torch.where(cand_ok, obj, inf)
        s, obj = _sweep(tau, X, _take(s, _survivors(obj, funnel_k)), h, c_steps - 1,
                        delay, None, "survivors")
        return obj, s                                 # survivors not re-masked

    s, obj = _sweep(tau, X, s, h, c_steps, delay)
    return torch.where(cand_ok, obj, inf), s


def _best(obj, s):
    """First minimum of obj (..., K) and its s (..., 2)."""
    i = torch.argmin(obj, dim=-1)
    return torch.amin(obj, dim=-1), _take(s, i[..., None])[..., 0, :]


def final_roles(sites) -> int:
    """The ``roles`` bits (`ops.kernels.lts_sweep.FINAL_ROLES`) of
    `lts_sweep.final` for the `delay_contracted` ``sites``: "final" where
    they hold the retained subset's rank keys ("final.i" and "final.j",
    which the one-band programs fuse together), "sigma2" where they hold
    it."""
    if ("final.i" in sites) != ("final.j" in sites):
        raise ValueError(f"the final ranks' keys take the lags together or not at all; "
                         f"got sites {sorted(sites)}")
    site = {"final": "final.i", "sigma2": "sigma2"}
    return sum(1 << k for k, r in enumerate(LS.FINAL_ROLES) if site[r] in sites)


def _final_passes(tau, X, obj, s, h, dof, delay=None):
    """The final subset as separate passes: the first minimum (`_best`),
    the ranks of its fit's residuals (`_site_residuals2`,
    `_rank_along_last`), the refit of the retained subset (`masked_refit`),
    sigma_tau and the uncertainty ellipse in eager arithmetic with
    ``torch.sum``; the route of rows longer than `lts_sweep.WARP_P`
    (`lts_sweep.final_route`), where `lts_sweep.final` has no kernel.
    Returns what `lts_sweep.final` returns."""
    obj_best, s_best = _best(obj, s)
    r2i, r2j = _site_residuals2(tau, X, s_best[..., None, :], delay, "final", ("i", "j"))
    retained = _rank_along_last(r2i, r2j)[..., 0, :] < h                  # (..., P)
    weight = retained.to(tau.dtype)
    s_fin = masked_refit(tau, X, weight, contract=refit_contractions(tau.shape[-1], "final"))

    # weight is 0 or 1: weight * r2 is JAX's weight * r * r, bit for bit
    r2, = _site_residuals2(tau, X, s_fin[..., None, :], delay, "sigma2", ("",))
    sigma2 = torch.sum(weight * r2[..., 0, :], dim=-1) / dof
    sig_tau = torch.sqrt(sigma2)

    # per-cell (Xs^T Xs)^-1 for the uncertainty ellipse
    Xw = weight[..., None] * X
    m00 = torch.sum(Xw[..., 0] * X[..., 0], dim=-1)
    m01 = torch.sum(Xw[..., 0] * X[..., 1], dim=-1)
    m11 = torch.sum(Xw[..., 1] * X[..., 1], dim=-1)
    det = m00 * m11 - m01 * m01
    safe = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    i00, i01, i11 = m11 / safe, -m01 / safe, m00 / safe

    sx, sy = s_fin[..., 0], s_fin[..., 1]
    smag2 = torch.clamp(sx * sx + sy * sy, min=1e-30)
    smag = torch.sqrt(smag2)
    gvx, gvy = -sx / (smag2 * smag), -sy / (smag2 * smag)
    var_v = sigma2 * (i00 * gvx * gvx + 2 * i01 * gvx * gvy + i11 * gvy * gvy)
    gtx, gty = -sy / smag2, sx / smag2
    var_t = sigma2 * (i00 * gtx * gtx + 2 * i01 * gtx * gty + i11 * gty * gty)
    return {
        "objective": obj_best,
        "s": s_fin,
        "retained": retained,
        "sig_tau": sig_tau,
        "vel_uncert": torch.sqrt(torch.clamp(var_v, min=0.0)),
        "baz_uncert": degrees(torch.sqrt(torch.clamp(var_t, min=0.0))),
    }


def lts_solve(
    tau: torch.Tensor,       # (..., P)
    X: torch.Tensor,         # (P, 2)
    cand: torch.Tensor,      # (Q, 2) integer
    Ainv: torch.Tensor,      # (Q, 2, 2)
    cand_ok: torch.Tensor,   # (Q,) bool
    h: int,
    c_steps: int = 4,
    candidate_chunk: int = 0,
    funnel_k: int = 0,
    lag: torch.Tensor = None,
    inv_fs: float = 0.0,
    delay_sites=frozenset(),
) -> Dict[str, torch.Tensor]:
    """Batched exact-enumeration LTS.

    ``candidate_chunk > 0`` sweeps the candidates in blocks of that many
    (the last padded with ``(0, 0)`` pairs, zero ``Ainv`` and ``ok =
    False``) to bound memory; each block keeps its first minimum and the
    first block holding the overall minimum wins, as in the JAX package.
    Without the funnel that equals the unchunked sweep; with it the funnel
    runs inside each block.

    ``lag`` (tau's shape, ``tau = lag * inv_fs`` rounded) with
    ``delay_sites`` (`delay_contracted`) computes those sites' residuals
    from the unrounded delay, as the JAX package's one-band programs do;
    without them every residual takes tau, as its jitted ``lts_solve``.

    The final subset (the first minimum over the candidates or blocks, the
    retained subset, its refit, sigma_tau and the uncertainty ellipse) is
    one `lts_sweep.final` at P <= `lts_sweep.WARP_P` (on the card one
    launch), else `_final_passes` (`lts_sweep.final_route`).

    Returns vel, baz, sig_tau, vel_uncert, baz_uncert, s, retained (..., P
    bool; True = equation kept) and objective.
    """
    Q = cand.shape[0]
    dof = max(h - SIGMA_TAU_DOF_SHIFT, 1)
    cand = cand.long()
    delay = _Delay(lag, inv_fs, delay_sites) if lag is not None and delay_sites else None

    if candidate_chunk and candidate_chunk < Q:
        nchunk = -(-Q // candidate_chunk)
        pad = nchunk * candidate_chunk - Q
        cand = torch.cat([cand, cand.new_zeros((pad, 2))])
        Ainv = torch.cat([Ainv, Ainv.new_zeros((pad, 2, 2))])
        cand_ok = torch.cat([cand_ok, cand_ok.new_zeros((pad,))])
        blocks = [
            _best(*_candidate_sweep(tau, X, cand[sl], Ainv[sl], cand_ok[sl],
                                    h, c_steps, funnel_k))    # chunks take tau
            for sl in (slice(k * candidate_chunk, (k + 1) * candidate_chunk)
                       for k in range(nchunk))
        ]
        obj = torch.stack([b[0] for b in blocks], dim=-1)   # (..., n)
        s = torch.stack([b[1] for b in blocks], dim=-2)     # (..., n, 2)
    else:
        obj, s = _candidate_sweep(tau, X, cand, Ainv, cand_ok, h, c_steps, funnel_k, delay)

    # final subset + refit (idempotent when converged, like the oracle)
    P = tau.shape[-1]
    if LS.final_route(P, tau.dtype) == "warp":
        roles = 0 if delay is None else final_roles(delay.sites)
        out = LS.final(tau, X, obj, s, h, dof, refit_contractions(P, "final"),
                       lag=delay.lag if roles else None,
                       inv_fs=delay.inv_fs if roles else 0.0, roles=roles)
    else:
        out = _final_passes(tau, X, obj, s, h, dof, delay)
    vel, baz = vel_baz_from_slowness(out["s"])
    return {"vel": vel, "baz": baz,
            **{k: out[k] for k in ("sig_tau", "vel_uncert", "baz_uncert", "s", "retained",
                                   "objective")}}
