"""PyTorch port: the LTS sweep (ops/lts.py) and its solve primitives
(ops/solve.py) against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and its port.
Ranks, retained sets and candidate choices must be identical; floats agree
within 1e-5 (rtol and atol), the JAX xcorr-level tolerance.  Within the
port, chunking (of the rank rows or of the candidates) must change no bit.
"""

import ctypes
import ctypes.util
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.ops import lts as JL
from narrow_band_least_squares_tpu.ops import solve as JS
from narrow_band_least_squares_tpu.utils.geometry import coarray as jcoarray
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.ops import lts as TL
from narrow_band_least_squares_tpu_torch.ops import solve as TS
from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray

TOL = 1e-5


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def geom(outlier_stream):
    """The 6-element outlier array's co-array (P = 15, Q = 105), its
    candidates, and random delays (3 bands x 7 windows)."""
    st = outlier_stream
    X, _ = coarray(get_rij(st.latitudes, st.longitudes, st.nchans))
    ci = TL.precompute_candidates(X)
    tau = (np.random.default_rng(2).standard_normal((3, 7, X.shape[0])) * 0.5
           ).astype(np.float32)
    return X, ci, tau


def _args(X, ci, lib):
    if lib == "jax":
        return (jnp.asarray(X, jnp.float32), jnp.asarray(ci["cand"]),
                jnp.asarray(ci["Ainv"], jnp.float32), jnp.asarray(ci["ok"]))
    return (torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(ci["cand"]),
            torch.as_tensor(ci["Ainv"], dtype=torch.float32),
            torch.as_tensor(ci["ok"]))


# --------------------------------------------------------------------------
# host constants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,P", [(0.75, 28), (0.5, 3), (0.1, 15), (1.0, 6), (0.7, 66)])
def test_lts_h_matches_jax(alpha, P):
    assert TL.lts_h(alpha, P) == JL.lts_h(alpha, P)


@pytest.mark.parametrize("nchans,max_candidates", [(6, 0), (12, 0), (16, 2048)])
def test_precompute_candidates_identical(nchans, max_candidates):
    """Enumeration, the seeded subsample and the float64 inverses are the
    JAX package's, value for value."""
    theta = np.linspace(0, 2 * np.pi, nchans, endpoint=False)
    rij = np.stack([np.cos(theta), np.sin(3 * theta) + 0.1 * theta])
    X, _ = coarray(rij)
    Xj, _ = jcoarray(rij)
    np.testing.assert_array_equal(X, Xj)
    a = TL.precompute_candidates(X, max_candidates=max_candidates)
    b = JL.precompute_candidates(Xj, max_candidates=max_candidates)
    Q = max_candidates or math.comb(X.shape[0], 2)
    assert a["cand"].shape == (Q, 2) and a["cand"].dtype == np.int32
    for k in ("cand", "Ainv", "ok"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_subset_normal_inverses_identical(geom):
    """Same float64 host code: keep-all, dropped rows and the degenerate
    fallback to the full geometry (reproduced as-is) agree exactly."""
    X = geom[0]
    P = X.shape[0]
    keep = np.ones((4, P), dtype=bool)
    keep[1, :4] = False
    keep[2, :] = False
    keep[2, 0] = True              # one row: falls back to the full inverse
    keep[3, 2:] = False            # two rows: < 3 rows, falls back too
    got = TS.subset_normal_inverses(X, keep)
    np.testing.assert_array_equal(got, JS.subset_normal_inverses(X, keep))
    full = np.linalg.inv(X.T @ X)
    np.testing.assert_allclose(got[0], full, rtol=1e-12)
    np.testing.assert_array_equal(got[2], full)
    np.testing.assert_array_equal(got[3], full)
    assert got[1, 0, 0] > full[0, 0] and got[1, 1, 1] > full[1, 1]


# --------------------------------------------------------------------------
# ranks and reductions
# --------------------------------------------------------------------------

def _rank_input(shape, seed):
    """Values on a coarse grid (many exact ties), with NaNs, infs, -inf
    and signed zeros (-0.0 ties with +0.0)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 5, size=shape).astype(np.float32) * 0.25
    x[rng.random(shape) < 0.1] = np.nan
    x[rng.random(shape) < 0.05] = np.inf
    x[rng.random(shape) < 0.03] = -np.inf
    x[(x == 0) & (rng.random(shape) < 0.5)] = -0.0
    return x


@pytest.mark.parametrize("shape", [(7,), (4, 28), (2, 3, 15), (5, 1), (3, 66), (2, 300)])
def test_rank_along_last_matches_jax(shape):
    x = _rank_input(shape, seed=len(shape) * 10 + shape[-1])
    got = TL._rank_along_last(torch.as_tensor(x))
    want = np.asarray(JL._rank_along_last(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    # every row is a permutation of 0..P-1, equal to a stable argsort's ranks
    order = np.argsort(np.where(np.isnan(x), np.inf, x), axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(x.shape[-1]), axis=-1)
    np.testing.assert_array_equal(got.numpy(), ranks)


def test_rank_chunking_is_bitwise(monkeypatch):
    """A byte budget of one row a chunk gives one chunk's ranks exactly."""
    x = torch.as_tensor(_rank_input((3, 11, 28), seed=5))
    whole = TL._rank_along_last(x)
    monkeypatch.setattr(TL, "RANK_CHUNK_BYTES", 1)
    np.testing.assert_array_equal(TL._rank_along_last(x).numpy(), whole.numpy())
    monkeypatch.setattr(TL, "RANK_CHUNK_BYTES", 28 * 28 * 4)   # 4-row chunks
    np.testing.assert_array_equal(TL._rank_along_last(x).numpy(), whole.numpy())


@pytest.mark.parametrize("P", [1, 5, 15, 28, 66, 120])
def test_tree_sum_last_matches_jax(P):
    """Non-power-of-two lengths: the same halving tree, bit for bit."""
    x = np.random.default_rng(P).standard_normal((9, P)).astype(np.float32)
    got = TS.tree_sum_last(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JS.tree_sum_last(jnp.asarray(x))))
    _close(got, x.astype(np.float64).sum(-1), tol=1e-5)


def test_masked_refit_matches_jax_with_singular_subsets(geom):
    """Random subsets within 1e-5 of JAX.  Singular normal matrices (no
    row kept; only collinear rows kept, whose float32 determinant is
    exactly 0) refit to exact zeros in both; all rows kept is OLS."""
    X, _, tau = geom
    w = (np.random.default_rng(3).random(tau.shape) < 0.7).astype(np.float32)
    w[0, 0] = 0.0
    got = TS.masked_refit(torch.as_tensor(tau), torch.as_tensor(X, dtype=torch.float32),
                          torch.as_tensor(w))
    want = JS.masked_refit(jnp.asarray(tau), jnp.asarray(X, jnp.float32), jnp.asarray(w))
    _close(got, want)
    assert (got[0, 0] == 0).all()
    Xc = np.array([[1.0, 2.0], [2.0, 4.0], [3.0, -1.0], [0.5, 1.0]], np.float32)
    wc = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], np.float32)
    tc = np.array([[0.3, -0.2, 0.7, 0.1], [0.3, -0.2, 0.7, 0.1]], np.float32)
    got = TS.masked_refit(torch.as_tensor(tc), torch.as_tensor(Xc), torch.as_tensor(wc))
    want = JS.masked_refit(jnp.asarray(tc), jnp.asarray(Xc), jnp.asarray(wc))
    assert (got[0] == 0).all() and (np.asarray(want)[0] == 0).all()
    _close(got, want)
    full = TS.masked_refit(torch.as_tensor(tau[1]), torch.as_tensor(X, dtype=torch.float32),
                           torch.ones(tau.shape[1:]))
    pinv = np.linalg.inv(X.T @ X) @ X.T
    _close(full, tau[1].astype(np.float64) @ pinv.T)


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

def test_funnel_survivors_on_tied_objectives():
    """Stable ascending order = ``lax.top_k(-obj)``'s: among equal
    objectives (and among infs) the lower index survives first."""
    rng = np.random.default_rng(0)
    obj = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    obj[:, ::7] = np.inf
    obj[3] = 1.0                                      # one row all tied
    for k in (1, 5, 16, 40):
        got = TL._survivors(torch.as_tensor(obj), k).numpy()
        _, want = jax.lax.top_k(-jnp.asarray(obj), k)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"k={k}")
    np.testing.assert_array_equal(TL._survivors(torch.as_tensor(obj[3]), 5).numpy(),
                                  np.arange(5))


@pytest.mark.parametrize("funnel_k", [0, 8])
def test_candidate_sweep_matches_jax(geom, funnel_k):
    X, ci, tau = geom
    h = TL.lts_h(0.75, X.shape[0])
    obj_t, s_t = TL._candidate_sweep(torch.as_tensor(tau), *_args(X, ci, "torch"),
                                     h, 4, funnel_k)
    obj_j, s_j = JL._candidate_sweep(jnp.asarray(tau), *_args(X, ci, "jax"),
                                     h, 4, funnel_k)
    K = funnel_k or len(ci["cand"])
    assert tuple(obj_t.shape) == tau.shape[:-1] + (K,)
    _close(obj_t, obj_j, msg="objective")
    _close(s_t, s_j, msg="s")
    np.testing.assert_array_equal(torch.argmin(obj_t, -1).numpy(),
                                  np.asarray(jnp.argmin(obj_j, -1)))


def test_candidate_sweep_masks_degenerate_candidates(geom):
    """A candidate whose 2x2 system is singular (ok = False) never wins."""
    X, ci, tau = geom
    ok = ci["ok"].copy()
    ok[::3] = False
    ci2 = dict(ci, ok=ok)
    h = TL.lts_h(0.75, X.shape[0])
    obj, _ = TL._candidate_sweep(torch.as_tensor(tau), *_args(X, ci2, "torch"), h, 4)
    assert torch.isinf(obj[..., ::3]).all()
    obj_j, _ = JL._candidate_sweep(jnp.asarray(tau), *_args(X, ci2, "jax"), h, 4)
    _close(obj, obj_j)


LTS_CASES = [
    ("exhaustive", {}),
    ("chunk17", {"candidate_chunk": 17}),
    ("funnel16", {"funnel_k": 16}),
    ("funnel16-chunk40", {"funnel_k": 16, "candidate_chunk": 40}),
]


@pytest.mark.parametrize("kw", [c[1] for c in LTS_CASES], ids=[c[0] for c in LTS_CASES])
def test_lts_solve_matches_jax(geom, kw):
    X, ci, tau = geom
    h = TL.lts_h(0.75, X.shape[0])
    got = TL.lts_solve(torch.as_tensor(tau), *_args(X, ci, "torch"), h, c_steps=4, **kw)
    want = JL.lts_solve(jnp.asarray(tau), *_args(X, ci, "jax"), h, c_steps=4, **kw)
    np.testing.assert_array_equal(got["retained"].numpy(), np.asarray(want["retained"]))
    assert (got["retained"].sum(-1) == h).all()
    for k in ("vel", "baz", "sig_tau", "vel_uncert", "baz_uncert", "s", "objective"):
        _close(got[k], want[k], msg=k)


def test_lts_solve_chunked_equals_unchunked(geom):
    """Without the funnel, candidate blocks (ragged last block included)
    equal one block bit for bit."""
    X, ci, tau = geom
    h = TL.lts_h(0.75, X.shape[0])
    args = (torch.as_tensor(tau),) + _args(X, ci, "torch")
    full = TL.lts_solve(*args, h)
    for chunk in (17, 50, 104):
        got = TL.lts_solve(*args, h, candidate_chunk=chunk)
        for k, v in full.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{k} chunk {chunk}")


def test_lts_solve_batch_shape_is_bitwise(geom):
    """One window solved alone equals the same window inside the batch:
    nothing in the sweep depends on the batch shape."""
    X, ci, tau = geom
    h = TL.lts_h(0.75, X.shape[0])
    args = _args(X, ci, "torch")
    full = TL.lts_solve(torch.as_tensor(tau), *args, h, funnel_k=16)
    one = TL.lts_solve(torch.as_tensor(tau[2, 5]), *args, h, funnel_k=16)
    for k, v in one.items():
        torch.testing.assert_close(v, full[k][2, 5], rtol=0, atol=0, msg=k)


# --------------------------------------------------------------------------
# the contracted arithmetic (ops/kernels/lts_sweep.py) against jax.jit
# --------------------------------------------------------------------------

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.fmaf.argtypes = [ctypes.c_float] * 3
_LIBM.fmaf.restype = ctypes.c_float


def _fmaf(a, b, c):
    """libm's fmaf, one triple at a time."""
    return np.array([_LIBM.fmaf(x, y, z) for x, y, z in zip(a.tolist(), b.tolist(),
                                                              c.tolist())], np.float32)


def _bits(x):
    """float32 bits, every NaN as one pattern."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), x).view(np.int32)


_F = np.float32
FMA_HARD = {
    # a * b + c exactly halfway between two float32 values plus less than a
    # float64 ulp: rounding through float64 lands on the midpoint
    "midpoints": [(_F(1 + 2**-23), _F(64 * (1 - 2**-23)), _F(2**30 + 128)),
                  (_F(1 + 2**-23), _F(-64 * (1 - 2**-23)), _F(-(2**30 + 128))),
                  (_F(1 + 2**-23), _F(64 * (1 - 2**-23)), _F(2**30)),
                  (_F(1 - 2**-24), _F(1 - 2**-24), _F(-1.0))],
    "cancellation": [(_F(1 + 2**-12), _F(1 + 2**-12), _F(-(1 + 2**-11))),
                     (_F(3.0), _F(1 / 3), _F(-1.0)), (_F(2.0), _F(3.0), _F(-6.0)),
                     (_F(-2.0), _F(3.0), _F(6.0)), (_F(0.0), _F(-1.0), _F(-0.0)),
                     (_F(-0.0), _F(1.0), _F(-0.0)), (_F(3e38), _F(2.0), _F(-3e38))],
    "subnormals": [(_F(1e-30), _F(1e-15), _F(0.0)), (_F(1e-20), _F(1e-20), _F(1e-45)),
                   (_F(1.5), _F(2**-149), _F(0.0)), (_F(2**-126), _F(0.75), _F(-2**-149)),
                   (_F(2**-75), _F(2**-75), _F(-2**-149))],
    "inf-nan": [(_F(np.inf), _F(0.0), _F(1.0)), (_F(np.inf), _F(1.0), _F(-np.inf)),
                (_F(np.nan), _F(1.0), _F(1.0)), (_F(1.0), _F(1.0), _F(np.inf)),
                (_F(3e38), _F(3e38), _F(-np.inf)), (_F(-3e38), _F(10.0), _F(0.0))],
}


@pytest.mark.parametrize("group", list(FMA_HARD))
def test_exact_fma_on_hard_cases(group):
    """The plain versions' fused multiply-add equals libm's fmaf, where a
    float64 sum rounded to float32 would not (the midpoints)."""
    a, b, c = (np.array(v, np.float32) for v in zip(*FMA_HARD[group]))
    got = LS.fma(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_fmaf(a, b, c)))
    if group == "midpoints":
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (_bits(twice) != _bits(_fmaf(a, b, c))).sum() >= 2


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20])
def test_exact_fma_on_random_triples(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 30)
    n = 20000
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n)) * scale).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(n) * 1e-6)).astype(np.float32)
    c[::2] = (rng.standard_normal(n // 2) * np.exp(rng.uniform(-40, 40, n // 2))
              * scale).astype(np.float32)
    got = LS.fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_fmaf(a, b, c)))


def test_narrow_dtype_contracts_nothing():
    """bfloat16 and float16 round the multiply and the add each to the dtype,
    as PyTorch does and as the port did before it contracted float32."""
    rng = np.random.default_rng(9)
    for dt in (torch.bfloat16, torch.float16):
        a, b, c = (torch.as_tensor(rng.standard_normal(4000), dtype=torch.float32).to(dt)
                   for _ in range(3))
        got = LS.fma(a, b, c)
        assert got.dtype == dt and torch.equal(got, (a * b).to(dt) + c)
        assert not torch.equal(got, LS.fma(a.float(), b.float(), c.float()).to(dt))


def _geometry(nchans, seed):
    """A random co-array of ``nchans`` elements, its candidates (1,024 at
    most) and seeded plane-wave delays with a fifth of the equations hit by
    outliers (3 bands x 5 windows)."""
    theta = np.linspace(0, 2 * np.pi, nchans, endpoint=False)
    rng = np.random.default_rng(seed)
    rij = np.stack([np.cos(theta) * rng.uniform(0.5, 1.5, nchans),
                    np.sin(theta) * rng.uniform(0.5, 1.5, nchans)])
    X, _ = coarray(rij)
    P = X.shape[0]
    ci = TL.precompute_candidates(X, max_candidates=1024)
    s_true = rng.standard_normal((3, 5, 2))
    tau = X @ s_true[..., None] + 0.05 * rng.standard_normal((3, 5, P, 1))
    tau = tau[..., 0].astype(np.float32)
    tau[..., :P // 5] += rng.standard_normal((3, 5, P // 5)).astype(np.float32)
    return X, ci, tau


GEOMETRIES = {"P15": 6, "P28": 8, "P120": 16}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_residuals2_bitwise_jitted_jax(name):
    X, ci, tau = _geometry(GEOMETRIES[name], 1)
    s = np.random.default_rng(2).standard_normal(tau.shape[:-1] + (40, 2)).astype(np.float32)
    got = TL._residuals2(*(torch.as_tensor(v) for v in (tau, X.astype(np.float32), s)))
    want = jax.jit(JL._residuals2)(tau, X.astype(np.float32), s)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_elemental_solve_bitwise_jitted_jax(name):
    """The JAX package's elemental solve (``_candidate_sweep``'s einsum,
    jitted) against `lts_sweep.elemental`."""
    X, ci, tau = _geometry(GEOMETRIES[name], 3)
    A = ci["Ainv"].astype(np.float32)
    got = LS.elemental(torch.as_tensor(tau), torch.as_tensor(ci["cand"]), torch.as_tensor(A))
    want = jax.jit(lambda t, c, a: jnp.einsum("qij,...qj->...qi", a, t[..., c]))(
        tau, ci["cand"], A)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_masked_refit_bitwise_jitted_jax(name):
    """``masked_refit`` jitted alone, with singular subsets (no row kept: zeros;
    one row kept, whose contracted determinant is the rounding error of
    m01 * m01, not 0) and all rows kept.  At P = 120 that program leaves
    m01's first tree level uncontracted, as the sweep's C-step loop does."""
    X, _, tau = _geometry(GEOMETRIES[name], 4)
    P = X.shape[0]
    w = (np.random.default_rng(5).random(tau.shape) < 0.7).astype(np.float32)
    w[0, 0] = 0.0
    w[0, 1] = 0.0
    w[0, 1, 3] = 1.0
    w[1, 2] = 1.0
    Xf = X.astype(np.float32)
    contract = TL.refit_contractions(P, "loop") if P == 120 else LS.ALL_CONTRACTED
    got = TS.masked_refit(torch.as_tensor(tau), torch.as_tensor(Xf), torch.as_tensor(w),
                          contract=contract).numpy()
    want = np.asarray(jax.jit(JS.masked_refit)(tau, Xf, w))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got[0, 0] == 0).all()


@pytest.mark.parametrize("funnel_k", [0, 8])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_candidate_sweep_bitwise_jitted_jax(name, funnel_k):
    X, ci, tau = _geometry(GEOMETRIES[name], 6)
    P = X.shape[0]
    h = TL.lts_h(0.75, P)
    args = (X.astype(np.float32), ci["cand"], ci["Ainv"].astype(np.float32), ci["ok"])
    obj_t, s_t = TL._candidate_sweep(torch.as_tensor(tau),
                                     *(torch.as_tensor(a) for a in args), h, 4, funnel_k)
    obj_j, s_j = jax.jit(lambda t, *a: JL._candidate_sweep(t, *a, h, 4, funnel_k))(
        tau, *args)
    np.testing.assert_array_equal(_bits(obj_t.numpy()), _bits(obj_j))
    np.testing.assert_array_equal(_bits(s_t.numpy()), _bits(s_j))


BITWISE_SOLVES = [
    ("P28-exhaustive", 8, {}),
    ("P28-chunk100", 8, {"candidate_chunk": 100}),
    ("P28-funnel16", 8, {"funnel_k": 16}),
    ("P28-funnel16-chunk100", 8, {"funnel_k": 16, "candidate_chunk": 100}),
    ("P15-funnel8", 6, {"funnel_k": 8}),
    ("P120-chunk512", 16, {"candidate_chunk": 512}),
    ("P120-chunk512-funnel64", 16, {"candidate_chunk": 512, "funnel_k": 64}),
]


@pytest.mark.parametrize("nchans,kw", [c[1:] for c in BITWISE_SOLVES],
                         ids=[c[0] for c in BITWISE_SOLVES])
def test_lts_solve_bitwise_jitted_jax(nchans, kw):
    """The port's sweep computes the float32 bits of the JAX package's
    jitted ``lts_solve``: objective, s and the retained sets are equal bit for
    bit, funnel and candidate chunks included (`refit_contractions` holds the
    sites XLA leaves uncontracted at P = 28 and P = 120)."""
    X, ci, tau = _geometry(nchans, 7)
    h = TL.lts_h(0.75, X.shape[0])
    args = (X.astype(np.float32), ci["cand"], ci["Ainv"].astype(np.float32), ci["ok"])
    got = TL.lts_solve(torch.as_tensor(tau), *(torch.as_tensor(a) for a in args), h, 4, **kw)
    want = jax.jit(lambda t, *a: JL.lts_solve(t, *a, h, 4, **kw))(tau, *args)
    np.testing.assert_array_equal(got["retained"].numpy(), np.asarray(want["retained"]))
    for k in ("objective", "s"):
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]), err_msg=k)


def test_refit_contractions_table():
    """Every first level contracted except where the table says; the CPU
    wrappers launch nothing."""
    assert TL.refit_contractions(15, "final") == LS.ALL_CONTRACTED == 0b11111
    assert TL.refit_contractions(28, "loop") == LS.ALL_CONTRACTED
    assert TL.refit_contractions(28, "final") == TL.refit_contractions(28, "single") == 0b00111
    assert TL.refit_contractions(120, "loop") == 0b11101
    assert TL.refit_contractions(120, "final") == LS.ALL_CONTRACTED
    before = (LS.launches_residuals2, LS.launches_refit, LS.launches_elemental)
    X, ci, tau = _geometry(6, 8)
    TL.lts_solve(torch.as_tensor(tau), *_args(X, ci, "torch"), TL.lts_h(0.75, X.shape[0]))
    assert (LS.launches_residuals2, LS.launches_refit, LS.launches_elemental) == before


# --------------------------------------------------------------------------
# the one-band programs: the delays' product contracted into the residual
# --------------------------------------------------------------------------

def _jax_residuals2_lag(lag, X, s):
    """The final subset's residuals of the JAX package's ``lts_solve`` on
    delays made in the same program (``(k + lag_min) / fs`` in its one-band
    pipelines, at fs = 10)."""
    r = lag / 10.0 - jnp.einsum("pk,...k->...p", X, s)
    return r * r


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_residuals2_lag_bitwise_jitted_jax(name):
    """`lts_sweep.residuals2_lag` against ``jax.jit`` of a function that
    computes the delays and the residuals in one program: XLA fuses the
    delays' ``lag * (1/fs)`` into the residual's fusion and contracts it
    there (every residual subtraction of that fusion is a fused
    multiply-add, as ``scripts/xla_contractions.py``'s reader shows for
    jaxlib 0.9.0).  The rounded delays give other bits on a share of the
    residuals, so the check sees the contraction; no launch is counted on
    the CPU."""
    X, _, tau = _geometry(GEOMETRIES[name], 1)
    lag = np.round(tau * 40).astype(np.float32)           # samples at fs = 10
    s = (np.random.default_rng(2).standard_normal(tau.shape[:-1] + (2,)) * 0.1
         ).astype(np.float32)
    Xf = X.astype(np.float32)
    want = _bits(jax.jit(_jax_residuals2_lag)(lag, Xf, s))
    before = LS.launches_residuals2_lag
    lt, Xt, st = (torch.as_tensor(v) for v in (lag, Xf, s))
    got = LS.residuals2_lag(lt, 0.1, Xt, st[..., None, :])[..., 0, :]
    assert LS.launches_residuals2_lag == before
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    rounded = LS.residuals2(lt * 0.1, Xt, st[..., None, :])[..., 0, :]
    assert (_bits(rounded.numpy()) != want).mean() > 0.05


def test_residuals2_lag_takes_float32():
    """Only float32 programs contract: a narrower dtype is refused (the
    pipelines pass lags in float32 only)."""
    X, _, tau = _geometry(6, 1)
    lag = torch.as_tensor(np.round(tau * 40)).to(torch.bfloat16)
    s = torch.zeros(tau.shape[:-1] + (4, 2), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        LS.residuals2_lag(lag, 0.1, torch.as_tensor(X, dtype=torch.bfloat16), s)


@pytest.mark.parametrize("P", [3, 15, 28])
def test_rank_against_other_keys(P):
    """The two-key rank: x_i ranked against the values of ``against`` (ties
    by index, the diagonal included), as a brute-force count."""
    rng = np.random.default_rng(P)
    x = rng.integers(0, 6, (4, P)).astype(np.float32)
    y = x + rng.choice([-1.0, 0.0, 1.0], x.shape).astype(np.float32)
    got = TL._rank_along_last(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    i, j = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    want = ((y[:, None, :] < x[:, :, None]) | ((y[:, None, :] == x[:, :, None]) & (j < i))
            ).sum(-1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TL._rank_along_last(torch.as_tensor(x), torch.as_tensor(x)),
                                  TL._rank_along_last(torch.as_tensor(x)))


def test_delay_contracted_table():
    """The one-band table: the final subset and sigma2 always, the
    objective's roles by P unchunked, the funnel's survivors and lone step
    beside them; a P not read takes the largest read P below it."""
    final = {"final.i", "final.j", "sigma2"}
    assert TL.delay_contracted(120, "chunk") == final
    assert TL.delay_contracted(15, "exhaustive") == final | {"objective.i"}
    assert TL.delay_contracted(28, "exhaustive") == final | {
        "objective.i", "objective.lo", "objective.hi"}
    assert TL.delay_contracted(36, "funnel") == final | {
        "objective.i", "objective.j", "objective.lo", "survivors.i", "survivors.j",
        "survivors.lo", "single.i", "single.j"}
    assert TL.delay_contracted(100, "exhaustive") == TL.delay_contracted(91, "exhaustive")
    assert TL.lts_schedule(105, 0, 0, 4) == "exhaustive"
    assert TL.lts_schedule(105, 17, 16, 4) == TL.lts_schedule(7140, 4096, 0, 4) == "chunk"
    assert TL.lts_schedule(105, 0, 16, 4) == "funnel"
    assert TL.lts_schedule(105, 0, 16, 1) == TL.lts_schedule(15, 0, 16, 4) == "exhaustive"


def test_lts_solve_lag_needs_sites(geom):
    """Lags without sites (or sites without lags) change no bit: the jitted
    solve's model."""
    X, ci, tau = geom
    args = _args(X, ci, "torch")
    h = TL.lts_h(0.75, X.shape[0])
    lag = torch.as_tensor(np.round(tau * 10).astype(np.float32))
    t = lag * 0.1
    plain = TL.lts_solve(t, *args, h)
    for kw in ({"lag": lag, "inv_fs": 0.1}, {"delay_sites": TL.delay_contracted(15, "exhaustive")}):
        got = TL.lts_solve(t, *args, h, **kw)
        for k, v in plain.items():
            assert torch.equal(got[k], v), k


def test_sigma2_takes_the_lags(geom):
    """With "sigma2" a site, sigma_tau sums the retained subset's residuals
    on the lags (`lts_sweep.residuals2_lag`) as a fixed tree
    (`lts_sweep.tree_sum_last`, the final subset's sum on every device);
    they differ from the rounded delays' on these windows."""
    X, ci, tau = geom
    args = _args(X, ci, "torch")
    h = TL.lts_h(0.75, X.shape[0])
    lag = torch.as_tensor(np.round(tau * 10).astype(np.float32))
    t = lag * 0.1
    out = TL.lts_solve(t, *args, h, lag=lag, inv_fs=0.1, delay_sites={"sigma2"})
    r2 = LS.residuals2_lag(lag, 0.1, args[0], out["s"][..., None, :])[..., 0, :]
    w = out["retained"].to(torch.float32)
    assert torch.equal(out["sig_tau"], torch.sqrt(LS.tree_sum_last(w * r2) / (h - 2)))
    assert not torch.equal(out["sig_tau"], TL.lts_solve(t, *args, h)["sig_tau"])
