"""PyTorch port: its native host runtime (`native`) and the C++ TSV codec.

The port compiles its own copies of ``ingest.cpp`` and ``textio.cpp`` with
``g++`` into ``build/nbls_torch_native/libnbls_native_<hash>.so`` at first
use (this box has ``g++``, so these tests build and run it).  The hash
covers the sources and the flags, so an edited source builds a new
library.  The C++ writer's bytes equal the Python writer's (the port's and
the JAX package's) and the JAX package's C++ writer's on a realistic
payload; on values where the JAX package's C++ writer departs from Python's
``str`` (``1e5`` is ``1e+05`` there, ``100000.0`` in Python) the port's
keeps Python's bytes.  Both readers parse both writers' files to equal
arrays.  Both packages' libraries export the same symbol names and are
loaded into this one process side by side (``RTLD_LOCAL``).
"""

import os
import re
import shutil

import numpy as np
import pytest

from narrow_band_least_squares_tpu import native as jnative
from narrow_band_least_squares_tpu.io import textio as jtextio
from narrow_band_least_squares_tpu_torch import native
from narrow_band_least_squares_tpu_torch.io import textio as ttextio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    got = native.get_lib()
    assert got is not None, native.build_error
    return got


@pytest.fixture(scope="module")
def payload():
    """tests/test_native_textio.py's payload: 4 bands of 30-60 rows."""
    rng = np.random.default_rng(5)
    nbands, width = 4, 60
    freqlist = [0.1, 0.2, 0.4, 0.8, 1.6]
    num = [30, 40, 50, 60]
    vel = rng.uniform(0.2, 0.5, (nbands, width))
    baz = rng.uniform(0, 360, (nbands, width))
    mdccm = rng.uniform(0, 1, (nbands, width))
    t = 17884.0 + np.cumsum(rng.uniform(0.001, 0.002, (nbands, width)), axis=1)
    return vel, baz, mdccm, t, freqlist, num


# Python's str of these differs from a plain shortest-digits formatting:
# exponent thresholds, "X.0" suffixes, signed zeros, non-finite values
SPECIAL = np.array([
    0.0, -0.0, 1.0, 1e5, 1e-5, 1e-4, 1.234e-4, 1e15, 1e16, 1.5e16,
    9999999999999998.0, 123456789.0, 12345678901234567890.0, 0.1, 1 / 3,
    -2.5e-7, 5e-324, 1.7976931348623157e308, 100.0, 1e-3, np.nan, np.inf,
    -np.inf, 737000.123456789,
])


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write(mod, d, name, payload, **kw):
    vel, baz, mdccm, t, freqlist, num = payload
    return mod.write_txtfile(str(d), name, vel, baz, mdccm, t, freqlist, num, **kw)


def test_builds_into_build_dir_named_by_hash(lib):
    path = native.target()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == type(path)(ROOT) / "build" / "nbls_torch_native"
    assert re.fullmatch(r"libnbls_native_[0-9a-f]{16}\.so", path.name)
    assert path.exists() and lib._name == str(path)
    assert os.path.dirname(jnative._SO) not in lib._name
    assert native.build_error is None


def test_hash_covers_sources_and_flags(lib, tmp_path):
    """An edited source (or other flags) names another library, which is
    built beside the first; unedited copies name the same one."""
    srcs = []
    for src in native.SOURCES:
        dst = tmp_path / src.name
        shutil.copy(src, dst)
        srcs.append(dst)
    assert native.target(srcs).name == native.target().name
    assert native.target(flags=(*native.CXX_FLAGS, "-g")) != native.target()
    with open(srcs[0], "a") as f:
        f.write("\n// an edit\n")
    edited = native.target(srcs, build_dir=tmp_path / "build")
    assert edited.name != native.target().name
    assert native.build(srcs, build_dir=tmp_path / "build") == edited
    assert edited.exists()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_failed_build_keeps_the_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match=r"(?s)exited \d+\n.*error"):
        native.build([bad], build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so*"))


def test_native_bytes_equal_python_and_jax_native(lib, payload, tmp_path):
    assert jnative.get_lib(auto_build=True) is not None
    before = dict(ttextio.codec_writes)
    got = _write(ttextio, tmp_path / "t", "n", payload)
    assert ttextio.codec_writes["native"] == before["native"] + 1
    assert ttextio.codec_writes["python"] == before["python"]
    want = [
        _write(ttextio, tmp_path / "t", "p", payload, use_native=False),
        _write(jtextio, tmp_path / "j", "p", payload, use_native=False),
        _write(jtextio, tmp_path / "j", "n", payload, use_native=True),
    ]
    assert ttextio.codec_writes["python"] == before["python"] + 1
    for w in want:
        assert _bytes(got) == _bytes(w), w


def test_native_keeps_python_str_on_edge_values(lib, tmp_path):
    """Every value of SPECIAL in every column, and band edges that are
    numpy float64: the C++ bytes equal the Python writer's."""
    rng = np.random.default_rng(8)
    w = SPECIAL.size
    cols = [np.stack([SPECIAL, rng.permutation(SPECIAL)]) for _ in range(4)]
    fl = np.array([1e-5, 1e5, 1e16])
    num = [w, w - 3]
    got = ttextio.write_txtfile(str(tmp_path), "n", *cols, list(fl), num)
    want = jtextio.write_txtfile(str(tmp_path), "p", *cols, list(fl), num,
                                 use_native=False)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("freqlist", [[0, 1, 2], [0.5, 1, 2.0]],
                         ids=["int-edges", "mixed-edges"])
def test_inputs_str_formats_otherwise_take_python(lib, tmp_path, freqlist):
    """``str`` of an int is not a float's: such band edges (and non-float64
    arrays) go through the Python writer, so the bytes still match."""
    rng = np.random.default_rng(9)
    arrs = [rng.normal(size=(2, 5)) for _ in range(4)]
    before = dict(ttextio.codec_writes)
    got = ttextio.write_txtfile(str(tmp_path), "t", *arrs, freqlist, [5, 4])
    assert ttextio.codec_writes["python"] == before["python"] + 1
    want = jtextio.write_txtfile(str(tmp_path), "j", *arrs, freqlist, [5, 4],
                                 use_native=False)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("writer", ["port-native", "port-python", "jax-native"])
def test_read_txtfile_both_paths(lib, payload, tmp_path, writer):
    kw = {"use_native": writer != "port-python"}
    mod = jtextio if writer == "jax-native" else ttextio
    _write(mod, tmp_path, "r", payload, **kw)
    fast = ttextio.read_txtfile(str(tmp_path), "r", use_native=True)
    slow = ttextio.read_txtfile(str(tmp_path), "r", use_native=False)
    ref = jtextio.read_txtfile(str(tmp_path), "r", use_native=False)
    for a, b, c in zip(fast, slow, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    vel, num = payload[0], payload[5]
    for b, n in enumerate(num):
        np.testing.assert_array_equal(fast[0][b, :n], vel[b, :n])


def test_without_the_library_everything_falls_back(payload, tmp_path, monkeypatch):
    """The JAX package's contract: the writer and reader take Python, the
    ring takes NumPy, the miniSEED reader raises ImportError naming why."""
    from narrow_band_least_squares_tpu_torch.io import ingest as tingest

    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(native, "build_error", "g++ exited 1: stand-in")
    before = dict(ttextio.codec_writes)
    got = _write(ttextio, tmp_path, "t", payload)
    assert ttextio.codec_writes["python"] == before["python"] + 1
    want = _write(jtextio, tmp_path, "j", payload, use_native=False)
    assert _bytes(got) == _bytes(want)
    out = ttextio.read_txtfile(str(tmp_path), "t")
    np.testing.assert_array_equal(out[0], jtextio.read_txtfile(str(tmp_path), "j")[0])
    assert not tingest.RingBuffer(2, 10).is_native
    with pytest.raises(ImportError, match="stand-in"):
        tingest.read_mseed_records(b"\0" * 64)
