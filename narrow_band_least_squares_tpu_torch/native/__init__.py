"""The port's native host runtime: miniSEED codec, ring buffer, TSV codec.

``ingest.cpp`` and ``textio.cpp`` are the port's own copies of the JAX
package's C++ runtime, with the same C entry points.  They are host code
(neither package runs them on an accelerator), compiled by ``g++ -O3
-std=c++17 -fPIC -shared`` into one ``build/nbls_torch_native/
libnbls_native_<hash>.so`` at the root of the checkout and loaded with
``ctypes``, whose calls release the interpreter lock.  The hash covers both
sources and the flags, so an edited source is rebuilt; each process builds
to a file of its own and renames it into place, so concurrent test workers
do not race.

Nothing is built at import: `get_lib` builds the library at first use.  A
failed build returns ``None`` (the callers keep the JAX package's graceful
fallbacks: the miniSEED reader raises ``ImportError``, the ring buffer and
the TSV writer take their Python paths) and keeps the compiler's output in
`build_error`, which those messages quote.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

SRC_DIR = Path(__file__).resolve().parent
SOURCES = (SRC_DIR / "textio.cpp", SRC_DIR / "ingest.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nbls_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None
build_seconds: Optional[float] = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's argument and result types."""
    ct = ctypes
    dp = ct.POINTER(ct.c_double)
    ip = ct.POINTER(ct.c_int64)
    up = ct.POINTER(ct.c_uint8)
    vp = ct.c_void_p
    sigs = {
        "nbls_write_tsv": (ct.c_int, [ct.c_char_p, dp, dp, dp, dp, dp, ip,
                                      ct.c_int64, ct.c_int64]),
        "nbls_count_tsv_rows": (ct.c_int64, [ct.c_char_p]),
        "nbls_read_tsv": (ct.c_int64, [ct.c_char_p, dp, dp, dp, dp, dp, dp,
                                       ct.c_int64]),
        "nbls_mseed_scan": (ct.c_int, [up, ct.c_int64, ip, ip]),
        "nbls_mseed_decode": (ct.c_int64, [up, ct.c_int64, ct.c_char_p, dp, dp,
                                           ip, dp, ct.c_int64, ct.c_int64]),
        "nbls_mseed_encode": (ct.c_int64, [ct.c_char_p, ct.c_char_p, ct.c_char_p,
                                           ct.c_char_p, ct.c_double, ct.c_double,
                                           dp, ct.c_int64, up, ct.c_int64]),
        "nbls_ring_create": (vp, [ct.c_int64, ct.c_int64]),
        "nbls_ring_destroy": (None, [vp]),
        # sample and batch arrays as raw addresses (ndarray.ctypes.data):
        # the feed path skips building a POINTER object per call
        "nbls_ring_append": (ct.c_int, [vp, ct.c_int64, ct.c_int64, vp, ct.c_int64]),
        "nbls_ring_append_batch": (ct.c_int64, [vp, vp, vp, vp, vp, ct.c_int64]),
        "nbls_ring_base": (ct.c_int64, [vp]),
        "nbls_ring_ready": (ct.c_int64, [vp, ct.c_int64]),
        "nbls_ring_read": (ct.c_int64, [vp, ct.c_int64, ct.c_int64, ct.c_double, dp]),
        "nbls_ring_release": (None, [vp, ct.c_int64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def target(sources: Sequence[Path] = SOURCES, flags: Sequence[str] = CXX_FLAGS,
           build_dir: Path = BUILD_DIR) -> Path:
    """The library's path: named by a hash of the sources and the flags."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).name.encode() + Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    return Path(build_dir) / f"libnbls_native_{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path] = SOURCES, flags: Sequence[str] = CXX_FLAGS,
          build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``sources`` into `target`'s path unless it exists; returns
    the path.  Raises ``RuntimeError`` with the compiler's output if the
    build fails (or no C++ compiler is found)."""
    out = target(sources, flags, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native runtime: no C++ compiler (g++) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"native runtime: {' '.join(cmd)} exited "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; ``None`` if it cannot be
    built or loaded (the reason is in `build_error`)."""
    global _lib, _tried, build_error, build_seconds
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        t0 = time.perf_counter()
        try:
            path = build()
            # RTLD_LOCAL (ctypes' default): the JAX package's library exports
            # the same symbol names and may live in the same process
            _lib = _configure(ctypes.CDLL(str(path)))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            build_error = str(e)
            _lib = None
        build_seconds = time.perf_counter() - t0
        return _lib
