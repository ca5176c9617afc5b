"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for ``sm_90a`` into ``build/nbls_torch_kernels/lib<name>_<hash>.so`` at the
root of the checkout and loaded with ``ctypes``; the hash covers the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt.  The sources include no
PyTorch header: such a build takes seconds, where one through
``torch.utils.cpp_extension.load`` takes minutes.  A failed build raises.

Nothing here runs at import time; importing the package builds nothing.
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
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nbls_torch_kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: List[str] | None = None) -> Dict[str, dict]:
    """Compile the named sources (default: every ``csrc/*.cu``), one ``nvcc``
    per source, all started together.  Returns per source the seconds taken
    and the compiler's resource report; raises if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    report, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": (stdout + stderr).strip()}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def sass(name: str) -> str:
    """``cuobjdump -sass`` of source ``name``'s built library (built first
    if it has no build): what the card runs."""
    so = _target(name)
    if not so.exists():
        build_all([name])
    tool = Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {so.name} exited {out.returncode}: "
                           f"{out.stderr.strip()}")
    return out.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if this source has no build."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _target(name)
            if not so.exists():
                build_all([name])
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
        return lib
