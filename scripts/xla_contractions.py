"""Which multiply-adds of the JAX package's LTS sweep XLA contracts on the CPU.

    JAX_PLATFORMS=cpu python scripts/xla_contractions.py [--elements 6 8 16]

XLA's CPU backend compiles each fusion to LLVM IR with floating-point
contraction allowed, and LLVM's instruction selection fuses a multiply into
an add or subtract that uses it in the same basic block (when the product
has no other use) into one fused multiply-add.  This script compiles the
JAX package's ``lts_solve`` (jitted alone, exhaustive, with the funnel,
chunked, chunked with the funnel) for arrays of the given numbers of
elements, with ``--xla_dump_to`` into a temporary directory, reads every
fusion's optimized IR and lists the refit sums (``masked_refit``'s m00,
m01, m11, b0, b1) whose first tree level is NOT contracted, by site:
``loop`` (C-steps inside a fori_loop), ``single`` (a lone C-step: the
funnel's first) and ``final`` (the refit of the retained subset).  It then
compares them with the port's table (`ops.lts.UNCONTRACTED`).  ``--ltsva``
also scans the one-band program of ``api.ltsva`` on the outlier stream of
the tests and lists each multiply-add of the sweep's lines that is fused
with a product from outside the sweep.

The port imports nothing of this: it is a tool for keeping the port's table
true to the installed jaxlib.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE = os.path.join(ROOT, "narrow_band_least_squares_tpu", "ops", "solve.py")
SUMS = ("m00", "m01", "m11", "b0", "b1")

CHILD = r'''
import sys
import numpy as np
sys.path.insert(0, {root!r})
import jax
from narrow_band_least_squares_tpu.ops import lts as JL
nchans, kw = {nchans}, {kw}
theta = np.linspace(0, 2 * np.pi, nchans, endpoint=False)
rij = np.stack([np.cos(theta), np.sin(theta)])
i, j = np.triu_indices(nchans, 1)
X = (rij[:, j] - rij[:, i]).T.astype(np.float32)
ci = JL.precompute_candidates(X.astype(np.float64))
h = JL.lts_h(0.75, X.shape[0])
tau = np.zeros((2, 5, X.shape[0]), np.float32)
jax.jit(lambda t, x, c, a, o: JL.lts_solve(t, x, c, a, o, h, 4, **kw)).lower(
    tau, X, ci["cand"], ci["Ainv"].astype(np.float32), ci["ok"]).compile()
'''

LTSVA = r'''
import sys
sys.path.insert(0, {root!r})
from narrow_band_least_squares_tpu import api
from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.oracle.ltsva import filter_and_taper
st = synthetic_plane_wave(nchans=6, duration_s=240.0, fs=10.0, baz_deg=120.0,
                          trace_vel_kms=0.30, f0=0.6, bandwidth=0.8, snr=15.0,
                          aperture_km=2.5, seed=11, outlier_channels=(2,))
st.data, _ = filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, 0.01)
api.ltsva(st, st.latitudes, st.longitudes, 30.0, 0.5, 0.75)
'''


def scan_ir(path):
    """{kernel: Counter((op, operand kinds))} of the fadd/fsub of a kernel
    module that take an fmul: "same" (one use, same block: contracted),
    "other-block" or "multi-use" (not contracted), "-" (no fmul)."""
    txt = open(path).read()
    out = {}
    for fn in re.finditer(r"^define .*?@([\w.\-]+)\(.*?^}", txt, re.S | re.M):
        block, defs, uses, ops = "entry", {}, collections.Counter(), []
        for line in fn.group(0).splitlines()[1:]:
            m = re.match(r"^([\w.\-]+):", line)
            if m:
                block = m.group(1)
                continue
            m = re.match(r"\s+(%[\w.\-]+) = (\w+)", line)
            rhs = line.split("=", 1)[1] if m else line
            for u in re.findall(r"%[\w.\-]+", rhs):
                uses[u] += 1
            if m:
                defs[m.group(1)] = (m.group(2), block)
                if m.group(2) in ("fadd", "fsub"):
                    ops.append((m.group(2), block, re.findall(r"%[\w.\-]+", rhs)[:2]))
        c = collections.Counter()
        for op, blk, operands in ops:
            kinds = []
            for o in operands:
                d = defs.get(o)
                if not d or d[0] != "fmul":
                    kinds.append("-")
                elif d[1] != blk:
                    kinds.append("other-block")
                else:
                    kinds.append("same" if uses[o] == 1 else "multi-use")
            if any(k != "-" for k in kinds):
                c[(op, tuple(kinds))] += 1
        out[fn.group(1)] = c
    return out


def frames(hlo):
    """{stack frame id: "file:line"} of an optimized HLO dump."""
    files = dict(re.findall(r"^(\d+) \"([^\"]+)\"$", hlo.split("FunctionNames")[0], re.M))
    sec = hlo.split("FileLocations")[1].split("StackFrames")[0]
    locs = {i: f"{files[f]}:{line}" for i, f, line in re.findall(
        r"^(\d+) \{file_name_id=(\d+) function_name_id=\d+ line=(\d+)", sec, re.M)}
    return {i: locs.get(loc, "?") for i, loc in re.findall(
        r"^(\d+) \{file_location_id=(\d+)", hlo.split("StackFrames")[1], re.M)}


def fusions(dump):
    """Per module with the sweep: (fusion, its source lines, its while depth,
    its output shape, the Counter of its IR)."""
    for h in sorted(glob.glob(os.path.join(dump, "*cpu_after_optimizations.txt"))):
        hlo = open(h).read()
        if "solve.py" not in hlo:
            continue
        prefix = h[:-len("cpu_after_optimizations.txt")]
        fr = frames(hlo)
        comps = {m.group(1): m.group(0) for m in
                 re.finditer(r"^%([\w.\-]+) \(.*?^}", hlo, re.S | re.M)}
        comps["ENTRY"] = hlo[hlo.index("\nENTRY"):]
        calls = dict(re.findall(r"%([\w.\-]+) = \S+ fusion\(.*?calls=%([\w.\-]+)", hlo))
        shapes = dict(re.findall(r"%([\w.\-]+) = (\S+) fusion\(", hlo))
        where, parent = {}, {}
        for cname, body in comps.items():
            for f in re.findall(r"^\s+%([\w.\-]+) = \S+ fusion\(", body, re.M):
                where[f] = cname
            for b in re.findall(r"while\(.*?body=%([\w.\-]+)", body):
                parent[b] = cname

        def depth(c):
            return 0 if c not in parent else 1 + depth(parent[c])

        for path in sorted(glob.glob(prefix + "*ir-with-opt.ll")):
            for name, c in scan_ir(path).items():
                body = comps.get(calls.get(name, ""), "")
                lines = {fr.get(s, "?") for s in re.findall(
                    r"(?:multiply|subtract|add)\(.*?stack_frame_id=(\d+)", body)}
                yield name, lines, depth(where.get(name, "ENTRY")), shapes.get(name, ""), c


def run(code, dump):
    # no persistent cache: a cached executable is not compiled, so not dumped
    env = dict(os.environ, XLA_FLAGS=f"--xla_dump_to={dump}", JAX_PLATFORMS="cpu",
               NBLS_COMPILATION_CACHE="off")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def sweep_table(nchans, kw):
    """{site: set of refit sums not contracted} of lts_solve's program."""
    src = open(SOLVE).read().splitlines()
    line_of = {k: f"{SOLVE}:{i + 1}" for i, t in enumerate(src) for k in SUMS
               if re.match(rf"\s+{k} = tree_sum_last\(", t)}
    chunked = bool(kw.get("candidate_chunk"))
    out = collections.defaultdict(set)
    with tempfile.TemporaryDirectory() as dump:
        run(CHILD.format(root=ROOT, nchans=nchans, kw=kw), dump)
        for name, lines, depth, shape, c in fusions(dump):
            if not any(k[1][0] in ("other-block", "multi-use") for k in c):
                continue
            for k, ln in line_of.items():
                if ln in lines:
                    dims = re.match(r"\w+\[([\d,]*)\]", shape)
                    rank = dims.group(1).count(",") + 1 if dims else 0
                    site = ("final" if rank == 3 else
                            "loop" if depth - chunked >= 1 else "single")
                    out[site].add(k)
    return dict(out)


def ltsva_report():
    """The sweep's multiply-adds in api.ltsva's program fused with a product
    from outside the sweep (the delays, ops/xcorr.py)."""
    with tempfile.TemporaryDirectory() as dump:
        run(LTSVA.format(root=ROOT), dump)
        for name, lines, depth, shape, c in fusions(dump):
            lts = sorted(ln for ln in lines if "/ops/lts.py" in ln)
            other = sorted(ln for ln in lines if "/ops/xcorr.py" in ln)
            if lts and other and c:
                print(f"  {name} {shape}: {dict(c)}; lines "
                      f"{[os.path.relpath(x, ROOT) for x in lts + other]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elements", type=int, nargs="+",
                    default=[3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 20])
    ap.add_argument("--ltsva", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from narrow_band_least_squares_tpu_torch.ops import lts as TL

    bad = 0
    for n in args.elements:
        P = n * (n - 1) // 2
        Q = P * (P - 1) // 2
        chunk = 512 if Q > 2048 else max(2, Q // 3)
        for tag, kw in (("exhaustive", {}), ("funnel", {"funnel_k": 16}),
                        ("chunk", {"candidate_chunk": chunk}),
                        ("chunk+funnel", {"candidate_chunk": chunk, "funnel_k": 16})):
            if n == 20 and tag != "chunk":
                continue                 # 17,955 candidates: one program is enough
            got = sweep_table(n, kw)
            want = {s: set(v) for s, v in TL.UNCONTRACTED.get(P, {}).items()}
            sites = {"exhaustive": ("loop", "final"), "funnel": ("loop", "single", "final"),
                     "chunk": ("loop", "final"),
                     "chunk+funnel": ("loop", "single", "final")}[tag]
            want = {s: v for s, v in want.items() if s in sites}
            ok = got == want
            bad += not ok
            print(f"{n} elements (P = {P}, Q = {Q}) {tag}: not contracted "
                  f"{ {s: sorted(v) for s, v in sorted(got.items())} }"
                  f"{'' if ok else f'; the port table says {want}'}", flush=True)
    if args.ltsva:
        print("api.ltsva's program:")
        ltsva_report()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
