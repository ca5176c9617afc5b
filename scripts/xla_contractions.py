"""Which multiply-adds of the JAX package's compiled programs XLA contracts on the CPU.

    JAX_PLATFORMS=cpu python scripts/xla_contractions.py [--elements 6 8 16]
    JAX_PLATFORMS=cpu python scripts/xla_contractions.py --ltsva [--list 6] [--jobs 4]
    JAX_PLATFORMS=cpu python scripts/xla_contractions.py --sosfilt

XLA's CPU backend compiles each fusion to LLVM IR with floating-point
contraction allowed, and LLVM's instruction selection fuses a multiply into
an add or subtract that uses it in the same basic block (when the product
has no other use) into one fused multiply-add; of two such operands, the
first.  Each mode compiles JAX programs with ``--xla_dump_to`` into a
temporary directory, reads the optimized IR and compares what it finds
with the port's tables; it exits 1 on a difference.

- By default: the JAX package's ``lts_solve`` jitted alone (exhaustive,
  with the funnel, chunked, chunked with the funnel) for arrays of the
  given numbers of elements.  It lists the refit sums (``masked_refit``'s
  m00, m01, m11, b0, b1) whose first tree level is NOT contracted, by
  site: ``loop`` (C-steps inside a fori_loop), ``single`` (a lone C-step:
  the funnel's first) and ``final`` (the refit of the retained subset),
  against `ops.lts.UNCONTRACTED`.
- ``--ltsva``: the one-band programs, where XLA also fuses the delays'
  ``lag * (1/fs)`` into the sweep.  For a one-band pipeline at each
  element count (exhaustive, funnel, chunked, chunked with the funnel) and
  the other program shapes of `SHAPES` (``api.ltsva``, ``narrow_band_loop``,
  the broadband pipeline, each ``xcorr_method``, capped candidates, the
  merged multi-array program, the sharded step, two bands), every residual
  subtraction fused with the delay's product: contracted or not, and the
  sweep's tensor it computes (`delay_fusions`: the objective's rank keys
  or tree halves, the funnel's lone C-step or survivors, the final
  subset's ranks, sigma2), against `ops.lts.delay_contracted`.  ``--list``
  prints each fusion of ``api.ltsva``'s program at those element counts.
- ``--sosfilt``: the JAX package's ``lax.scan`` SOS recurrence for 1, 2
  and 4 sections and the zero-phase pair: which products of its three
  statements are contracted, against `SOS_MODEL` (the port's
  ``csrc/sosfilt.cu`` and its plain loop).

The port imports nothing of this: it is a tool for keeping the port's
tables true to the installed jaxlib.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import subprocess
import struct
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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


def run(code, dump, flags="", threads=0):
    """Runs ``code`` in a child that dumps its compiled programs into
    ``dump``; ``threads`` > 0 pins the child to that many CPUs, which is
    the intra-op thread count XLA partitions a fusion's loops for."""
    # no persistent cache: a cached executable is not compiled, so not dumped
    if threads:
        code = f"import os\nos.sched_setaffinity(0, range({threads}))\n" + code
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=f"--xla_dump_to={dump} {flags}",
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


PROGRAM = r'''
import sys
import numpy as np
sys.path.insert(0, {root!r})
from narrow_band_least_squares_tpu import api
from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.broadband import BroadbandPipeline
from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline
from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline
from narrow_band_least_squares_tpu.oracle.ltsva import filter_and_taper
from narrow_band_least_squares_tpu.parallel import ShardedNarrowBandPipeline, make_mesh
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
st = synthetic_plane_wave(nchans={nchans}, duration_s={duration}, fs=10.0, baz_deg=120.0,
                          trace_vel_kms=0.30, f0=0.6, bandwidth=0.8, snr=15.0,
                          aperture_km=2.5, seed=11, outlier_channels=(2,))
rij = get_rij(st.latitudes, st.longitudes, st.nchans)
one = make_plan([0.3, 1.2], "linear", [30.0], 0.5, st.npts, st.fs)
fl, nb, _ = get_freqlist(0.3, 1.2, "log", 2)
two = make_plan(fl, "log", get_winlenlist("constant", nb, 30, 0, 0), 0.5, st.npts, st.fs)
{code}
'''

# The programs read for the one-band table: a one-band NarrowBandPipeline
# (its default 'mxu' correlator) under each schedule.
PIPELINE = "NarrowBandPipeline(one, rij, alpha=0.75{kw}).run_raw(st.data)"
# Other program shapes, each read at the element counts of --shape-elements:
# (name, code, schedule options, expected).  "table": the reading must equal
# the table at its P and schedule (the one-band pipelines, and the merged
# multi-array program from one merge chunk); "none": nothing fuses;
# "unmodelled": printed only, the port passes no lags there or takes the
# one-device table (ROADMAP.md Queue 3 lists them).
SHAPES = [
    ("api.ltsva", 'st.data, _ = filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, '
     '0.01); api.ltsva(st, st.latitudes, st.longitudes, 30.0, 0.5, 0.75)', {}, "table"),
    ("BroadbandPipeline", "BroadbandPipeline(0.3, 1.2, 30.0, 0.5, st.npts, st.fs, rij, "
     "alpha=0.75).run_raw(st.data)", {}, "table"),
    ("api.narrow_band_loop", 'api.narrow_band_loop(1, fl, "log", np.logspace(-2, 0.6, 20), '
     'st, "cheby1", 2, 0.01, st.latitudes, st.longitudes, [30.0, 20.0], 0.5, 0.75, 512)',
     {}, "table"),
] + [(f"xcorr_method={m!r}", PIPELINE.format(kw=f", xcorr_method={m!r}"), {}, "table")
     for m in ("pallas", "fused", "fft")] + [
    ("max_lts_candidates=5", PIPELINE.format(kw=", max_lts_candidates=5"),
     {"max_candidates": 5}, "table"),
    ("lts_funnel_k='auto'", PIPELINE.format(kw=", lts_funnel_k='auto'"),
     {"funnel_k": "auto"}, "table"),
    ("max_lts_candidates=2048", PIPELINE.format(kw=", max_lts_candidates=2048"),
     {"max_candidates": 2048}, "table"),
    ("max_lts_candidates=2048, lts_funnel_k=64", PIPELINE.format(
        kw=", max_lts_candidates=2048, lts_funnel_k=64"),
     {"max_candidates": 2048, "funnel_k": 64}, "table"),
    ("MultiArrayPipeline, one band", "MultiArrayPipeline(one, [rij, rij], alpha=0.75)"
     ".run_raw(np.stack([st.data, st.data]))", {}, "table"),
    ("MultiArrayPipeline, one band, 4 arrays in two merge chunks", "MultiArrayPipeline("
     "one, [rij] * 4, alpha=0.75).run_raw(np.stack([st.data] * 4))", {}, "none"),
    ("window_method='patches'", PIPELINE.format(kw=", window_method='patches'"), {}, "table"),
    ("window_method='gather', bucket_bands=False", PIPELINE.format(
        kw=", window_method='gather', bucket_bands=False"), {}, "table"),
    ("sharded step, one band", "p = ShardedNarrowBandPipeline(make_plan([0.3, 1.2], "
     "'linear', [30.0], 0.5, 800, st.fs), rij, make_mesh(1, 1), alpha=0.75); "
     "p.run(p.segment_stream(st.data))", {}, "table"),
    ("sharded step, one band, run_extended", "p = ShardedNarrowBandPipeline(make_plan("
     "[0.3, 1.2], 'linear', [30.0], 0.5, 800, st.fs), rij, make_mesh(1, 1), alpha=0.75); "
     "s = p.segment_stream(st.data); x = np.zeros(s.shape[:2] + (p.halo + s.shape[2],), "
     "np.float32); x[..., p.halo:] = s; p.run_extended(x)", {}, "table"),
    ("sharded step, one band, 2x1 mesh", "p = ShardedNarrowBandPipeline(make_plan([0.3, 1.2], "
     "'linear', [30.0], 0.5, 800, st.fs), rij, make_mesh(2, 1), alpha=0.75); "
     "p.run(p.segment_stream(st.data))", {}, "unmodelled"),
    ("sharded reference, one band", "p = ShardedNarrowBandPipeline(make_plan([0.3, 1.2], "
     "'linear', [30.0], 0.5, 800, st.fs), rij, make_mesh(1, 1), alpha=0.75); "
     "p.run_reference_sequential(p.segment_stream(st.data))", {}, "table"),
    ("subsample_delays=True", PIPELINE.format(kw=", subsample_delays=True"), {},
     "unmodelled"),
    ("two bands, constant windows", "NarrowBandPipeline(two, rij, alpha=0.75)"
     ".run_raw(st.data)", {}, "none"),
    ("MultiArrayPipeline, two bands", "MultiArrayPipeline(two, [rij, rij], alpha=0.75)"
     ".run_raw(np.stack([st.data, st.data]))", {}, "none"),
]
LT, GT = {"olt", "ult", "ole", "ule"}, {"ogt", "ugt", "oge", "uge"}


def parse_ir(path):
    """{function: [(value, opcode, operands, block, predicate, text)]} of an
    LLVM module; stores have no value."""
    out = {}
    for fn in re.finditer(r"^define .*?@([\w.\-]+)\(.*?^}", open(path).read(), re.S | re.M):
        block, ins = "entry", []
        for line in fn.group(0).splitlines()[1:]:
            m = re.match(r"^([\w.\-]+):", line)
            if m:
                block = m.group(1)
                continue
            m = re.match(r"\s+(%[\w.\-]+) = (?:(?:tail|fast|reassoc|contract|nnan|ninf|nsz"
                         r"|arcp|afn) )*(\w+)(?: (\w+))?", line)
            if m:
                rhs = line.split("=", 1)[1]
                ins.append((m.group(1), m.group(2), re.findall(r"%[\w.\-]+", rhs), block,
                            m.group(3), rhs))
            elif line.strip().startswith("store"):
                ins.append((None, "store", re.findall(r"%[\w.\-]+", line), block, None, line))
        out[fn.group(1)] = ins
    return out


def delay_subtractions(ins, const):
    """[(contracted, roles)] of each fsub of a kernel whose first operand is
    a product with the delay constant 1/fs: contracted when the product has
    no other use and sits in the subtraction's basic block.  Roles follow
    the residual's uses: into an order comparison ``x_j < x_i`` as its right
    side "i" (the key ranked), as its left side "j" (the keys it is counted
    against), into an add "sum"."""
    defs = {i[0]: i for i in ins if i[0]}
    users = collections.defaultdict(list)
    for i in ins:
        for o in i[2]:
            users[o].append(i)
    out = []
    for i in ins:
        d = defs.get(i[2][0]) if i[1] == "fsub" and i[2] else None
        if not d or d[1] != "fmul" or const not in d[5]:
            continue
        roles, seen, todo = set(), set(), [i[0]]
        while todo:
            v = todo.pop()
            if v in seen:
                continue
            seen.add(v)
            for u in users[v]:
                if u[1] == "fcmp":
                    if u[4] in LT | GT:
                        for k, o in enumerate(u[2][:2]):
                            if o == v:
                                roles.add("ij"[k] if u[4] in GT else "ji"[k])
                elif u[1] == "fadd":
                    roles.add("sum")
                elif u[0] is not None:
                    todo.append(u[0])
        out.append((d[3] == i[3] and len(users[d[0]]) == 1, frozenset(roles or {"sum"})))
    return out


def hlo_tables(hlo):
    """(frame id -> (function, line) of its innermost frame, computations)."""
    funcs = dict(re.findall(r"^(\d+) \"([^\"]+)\"$",
                            hlo.split("FunctionNames")[1].split("FileLocations")[0], re.M))
    sec = hlo.split("FileLocations")[1].split("StackFrames")[0]
    locs = {i: (funcs[fn], int(line)) for i, fn, line in re.findall(
        r"^(\d+) \{file_name_id=\d+ function_name_id=(\d+) line=(\d+)", sec, re.M)}
    frames = {i: locs.get(loc) for i, loc in re.findall(
        r"^(\d+) \{file_location_id=(\d+)", hlo.split("StackFrames")[1], re.M)}
    comps = {m.group(1): m.group(0) for m in
             re.finditer(r"^%([\w.\-]+) \(.*?^}", hlo, re.S | re.M)}
    comps["ENTRY"] = hlo[hlo.index("\nENTRY"):]
    return frames, comps


def _functions(text, frames):
    return {frames[f][0] for f in re.findall(r"stack_frame_id=(\d+)", text)
            if frames.get(f)}


def delay_fusions(dump, const, P, cands, funnel_k, chunked):
    """[(module, fusion, shape, site, roles, contracted)] of every residual
    subtraction fused with the delay's product in the dumped programs.

    Sites: "single" (the funnel's lone first C-step), "loop" (C-steps of a
    fori_loop), "objective", "survivors" (the funnel's objective over its
    survivors), "final" (the retained subset's ranks), "sigma2".  A
    candidate site is one whose subtraction has a candidate axis (length in
    ``cands``) before the P axis.  Roles of a rank: "i", "j"; of an
    objective's tree: "lo" and "hi", the halves of its first level (x[k] =
    v[k] + v[k + half]) that the fusion's values feed; of sigma2: "sum"."""
    src = open(os.path.join(ROOT, "narrow_band_least_squares_tpu", "ops", "lts.py")).read()
    lines = src.splitlines()
    line_of = {k: next(i + 1 for i, t in enumerate(lines) if t.strip().startswith(k))
               for k in ("r_best = tau", "r_fin = tau")}
    half = (1 << max(P - 1, 0).bit_length()) // 2
    out = []
    for h in sorted(glob.glob(os.path.join(dump, "*cpu_after_optimizations.txt"))):
        hlo = open(h).read()
        if "ops/lts.py" not in hlo:
            continue
        frames, comps = hlo_tables(hlo)
        fusion_re = (r"^\s+%([\w.\-]+) = (\(.*?\)|\S+) fusion\((.*?)\), kind=\w+, "
                     r"calls=%([\w.\-]+)")
        calls, shapes, args, where = {}, {}, {}, {}
        for cname, body in comps.items():
            for m in re.finditer(fusion_re, body, re.M):
                calls[m.group(1)], shapes[m.group(1)] = m.group(4), m.group(2)
                args[m.group(1)] = re.findall(r"%([\w.\-]+)", m.group(3))
                where[m.group(1)] = cname
        parent = {b: c for c, body in comps.items()
                  for b in re.findall(r"while\(.*?body=%([\w.\-]+)", body)}

        def depth(c):
            return 0 if c not in parent else 1 + depth(parent[c])

        def consumers(name):
            """Functions of the nearest consumers of a fusion that name a
            C-step or an objective, breadth first."""
            body, frontier, seen = comps.get(where.get(name, "ENTRY"), ""), [name], set()
            while frontier:
                found, nxt = set(), []
                for v in frontier:
                    for m in re.finditer(r"^\s+%([\w.\-]+) = [^\n]*?[(,]\s*%" + re.escape(v)
                                         + r"[,)][^\n]*", body, re.M):
                        u = m.group(1)
                        if u in seen:
                            continue
                        seen.add(u)
                        nxt.append(u)
                        text = comps.get(calls.get(u, ""), "") + m.group(0)
                        found |= _functions(text, frames) & {
                            "_trimmed_objective", "masked_refit", "_c_steps.<locals>.c_step"}
                if found:
                    return found
                frontier = nxt
            return set()

        # the objective's first tree level: which halves each fusion feeds
        halves = collections.defaultdict(set)
        for f, cname in calls.items():
            body = comps.get(cname, "")
            sl = {m.group(1): (m.group(2), int(m.group(3)), int(m.group(4))) for m in
                  re.finditer(r"%([\w.\-]+) = \S+ slice\(%([\w.\-]+)\), "
                              r"slice=\{.*\[(\d+):(\d+)\]\}", body)}
            params = {m.group(1): int(m.group(2)) for m in
                      re.finditer(r"%([\w.\-]+) = \S+ parameter\((\d+)\)", body)}
            for a, b in re.findall(r"= \S+ add\(%([\w.\-]+), %([\w.\-]+)\)", body):
                if sl.get(a, (0, 0, 0))[1:] == (0, half) and sl.get(b, (0, 0, 0))[1:] == (
                        half, 2 * half):
                    for role, (srcv, _, _) in (("lo", sl[a]), ("hi", sl[b])):
                        if srcv in params:
                            halves[args[f][params[srcv]]].add(role)
                        else:
                            halves[f].add(role)
        # every fusion's kernel: XLA emits one kernel for fusions whose
        # computations are identical, under the first one's name
        kernels, module = {}, ""
        for path in sorted(glob.glob(h[:-len("cpu_after_optimizations.txt")]
                                     + "*ir-with-opt.ll")):
            module = os.path.basename(path).split(".")[1]
            for name, ins in parse_ir(path).items():
                kernels[name] = delay_subtractions(ins, const)

        def canonical(f):
            body = re.sub(r", metadata=\{[^}]*\}", "", comps.get(calls.get(f, ""), ""))
            return re.sub(r"%[\w.\-]+", "%", body.split("\n", 1)[-1])

        twins = {}
        for f in calls:
            if f in kernels:
                twins.setdefault(canonical(f), f)
        for name in calls:
            subs = kernels.get(name, kernels.get(twins.get(canonical(name), ""), []))
            if not subs:
                continue
            body = comps.get(calls.get(name, ""), "")
            sub_ops = [([int(x) for x in re.findall(r"\d+", m.group(1))],
                        frames.get(m.group(2))) for m in re.finditer(
                r"= f32\[([\d,]*)\]\S* subtract\(.*?stack_frame_id=(\d+)", body)]
            sub_lines = {f for _, f in sub_ops if f}
            cand = [d[-2] for d, _ in sub_ops if len(d) >= 2 and d[-2] in cands]
            d = depth(where.get(name, "ENTRY"))
            for contracted, roles in subs:
                if ("lts_solve", line_of["r_fin = tau"]) in sub_lines:
                    site = "sigma2"
                elif ("lts_solve", line_of["r_best = tau"]) in sub_lines:
                    site = "final"
                elif not cand:
                    site = "final" if roles & {"i", "j"} else "sigma2"
                elif roles & {"i", "j"}:
                    # a C-step outside a loop is only the funnel's first
                    near = consumers(name) if funnel_k else {"_trimmed_objective"}
                    site = ("loop" if d > chunked else
                            "objective" if "_trimmed_objective" in near else
                            "single" if near else "?")
                else:
                    site = "objective"
                    roles = frozenset(halves.get(name) or {"lo", "hi"})
                if site == "objective" and funnel_k and funnel_k in cand:
                    site = "survivors"
                out.append((module, name, shapes.get(name, ""), site, roles, contracted))
    return out


def delay_table(code, nchans, cands, funnel_k=0, chunked=False, verbose=False,
                duration=240.0, threads=0):
    """{"site.role": set of contracted} of one program (see `delay_fusions`)
    on a stream of ``duration`` seconds, compiled for ``threads`` CPUs (0:
    all); ``verbose`` lists its fusions."""
    P = nchans * (nchans - 1) // 2
    const = f"0x{struct.unpack('<Q', struct.pack('<d', float(np.float32(1 / 10.0))))[0]:016X}"
    table = collections.defaultdict(set)
    with tempfile.TemporaryDirectory() as dump:
        # two host devices, for the sharded step on a 2x1 mesh
        run(PROGRAM.format(root=ROOT, nchans=nchans, code=code, duration=float(duration)),
            dump, "--xla_force_host_platform_device_count=2", threads)
        rows = delay_fusions(dump, const, P, cands, funnel_k, chunked)
    count = collections.Counter()
    for module, name, shape, site, roles, contracted in rows:
        for r in roles:
            table[f"{site}.{r}" if site != "sigma2" else site].add(contracted)
        count[(module, name, shape, site, tuple(sorted(roles)), contracted)] += 1
    if verbose:
        for (module, name, shape, site, roles, contracted), n in sorted(count.items()):
            print(f"    {module} {name} {shape}: {n} residual subtraction(s) of {site} "
                  f"{'/'.join(roles)}, {'contracted' if contracted else 'not contracted'}")
    return dict(table)


def schedule_of(P, max_candidates=0, funnel_k=0, candidate_chunk=0):
    """(schedule, candidate counts, survivors) of a one-band pipeline with
    these options, as the JAX package resolves them."""
    Q = P * (P - 1) // 2
    if max_candidates and Q > max_candidates:
        Q = max_candidates
    if not candidate_chunk and Q > 4096:
        candidate_chunk = 4096
    if funnel_k == "auto":
        funnel_k = max(16, -(-Q // 24))
    chunked = bool(candidate_chunk) and candidate_chunk < Q
    funnel = bool(funnel_k) and funnel_k < (candidate_chunk if chunked else Q)
    cands = {Q} | ({candidate_chunk} if chunked else set()) | ({funnel_k} if funnel else set())
    return ("chunk" if chunked else "funnel" if funnel else "exhaustive"), cands, (
        funnel_k if funnel else 0)


def check_delay(elements, shape_elements, jobs=4, duration=240.0, threads=0):
    """Reads the one-band programs (on a stream of ``duration`` seconds,
    compiled for ``threads`` CPUs) and compares them with the port's
    `ops.lts.delay_contracted`; returns the number of disagreements."""
    from narrow_band_least_squares_tpu_torch.ops import lts as TL

    todo = []
    for n in elements:
        P = n * (n - 1) // 2
        Q = P * (P - 1) // 2
        chunk = 512 if Q > 2048 else max(2, Q // 3)
        for kw in ({}, {"funnel_k": 16}, {"candidate_chunk": chunk},
                   {"candidate_chunk": chunk, "funnel_k": 16}):
            opts = "".join(f", lts_{a}={v!r}" for a, v in kw.items())
            todo.append((f"{n} elements NarrowBandPipeline{opts or ', exhaustive'}", n,
                         PIPELINE.format(kw=opts), kw, "table"))
    for n in shape_elements:
        for name, code, kw, expected in SHAPES:
            # the capped shapes past 14 elements, ltsva at each, the rest at 6 and 8
            if (n in (6, 8)) != ("2048" in name) or name == "api.ltsva":
                todo.append((f"{n} elements {name}", n, code, kw, expected))

    def read(job):
        tag, n, code, kw, expected = job
        P = n * (n - 1) // 2
        schedule, cands, k = schedule_of(P, **kw)
        got = delay_table(code, n, cands, k, schedule == "chunk", duration=duration,
                          threads=threads)
        unrounded = {key for key, v in got.items() if v == {True}}
        mixed = sorted(key for key, v in got.items() if len(v) > 1)
        expect = set(TL.delay_contracted(P, schedule)) if expected == "table" else set()
        ok = expected == "unmodelled" or (unrounded == expect and not mixed)
        note = "; not modelled (ROADMAP.md Queue 3)" if expected == "unmodelled" else ""
        return not ok, (f"{tag} (P = {P}, {schedule}): unrounded delay at {sorted(unrounded)}"
                        f"{f'; contracted in some fusions only at {mixed}' if mixed else ''}"
                        f"{note}{'' if ok else f'; the port table says {sorted(expect)}'}")

    bad = 0
    with ThreadPoolExecutor(jobs) as pool:
        for wrong, line in pool.map(read, todo):
            bad += wrong
            print(line, flush=True)
    return bad


SOSFILT = r'''
import sys
import numpy as np
sys.path.insert(0, {root!r})
import jax.numpy as jnp
from narrow_band_least_squares_tpu.ops import filters as JF
x = np.random.default_rng(0).standard_normal({shape})
sos = JF.design_sos({kind!r}, 0.3, 1.2, {order}, 0.01, 10.0)
if {zerophase}:
    JF.filter_stream_scan(jnp.asarray(x, jnp.float32), jnp.asarray(sos, jnp.float32),
                          jnp.asarray(JF.taper_window(x.shape[-1], 0.01), jnp.float32), True)
else:
    JF.sosfilt_scan(jnp.asarray(sos, jnp.float32), jnp.asarray(x, jnp.float32))
'''
# The products of the SOS recurrence's statements (the JAX package's
# ops/filters.py::sosfilt_scan) and whether XLA leaves each unrounded:
# ys = b0 y + z1, z1 = b1 y - a1 ys + z2, z2 = b2 y - a2 ys.
SOS_MODEL = {"b0*y": True, "b1*y": True, "a1*ys": False, "b2*y": True, "a2*ys": False}


def sosfilt_products(ins):
    """{product: set of contracted} of the scan body's adds and subtracts.

    LLVM contracts a product into the add or subtract that uses it when it
    has no other use and shares its basic block; of two such operands, the
    first.  A subtract of two products is ``b y - a ys`` (the source's
    order), of the z1 statement when an add (+ z2) takes it, else of z2; an
    add with one product is ``b0 y + z1``."""
    defs = {i[0]: i for i in ins if i[0]}
    users = collections.defaultdict(list)
    for i in ins:
        for o in i[2]:
            users[o].append(i)

    def product(v, blk):
        d = defs.get(v)
        return d is not None and d[1] == "fmul"

    def contractable(v, blk):
        return product(v, blk) and defs[v][3] == blk and len(users[v]) == 1

    out = collections.defaultdict(set)
    for i in ins:
        if i[1] not in ("fadd", "fsub") or len(i[2]) < 2:
            continue
        a, b = i[2][:2]
        first = a if contractable(a, i[3]) else b if contractable(b, i[3]) else None
        if i[1] == "fsub" and product(a, i[3]) and product(b, i[3]):
            k = "1" if any(u[1] == "fadd" for u in users[i[0]]) else "2"
            out[f"b{k}*y"].add(first == a)
            out[f"a{k}*ys"].add(first == b)
        elif i[1] == "fadd" and product(a, i[3]) != product(b, i[3]):
            out["b0*y"].add(first is not None)
        elif product(a, i[3]) or product(b, i[3]):
            out[f"other {i[1]}"].add(first is not None)
    return dict(out)


def check_sosfilt():
    """Reads the compiled lax.scan of 1, 2 and 4 sections and of the
    zero-phase pair; returns the number that disagree with `SOS_MODEL`."""
    bad = 0
    for tag, kw in (("1 section", dict(kind="butter", order=1, zerophase=False)),
                    ("2 sections", dict(kind="cheby1", order=2, zerophase=False)),
                    ("4 sections", dict(kind="cheby1", order=4, zerophase=False)),
                    ("zero-phase pair, 2 sections",
                     dict(kind="butter", order=2, zerophase=True))):
        shape = (4, 800) if kw["zerophase"] else (3, 500)
        got = collections.defaultdict(set)
        with tempfile.TemporaryDirectory() as dump:
            run(SOSFILT.format(root=ROOT, shape=shape, **kw), dump)
            scans = sorted(glob.glob(os.path.join(dump, "*jit_scan*ir-with-opt.ll")))
            for path in scans:
                for ins in parse_ir(path).values():
                    for k, v in sosfilt_products(ins).items():
                        got[k] |= v
        ok = got and all(got.get(k) == {v} for k, v in SOS_MODEL.items()) and set(got) == set(
            SOS_MODEL)
        bad += not ok
        print(f"lax.scan, {tag}: unrounded "
              f"{sorted(k for k, v in got.items() if True in v)}, rounded "
              f"{sorted(k for k, v in got.items() if False in v)}"
              f"{'' if ok else f'; the port computes {SOS_MODEL}'}", flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elements", type=int, nargs="*",
                    default=[3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 20])
    ap.add_argument("--ltsva", action="store_true",
                    help="read the one-band programs instead (the delay's contractions)")
    ap.add_argument("--shape-elements", type=int, nargs="*", default=[6, 8, 15, 16, 20])
    ap.add_argument("--jobs", type=int, default=4, help="programs compiled at once")
    ap.add_argument("--duration", type=float, default=240.0,
                    help="with --ltsva: seconds of the stream (240: 15 windows of 30 s)")
    ap.add_argument("--threads", type=int, default=0,
                    help="with --ltsva: CPUs each program is compiled for (0: all)")
    ap.add_argument("--sosfilt", action="store_true",
                    help="read the SOS recurrence's lax.scan instead")
    ap.add_argument("--list", type=int, nargs="*", metavar="ELEMENTS",
                    help="with --ltsva: list the fusions of api.ltsva's program")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from narrow_band_least_squares_tpu_torch.ops import lts as TL

    if args.sosfilt:
        return 1 if check_sosfilt() else 0
    if args.ltsva:
        for n in args.list or ():
            P = n * (n - 1) // 2
            print(f"api.ltsva's program at {n} elements (P = {P}):")
            schedule, cands, _ = schedule_of(P)
            delay_table(SHAPES[0][1], n, cands, 0, schedule == "chunk", verbose=True,
                        duration=args.duration, threads=args.threads)
        return 1 if check_delay(args.elements, args.shape_elements, args.jobs,
                                args.duration, args.threads) else 0
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
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
