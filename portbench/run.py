"""The benchmark of narrow_band_least_squares_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of `BENCHMARK.json` named by ``--workload``: its
configuration (``portbench/configs/``) under its traffic mix
(``portbench/traffic/``), through the port's public entry points, in a
closed loop for ``--seconds`` after a set-up that builds, loads and warms
everything the loop uses.  With ``--trace 0`` the last line of standard
output is the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (``portbench/metrics/``) read from a ``torch.profiler`` trace of
the window (its first `TRACE_SECONDS` at most), and a breakdown.  Either way the answers due in the window are
then checked against the plain float64 reference (``portbench/reference/``)
and the numbers compared are printed beside their limits, as the last
lines of standard error and under ``checks`` in the result.  A network's
segment (a configuration's ``arrays``) is one due answer an array, each
held against the reference on that array's own data and geometry.

Exits 2 without a result where CUDA is absent or has fewer cards than the
cell asks for, and 3 where the window's process holds JAX or the JAX
package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# one thread a math library: the card's host is shared, the port's host
# work is one thread of Python, and idle pools of threads only add noise
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that must not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "narrow_band_least_squares_tpu")
# the traced run profiles at most this much of its window: the Chrome
# trace of a longer one takes minutes to write and read
TRACE_SECONDS = 10.0
# every build and kernel cache, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda_jit"}


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_report() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item):
        """Returns (kept, evicted)."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return True, None
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            old, self.items[j] = self.items[j], item
            return True, old
        return False, None


def main(argv=None, device=None, options=None) -> int:
    """Run one cell.  ``device`` None means the card (as the command line
    runs it); the tests pass ``"cpu"`` to drive the rest of a run there.
    ``options`` are pipeline options set over the configuration's and the
    traffic's (the control test's lower precision)."""
    args = parse(argv)
    from portbench.harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    params = spec.traffic(cell["traffic"])
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)

    import numpy as np
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"needs {cell['chips']} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda"
        log(f"card: {card_report()}")
    on_card = device == "cuda"

    from portbench.harness.check import Tally
    from portbench.harness.traffic import Traffic
    from portbench.harness import trace as TR
    from portbench.reference.batched import Deployment, solve_segment
    from portbench.reference.geometry import get_rij

    if on_card:
        torch.zeros(1, device=device)          # the CUDA context
    phases = [("imports and context", time.perf_counter())]
    traffic = Traffic(cfg, params, args.seed)
    dep = Deployment(cfg, traffic.npts)
    # a network's segment carries every array's windows
    per_segment = sum(dep.num_compute_list) * len(traffic.arrays)
    phases.append(("input pool", time.perf_counter()))
    options = {**cfg.get("options", {}), **params.get("options", {}), **(options or {})}
    entry = spec.module("entries", params["entry"]).Entry(cfg, params, traffic, device, options)
    phases.append(("entry", time.perf_counter()))
    try:
        k = 0
        for _ in range(int(params["warmup_calls"])):
            entry(entry.stream(traffic.call(k)))
            if on_card:
                torch.cuda.synchronize()
            k += 1
            phases.append((f"warm-up call {k}", time.perf_counter()))
        t = T_START
        log("set-up: " + ", ".join(f"{name} {t1 - t0:.3f} s" for (name, t1), t0 in
                                   zip(phases, [t] + [p[1] for p in phases[:-1]])))
        route = entry.route()
        log(f"route: xcorr_method={route['xcorr_method']} "
            f"matmul_precision={route['precision']} device={device} options={options}")

        cpu_before = time.process_time()
        sample = Reservoir(int(params["check_segments"]),
                           np.random.default_rng(np.random.SeedSequence([args.seed, 1])))
        lat, ends, due, arrived, done_segments = [], [], [], set(), 0
        attempted = failed = 0
        profiler = TR.profiled(on_card) if args.trace else nullcontext()
        seconds = min(args.seconds, TRACE_SECONDS) if args.trace else args.seconds
        from torch.profiler import record_function

        with profiler as prof:
            t_begin = time.perf_counter()
            setup_s = t_begin - T_START
            with record_function(TR.WINDOW_SPAN):
                while time.perf_counter() - t_begin < seconds:
                    call = traffic.call(k)
                    st = entry.stream(call)
                    t0 = time.perf_counter()
                    try:
                        with record_function(TR.CALL_SPAN):
                            got = entry(st)
                    except Exception:
                        failed += 1
                        got = 0
                        traceback.print_exc()
                    lat.append(time.perf_counter() - t0)
                    ends.append(time.perf_counter() - t_begin)
                    attempted += 1
                    due.extend(call.segments)
                    done_segments += got
                    if got:
                        arrived.update(call.segments)
                        for g in call.segments:
                            kept, evicted = sample.offer(g)
                            if evicted is not None:
                                entry.drop(evicted)
                            if kept:
                                entry.keep(g)
                    k += 1
            t_end = time.perf_counter()
        window_s = t_end - t_begin
        cpu_s = time.process_time() - cpu_before
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        entry.free()
        written = entry.disk_bytes()
        if on_card:
            torch.cuda.empty_cache()

        # the check, once the window has closed and the program's state is
        # freed: a due answer a segment and array, on the array's own geometry
        rijs = [get_rij(lats, lons, len(lats)) for _, lats, lons in traffic.arrays]
        tally = Tally(cfg["guarantee"], traffic.fs)
        chosen = set(sample.items)
        for g in due:
            epoch = traffic.segment_epoch(g)
            names = ([f"segment {g} array {name}" for name, _, _ in traffic.arrays]
                     if traffic.network else [f"segment {g} at {epoch:.0f}"])
            if g not in chosen:
                if not entry.present(g, arrived):
                    for name in names:
                        tally.add(name, None, [])
                continue
            answers = by_array(entry.answer(g, dep), len(names), traffic.network)
            for name, rij, ans, data, context in zip(
                    names, rijs, answers, traffic.per_array(traffic.segment(g)),
                    traffic.per_array(traffic.context_of(g))):
                ref = solve_segment(dep, rij, data, epoch, context=context, device=device)
                tally.add(name, ans, ref)
    finally:
        entry.close()

    bad = forbidden_modules()
    if bad:
        log(f"the process holds {', '.join(bad)}: no result")
        return 3

    numbers = tally.numbers()
    correct = tally.correct() and failed == 0
    for note in tally.notes[:20]:
        log(note)
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    units = {m["name"]: m["unit"] for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}
    metrics = {}
    if args.trace:
        tr = prof.trace
        ctx_ns = SimpleNamespace(trace=tr, segments=done_segments, calls=attempted,
                                 window_s=window_s, route=route, cfg=cfg, params=params,
                                 spec=spec, deployment=dep, arrays=len(traffic.arrays))
        for m in spec.per_layer(args.workload):
            value = spec.module("metrics", m["name"]).read(ctx_ns)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = {
            "windows_per_s": done_segments * per_segment / window_s,
            "segment_p95_ms": percentile(lat, 95) * 1e3,
            "setup_s": setup_s,
        }
        for m in spec.end_to_end(args.workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    if args.trace:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = numbers
    log(f"window: {attempted} calls, {done_segments} segments, {window_s:.3f} s; "
        f"process cpu {cpu_s:.3f} s; set-up {setup_s:.3f} s; peak {memory_peak} bytes; "
        f"persisted {written} bytes")
    per_s = [0] * (int(window_s) + 1)
    for t in ends:
        per_s[int(t)] += 1
    log("calls a second: " + " ".join(str(n) for n in per_s))
    log("call ms: p50 {:.3f} p90 {:.3f} p95 {:.3f} p99 {:.3f} max {:.3f}".format(
        *(percentile(lat, q) * 1e3 for q in (50, 90, 95, 99, 100))))
    print(f"correct: {correct}", file=sys.stderr)
    for name, v in numbers.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def by_array(answer, n: int, network: bool) -> list:
    """An entry's answer for a segment as one answer an array: a network's
    is a list of ``n`` in the configuration's order, and None or a list of
    another length counts every array's answer missing."""
    if not network:
        return [answer]
    if isinstance(answer, list) and len(answer) == n:
        return answer
    return [None] * n


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the two nearest ranks (as
    ``numpy.percentile``)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


if __name__ == "__main__":
    sys.exit(main())
