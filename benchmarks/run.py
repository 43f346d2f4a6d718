"""Run one cell of BENCHMARK.json once and print one JSON line.

    python3 -m benchmarks.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds the program, ``zignal_tpu_torch``.
Everything is found by name: the cell in ``BENCHMARK.json``, its traffic
mix in ``traffic/<traffic>.json``, the configuration in
``configs/<config>.json`` with its adapter ``configs/<config>.py``, the
way its input is fed in ``sources/<residency>.py``, and each metric's
reader in ``metrics/<metric>.py``.

A run: set-up (the program imported, its kernels built or loaded from the
checkout, a ring of distinct inputs made from the seed, the cell's own
shapes warmed up for ``WARMUP_S``); a closed loop that keeps
``in_flight`` requests queued for ``--seconds``; with ``--trace 1`` a
traced stretch of requests (``trace.py``); then the check of a sample of
the window's outputs, drawn from the seed, against the plain reference.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones. A run without a CUDA card exits
non-zero and prints no result; ``--device cpu`` (toy sizes, for the
tests) is never passed by the manifest's command.
"""

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the bytecode of every module a run imports, torch's among them, kept
    # in the checkout: an installation that ships none and forbids writing
    # it (PYTHONDONTWRITEBYTECODE) otherwise compiles torch in every run
    sys.pycache_prefix = str(Path(__file__).resolve().parent / "_pycache")
    sys.dont_write_bytecode = False

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmarks"
PROGRAM = "zignal_tpu_torch"
# top-level modules that may not be loaded in a run: the JAX package the
# program was ported from, and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "zignal_tpu")
SPANS = ("launch", "wait")
WARMUP_S = 0.5            # after one request that builds and plans
TRACE_S = 1.0             # the traced stretch, at most TRACE_REQUESTS
TRACE_REQUESTS = 2000
KEEP = 16                 # outputs sampled: KEEP to 2 KEEP, and the last
TOY_BATCH, TOY_RING = 2, 3


class Refused(Exception):
    """A run that cannot give a result: exit 2, no line."""


def load(kind: str, name: str):
    """The module ``benchmarks/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"no {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spans:
    """Host-clock time spent in each named span, summed, and how often it
    opened; with ``log`` every span's (name, start ns, end ns) too."""

    def __init__(self, log: bool = False):
        self.total = dict.fromkeys(SPANS, 0)
        self.count = dict.fromkeys(SPANS, 0)
        self.log = [] if log else None

    def __call__(self, name: str):
        return _Span(self, name)

    def mean_s(self, name: str):
        n = self.count.get(name, 0)
        return self.total[name] / n / 1e9 if n else None


class _Span:
    __slots__ = ("spans", "name", "t0")

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        spans = self.spans
        spans.total[self.name] += t1 - self.t0
        spans.count[self.name] += 1
        if spans.log is not None:
            spans.log.append((self.name, self.t0, t1))


class CudaStamps:
    """Each request's issue and completion on the card's clock: the issue
    event goes on an idle side stream, so the card stamps it as the host
    issues the request; the completion event follows the request's work.
    Their difference is the request's latency with its wait in the queue,
    read to a microsecond (the host clock is not that fine)."""

    def __init__(self, torch, pairs: int):
        self.main = torch.cuda.current_stream()
        self.side = torch.cuda.Stream()
        ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
        self.pairs = [(ev(), ev()) for _ in range(pairs)]

    def start(self, k):
        self.pairs[k % len(self.pairs)][0].record(self.side)

    def end(self, k):
        self.pairs[k % len(self.pairs)][1].record(self.main)

    def wait(self, k):
        self.pairs[k % len(self.pairs)][1].synchronize()

    def ms(self, k) -> float:
        s, e = self.pairs[k % len(self.pairs)]
        return s.elapsed_time(e)


class HostStamps:
    """The same on the host clock, for CPU runs, which are synchronous."""

    def __init__(self, pairs: int):
        self.t = [[0.0, 0.0] for _ in range(pairs)]

    def start(self, k):
        self.t[k % len(self.t)][0] = time.perf_counter()

    def end(self, k):
        self.t[k % len(self.t)][1] = time.perf_counter()

    def wait(self, k):
        pass

    def ms(self, k) -> float:
        s, e = self.t[k % len(self.t)]
        return 1e3 * (e - s)


class Sample:
    """Outputs kept for the check: those of requests ``k`` with ``k =
    phase (mod stride)``, the stride doubling whenever ``2 * keep`` are
    held, so the sample spreads over the whole window whatever its
    length; and the last request's."""

    def __init__(self, keep: int, phase: int):
        self.keep, self.phase, self.stride = keep, phase, 1
        self.kept, self.last = {}, None

    def offer(self, k: int, out) -> None:
        self.last = (k, out)
        if (k - self.phase) % self.stride:
            return
        self.kept[k] = out
        if len(self.kept) >= 2 * self.keep:
            self.stride *= 2
            self.kept = {j: o for j, o in self.kept.items()
                         if (j - self.phase) % self.stride == 0}

    def items(self) -> list:
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        return sorted(kept.items(), key=lambda kv: kv[0])


def closed_loop(issue, in_flight: int, seconds: float, stamps, spans,
                done, max_requests=None):
    """Issue requests back to back with at most ``in_flight`` queued
    until ``seconds`` have passed, then wait for the rest; ``done(k, out,
    ms)`` sees each as it completes. Returns (requests, seconds from the
    first issue to the last completion)."""
    pending = deque()

    def finish():
        k, out = pending.popleft()
        with spans("wait"):
            stamps.wait(k)
        done(k, out, stamps.ms(k))

    t0 = time.perf_counter()
    stop, k = t0 + seconds, 0
    while time.perf_counter() < stop and (max_requests is None
                                          or k < max_requests):
        stamps.start(k)
        out = issue(k, spans)
        stamps.end(k)
        pending.append((k, out))
        k += 1
        if len(pending) >= in_flight:
            finish()
    while pending:
        finish()
    return k, time.perf_counter() - t0


class Record:
    """What a run measured, as the metric readers see it."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmarks.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: toy sizes on the program's plain path, for "
                        "the tests only")
    return p.parse_args(argv)


def cell_parts(manifest: dict, workload: str):
    """(cell, traffic, config, adapter, source module) of ``workload``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    traffic = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    if traffic["config"] != cell["config"]:
        raise Refused(f"traffic {cell['traffic']} is for config "
                      f"{traffic['config']}, the cell for {cell['config']}")
    cfg = read_json(BENCH / "configs" / f"{cell['config']}.json")
    return (cell, traffic, cfg, load("configs", cell["config"]),
            load("sources", traffic["residency"]))


def require_program() -> None:
    """The program must come from this checkout, not from anywhere else
    on the path."""
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or spec.origin is None:
        raise Refused(f"{PROGRAM} is not in this checkout")
    if ROOT not in Path(spec.origin).resolve().parents:
        raise Refused(f"{PROGRAM} comes from {spec.origin}, outside {ROOT}")


def metrics_of(manifest: dict, key: str, cell: str) -> list:
    return [m for m in manifest[key] if cell in m.get("workloads", [cell])]


def measure(args, manifest, torch, control: bool = False):
    """One run of the cell: (the result line's dict, the Record). With
    ``control`` the reference in the precision below the configuration's
    takes the program's place (``calibrate.py``; never in a benchmark
    run)."""
    cell, traffic, cfg, adapter, source = cell_parts(manifest, args.workload)
    cuda = args.device == "cuda"
    batch, ring_n = traffic["batch"], traffic["ring"]
    if not cuda:
        cfg = dict(cfg, **cfg["toy"])
        batch, ring_n = min(batch, TOY_BATCH), min(ring_n, TOY_RING)
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    seed = args.seed % 2 ** 63
    in_flight = traffic["in_flight"]
    phases = {"torch": time.perf_counter() - _T0}
    importlib.import_module(PROGRAM)
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
    phases["program and context"] = time.perf_counter() - _T0
    ring = source.Ring(adapter.input_shape(cfg, batch), ring_n, seed, device)
    phases["inputs"] = time.perf_counter() - _T0

    def issue(k, spans):
        if control:
            return adapter.reference(cfg, ring.on_device(k), True)
        return ring.issue(adapter, cfg, k, spans)

    stamps = (CudaStamps(torch, in_flight + 1) if cuda
              else HostStamps(in_flight + 1))
    quiet = Spans()
    issue(0, quiet)  # builds or loads the kernels, plans the shapes
    if cuda:
        torch.cuda.synchronize()
    phases["first request"] = time.perf_counter() - _T0
    warm = Sample(KEEP, 0)  # fills the allocator's cache as the window will
    closed_loop(issue, in_flight, WARMUP_S, stamps, quiet,
                lambda k, out, ms: warm.offer(k, out))
    del warm

    rng = np.random.default_rng([seed, 1])
    sample = Sample(KEEP, int(rng.integers(1 << 20)))
    latency, spans = [], Spans()
    launches0 = adapter.launches()
    setup_s = time.perf_counter() - _T0
    phases["warm-up"] = setup_s

    def done(k, out, ms):
        latency.append(ms)
        sample.offer(k, out)

    requests, window_s = closed_loop(issue, in_flight, args.seconds, stamps,
                                     spans, done)
    launches = adapter.launches() - launches0

    # after the window, so that the window is the same in both kinds of
    # run: CUPTI, once attached, slowed a later window's wrapper calls
    trace = None
    if args.trace:
        from benchmarks.trace import profile

        def stretch():
            log = Spans(log=True)
            n = closed_loop(issue, in_flight, TRACE_S, stamps, log,
                            lambda k, out, ms: None, TRACE_REQUESTS)[0]
            return n, log.log

        trace = profile(stretch, cuda)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                       device)) if cuda else 0}

    # the check, once the window's state is read: the reference works
    # request by request on the same inputs
    checks = {name: {"value": 0.0, "limit": limit}
              for name, limit in cfg["limits"].items()}
    kept = sample.items()
    del sample
    for k, out in kept:
        ref = adapter.reference(cfg, ring.on_device(k))
        for name, value in adapter.compare(cfg, out, ref).items():
            checks[name]["value"] = max(checks[name]["value"], value)
    correct = bool(kept) and all(c["value"] <= c["limit"]
                                 for c in checks.values())

    record = Record(cell=cell, cfg=cfg, adapter=adapter,
                    batch=batch, setup_s=setup_s, window_s=window_s,
                    completed=requests, latency_ms=np.asarray(latency),
                    pixels=adapter.pixels(cfg, batch), spans=spans,
                    trace=trace)
    metrics = {}
    for m in metrics_of(manifest, "per_layer" if args.trace else "end_to_end",
                        cell["name"]):
        value = load("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": requests, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    print("set-up, seconds since start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    print(f"route: {launches} kernel launches for {requests} requests; "
          f"{len(kept)} outputs checked", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    return result, record


def main(argv=None) -> int:
    args = parse(argv)
    try:
        manifest = read_json(ROOT / "BENCHMARK.json")
        import torch

        if args.device == "cuda":
            chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
            need = chips.get(args.workload, 1)
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if found < need:
                raise Refused(f"needs {need} CUDA device(s); found {found}")
        require_program()
        result, _ = measure(args, manifest, torch)
        # the last step before the line: whatever the window, the check
        # or a metric's reader loaded counts
        found = forbidden_modules()
        if found:
            raise Refused(f"loaded in the run: {', '.join(found)}")
    except Refused as e:
        print(f"benchmarks.run: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
