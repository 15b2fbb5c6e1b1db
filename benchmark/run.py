"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration (``benchmark/configs/<config>.json``) names the
generator (``benchmark/generators/<generator>.py``) that makes the traffic
``benchmark/traffic/<traffic>.json`` describes; each metric is read by
``benchmark/metrics/<metric>.py``. So a new cell, mix or metric is new files
and new entries, and no edit here.

A run makes its inputs from the seed, warms every shape it uses (set-up),
measures for ``--seconds``, and then holds what the timed path produced to
the plain reference in ``benchmark/reference/``. ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` times each call by CUDA events,
counts host syncs over a few units, profiles a steady slice, and reports
the per-layer metrics with the device's busy time. Without a CUDA device,
or with fewer than the cell asks for, the run fails and prints no result;
so it does if JAX or the JAX package is loaded once the window has closed.
The last line of standard output is one JSON object; the numbers compared
are repeated, each beside its limit, as the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "sara_tpu")


def load(path: Path):
    """The module in ``path`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration, traffic, generator module) of workload
    ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(root / entry["file"])
    traffic = read_json(root / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
    gen = load(root / "benchmark" / "generators"
               / f"{config['generator']}.py")
    return cell, config, traffic, gen


def cell_metrics(bench: dict, cell: dict, trace: bool):
    """The metrics the cell reports: its end-to-end ones, or with
    ``trace`` the per-layer ones that list it (or, without a list, move
    one of its end-to-end metrics)."""
    def has(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def layer(m):
        if "workloads" in m:
            return cell["name"] in m["workloads"]
        return m["moves"] in names
    return [m for m in bench["per_layer"] if layer(m)]


class Context:
    """What a metric's reader may read: the spans and counters, the
    window's counts, the profile of the steady slice, the needed work and
    the table of peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def use_checkout_caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def run_cell(bench, name, seed, seconds, trace, device="cuda",
             root: Path = ROOT, control: bool = False, t_start=None):
    """One run of cell ``name``; returns the result dict, with the numbers
    compared under ``checks``. ``control`` puts the reference at the
    configuration's lower precision in the program's place."""
    import numpy as np
    import torch

    from benchmark.checks import verdict
    from benchmark.lib.profile import profile_slice
    from benchmark.lib.timing import Spans, count_syncs

    t_start = T_START if t_start is None else t_start
    cell, config, traffic, gen = cell_parts(bench, name, root)
    on_card = torch.device(device).type == "cuda"
    spans = Spans(on=bool(trace) and on_card)
    g = gen.Generator(config, traffic, seed, device, spans)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    g.setup()
    setup_s = time.perf_counter() - t_start
    stats = g.window(seconds)
    profile, syncs = None, None
    if spans.on:
        n = traffic["sync_units"]
        syncs = sum(count_syncs(g.step_fn()) for _ in range(n)) / n
        profile = profile_slice(g.trace_slice(traffic["trace_units"]),
                                spans)
    ctx = Context(spans=spans, stats=stats, profile=profile, syncs=syncs,
                  work=g.work() if spans.on else {},
                  trace_units=traffic["trace_units"],
                  peaks=read_json(root / "benchmark" / "peaks.json"))
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = load(root / "benchmark" / "metrics"
                         / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    mem = torch.cuda.max_memory_allocated() if on_card else 0
    g.release()
    numbers, seen = g.check(low=control)
    rows, ok = verdict(numbers, config["limits"])
    ok = ok and all(v > 0 for k, v in seen.items() if k.endswith("checked"))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(mem)}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    out = {"correct": bool(ok), "attempted": stats.get("units",
                                                       stats.get("solves")),
           "failed": 0, "metrics": metrics, "device": dev}
    if profile is not None:
        out["breakdown"] = profile["breakdown"]
    if stats.get("latency_s"):
        lat = np.asarray(stats["latency_s"]) * 1e3
        seen["latency_ms"] = {"n": int(lat.size), "median": float(
            np.median(lat)), "p95": float(np.percentile(lat, 95)),
            "max": float(lat.max())}
    out["seen"] = seen
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = read_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    use_checkout_caches()
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print("no CUDA device, or fewer than the cell asks for: "
              "the benchmark measures the card and never falls back",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    sys.path.insert(0, str(ROOT))
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   args.trace)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
