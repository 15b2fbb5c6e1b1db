"""Readings that set a cell's limits: runs of the cell, seed after seed,
in one process.

    python benchmark/control.py --workload <name> --seeds 11 12 13 \
        [--seconds 4] [--control 1]

Each seed is one run of the cell as ``run.py`` makes it (``run.run_cell``),
with a window of ``--seconds`` at the cell's own load. With ``--control 0``
the program's outputs are compared with the plain reference, as in the
benchmark's own runs; with ``--control 1`` the reference at the
configuration's lower precision (TF32 operands, for every cell) takes the
program's place, and the run has to come out not correct. One JSON line
per seed: the seed, ``correct``, each number compared beside its limit,
and what else the comparison saw. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    run.use_checkout_caches()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    bench = run.read_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        out = run.run_cell(bench, args.workload, seed, args.seconds, 0,
                           control=bool(args.control),
                           t_start=time.perf_counter())
        print(json.dumps({"seed": seed, "control": bool(args.control),
                          "correct": out["correct"], "checks": out["checks"],
                          "seen": out["seen"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
