"""Profile the PyTorch / CUDA port's SIFT frontend with ``torch.profiler``
and report the top operations by device time.

Twin of ``scripts/probe_trace_frontend.py``: per-operation attribution of
``compute_sift_keypoints`` over three frames (prefix deltas reshuffle
between calls; the trace does not). On the card only the device's own
events count (kernels, copies, memsets: the device-activity lane, as
``chip_smoke.profile_frame`` counts them), by their device time; on the
CPU the device is the CPU, and its operators count by their self time.
The trace goes to ``out_prefix/trace.json`` (default: a new temporary
directory).

The image is ``torch_bench.load_pair``'s first (the reference's
photograph, else the seeded noise). It imports only ``sara_tpu_torch``
and numpy, and runs on the card unless ``--device cpu`` is given; without
a card it raises.

Usage: python scripts/torch_probe_trace_frontend.py [cap] [out_prefix]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torch_bench import load_pair  # noqa: E402

FRAMES = 3


def summarize(averages, device, top=30):
    """The trace's total device time, its event count and its ``top``
    operations by device time, printed; returns them."""
    from torch.autograd import DeviceType

    on_card = device.type == "cuda"

    def dev_us(e):
        if not on_card:
            return e.self_cpu_time_total
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kind = DeviceType.CUDA if on_card else DeviceType.CPU
    events = [e for e in averages or ()
              if e.device_type == kind and dev_us(e) > 0]
    if not events:
        print("device total not measured (no device events)")
        return None
    total = sum(dev_us(e) for e in events) / 1e3
    count = sum(e.count for e in events)
    print(f"device total {total:.2f} ms across {count} events ({device})")
    events.sort(key=dev_us, reverse=True)
    rows = [{"name": e.key, "calls": e.count, "device_ms": dev_us(e) / 1e3}
            for e in events[:top]]
    for r in rows:
        print(f"  {r['device_ms']:8.3f} ms  x{r['calls']:<5d} "
              f"{r['name'][:110]}")
    return {"device_total_ms": total, "events": count, "top": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cap", nargs="?", type=int, default=4096)
    ap.add_argument("out_prefix", nargs="?", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features.api import (SIFTParams,
                                             compute_sift_keypoints)
    from sara_tpu_torch.features.dog import DoGParams
    from sara_tpu_torch.utils.timing import device_trace

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    print("device:", dev, "cap:", args.cap, flush=True)
    a = torch.as_tensor(load_pair()[0]).to(dev)
    params = SIFTParams(dog=DoGParams(capacity=args.cap, refine_iters=2))

    t0 = time.perf_counter()
    compute_sift_keypoints(a, params, device=dev)
    sync()
    print(f"compile+first {time.perf_counter()-t0:.1f}s (the first call; "
          f"nothing is compiled)", flush=True)
    for _ in range(2):
        compute_sift_keypoints(a, params, device=dev)
    sync()

    logdir = args.out_prefix or tempfile.mkdtemp(prefix="torch_sift_trace")
    with device_trace(logdir) as trace:
        for _ in range(FRAMES):
            compute_sift_keypoints(a, params, device=dev)
            sync()
    print(f"trace: {os.path.join(logdir, 'trace.json')}", flush=True)
    return summarize(trace.averages, dev)


if __name__ == "__main__":
    main()
