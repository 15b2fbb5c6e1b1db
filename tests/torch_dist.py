"""Multi-process gloo worlds for the port's distributed tests (JAX-free).

``run_world(fn, world, tmp_path, *args)`` spawns ``world`` ranks, each
with one intra-op thread, joined through a ``FileStore`` under
``tmp_path`` (no TCP port), runs ``fn(rank, world, *args)`` in each and
returns the ranks' results. A rank that has not finished by the deadline
is killed and the call raises, so a hung collective fails its test instead
of running into the suite's clock. The workers below import torch, numpy
and the port only: the spawned interpreters never load JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

# Seconds a world may take, start-up included, and the collectives'
# own timeout inside it.
DEADLINE = 120.0
GROUP_TIMEOUT = timedelta(seconds=60)


def _entry(fn, rank, world, store_path, out_path, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=GROUP_TIMEOUT)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:                                      # noqa: BLE001
        result = ("error", traceback.format_exc())
    Path(out_path).write_bytes(pickle.dumps(result))


def run_world(fn, world: int, tmp_path, *args, deadline: float = DEADLINE):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns the
    list of their results (rank order)."""
    ctx = mp.get_context("spawn")
    tmp_path = Path(tmp_path)
    store = str(tmp_path / f"store_{fn.__name__}_{world}")
    outs = [tmp_path / f"out_{fn.__name__}_{world}_{r}.pkl"
            for r in range(world)]
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, str(outs[r]), args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(end - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {fn.__name__} still running "
                           f"after {deadline} s")
    results = []
    for r, out in enumerate(outs):
        if not out.exists():
            raise RuntimeError(f"rank {r} of {fn.__name__} exited "
                               f"{procs[r].exitcode} without a result")
        status, value = pickle.loads(out.read_bytes())
        if status != "ok":
            raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{value}")
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# problems (numpy in, numpy out: what crosses the process boundary)
# ---------------------------------------------------------------------------

def ba_problem(arrays: dict, dtype="float64"):
    """A port BAProblem on the CPU from a dict of numpy arrays."""
    import torch

    from sara_tpu_torch.ba import BAProblem

    dt = getattr(torch, dtype)
    f = lambda k: torch.from_numpy(np.array(arrays[k])).to(dt)  # noqa: E731
    i = lambda k: torch.from_numpy(np.array(arrays[k]))         # noqa: E731
    return BAProblem(poses=f("poses"), points=f("points"),
                     intrinsics=f("intrinsics"), cam_idx=i("cam_idx"),
                     pt_idx=i("pt_idx"), uv=f("uv"), obs_mask=i("obs_mask"),
                     pose_fixed=i("pose_fixed"),
                     point_fixed=i("point_fixed"))


def _np(t):
    return t.detach().cpu().numpy()


def _result(prob, info):
    return {"poses": _np(prob.poses), "points": _np(prob.points),
            "final_cost": float(info["final_cost"]),
            "initial_cost": float(info["initial_cost"])}


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def solvers_worker(rank, world, arrays, opts_kw, match_in, ratio):
    """Dense-Schur point shards, CG observation shards and batched
    matching on one 1-D mesh of ``world`` ranks."""
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.parallel import (batched_match_pairs,
                                         distributed_bundle_adjust,
                                         local_device_count, make_mesh)
    import torch

    mesh = make_mesh(world, device="cpu")
    prob = ba_problem(arrays)
    out = {"mesh_size": mesh.size(), "local_devices": local_device_count()}
    o, i = distributed_bundle_adjust(prob, mesh, BAOptions(**opts_kw))
    out["dense"] = _result(o, i)
    o, i = distributed_bundle_adjust(prob, mesh,
                                     BAOptions(**opts_kw, solver="cg"))
    out["cg"] = _result(o, i)
    da, ma, db, mb = (torch.from_numpy(a) for a in match_in)
    j, ok, d1 = batched_match_pairs(da, ma, db, mb, mesh, ratio=ratio)
    out["match"] = (_np(j), _np(ok), _np(d1))
    return out


def multihost_worker(rank, world, arrays, opts_kw, hosts):
    """``multihost_bundle_adjust`` on a (host, chip) mesh."""
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.parallel import (initialize_distributed,
                                         make_host_chip_mesh,
                                         multihost_bundle_adjust,
                                         process_local_slice)

    mesh = make_host_chip_mesh(hosts=hosts, device="cpu")
    o, i = multihost_bundle_adjust(ba_problem(arrays), mesh,
                                   BAOptions(**opts_kw))
    return {"shape": tuple(mesh.shape), "initialized":
            initialize_distributed(), "slice": process_local_slice(100),
            **_result(o, i)}


def partitioned_worker(rank, world, arrays, n_blocks, opts_kw, sweeps):
    """``partitioned_bundle_adjust`` with its blocks split over a "block"
    mesh of ``world`` ranks."""
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.partitioned import partitioned_bundle_adjust
    from sara_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, axis="block", device="cpu")
    o, i = partitioned_bundle_adjust(ba_problem(arrays), n_blocks,
                                     BAOptions(**opts_kw), sweeps=sweeps,
                                     mesh=mesh)
    return _result(o, i)


def global_sfm_worker(rank, world, kps_np, K, pairs, cfg_kw, ba_kw):
    """``run_global_sfm`` with the partitioned BA's blocks on a "block"
    mesh of ``world`` ranks (every rank runs the pipeline)."""
    import torch

    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.core.types import Keypoints
    from sara_tpu_torch.parallel import make_mesh
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm

    mesh = make_mesh(world, axis="block", device="cpu")
    kps = [Keypoints(*(torch.from_numpy(a) for a in k)) for k in kps_np]
    cfg = GlobalSfMConfig(**cfg_kw, ba_options=BAOptions(**ba_kw))
    out = run_global_sfm(kps, K, pairs=pairs, config=cfg, ba_mesh=mesh,
                         device="cpu")
    return {"R": out["R"], "t": out["t"], "points": out["points"],
            "num_edges": out["num_edges"], "ba_info": out["ba_info"]}
