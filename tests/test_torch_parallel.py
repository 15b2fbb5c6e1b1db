"""Port parity: ``parallel/*`` and the sharded solvers on multi-process gloo
worlds of 2 and 4 ranks and a 2 x 2 (host, chip) mesh, against the port's
single-process solvers and the ``sara_tpu`` twins on the 8-device CPU mesh.

Twins of ``tests/test_parallel.py``'s tests (its two JAX dry runs are
covered by ``chip_smoke.py``'s phase "dist"). Every world is spawned
through ``tests/torch_dist.py`` (a ``FileStore`` under ``tmp_path``, one
thread per rank, a 120 s deadline after which the ranks are killed and the
test fails); each world runs once per module and its tests read its
results. Tolerances: float64 throughout; a sharded solve against the
port's own single-process solve within 1e-8 relative (the same program,
sums taken in another order), against JAX within 1e-6; matching indices
and masks identical, distances within 1e-5 relative to the squared norms
that the GEMM form cancels (float32).
"""

import numpy as np
import pytest
import torch

from geometry_fixtures import default_K
from sara_tpu_torch.ba import BAOptions, bundle_adjust_cg
from sara_tpu_torch.ba.dense_schur import (dense_schur_bundle_adjust,
                                           pack_pt_major)
from sara_tpu_torch.ba.partitioned import partitioned_bundle_adjust
from sara_tpu_torch.parallel import (BACommModel, initialize_distributed,
                                     process_local_slice)
from sara_tpu_torch.utils import roofline

import torch_dist

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module (the suite runs six workers; the
    spawned ranks take one each too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPTS = dict(max_iters=10, cg_iters=20)
OPTS_SMALL = dict(max_iters=5, cg_iters=10)
RATIO = 0.8


def toy_problem(seed=0, C=4, P=96, O=400):
    """tests/test_parallel.py::_toy_problem in numpy (float64)."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-2, 2, (P, 3)) + np.array([0, 0, 8.0])
    K = default_K()
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    poses = np.zeros((C, 6))
    poses[:, 3] = np.linspace(0, 1.0, C)
    cam_idx = rs.randint(0, C, O).astype(np.int32)
    pt_idx = rs.randint(0, P, O).astype(np.int32)
    uv = []
    for c, p in zip(cam_idx, pt_idx):
        Xc = X[p] + poses[c, 3:]
        uv.append([intr[0] * Xc[0] / Xc[2] + intr[2],
                   intr[1] * Xc[1] / Xc[2] + intr[3]])
    uv = np.asarray(uv) + rs.normal(scale=0.3, size=(O, 2))
    pose_fixed = np.zeros(C, bool)
    pose_fixed[0] = True
    return dict(
        poses=poses + np.concatenate(
            [np.zeros((1, 6)), rs.normal(scale=5e-3, size=(C - 1, 6))]),
        points=X + rs.normal(scale=2e-2, size=X.shape), intrinsics=intr,
        cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, obs_mask=np.ones(O, bool),
        pose_fixed=pose_fixed, point_fixed=np.zeros(P, bool))


def jax_problem(arrays):
    import jax.numpy as jnp

    from sara_tpu.ba import BAProblem as JBAProblem

    return JBAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})


def match_inputs(seed=0, B=8, N=32, D=16):
    """tests/test_parallel.py's batch: b rows are permuted copies of a,
    plus a second batch of unrelated sets with masked tails."""
    rs = np.random.RandomState(seed)
    da = rs.normal(size=(B, N, D)).astype(np.float32)
    perm = np.stack([rs.permutation(N) for _ in range(B)])
    db = np.stack([da[b][perm[b]] for b in range(B)])
    db[B // 2:] = rs.normal(size=(B - B // 2, N, D)).astype(np.float32)
    m = np.ones((B, N), bool)
    m[B // 2:, N - 5:] = False
    return (da, m, db, m.copy()), perm


PROBLEMS = {"padded": toy_problem(), "unpadded": toy_problem(C=3, P=37,
                                                                O=101)}
PROBLEM_OPTS = {"padded": OPTS, "unpadded": OPTS_SMALL}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world runs once: solvers and matching on 2 and 4 ranks."""
    match_in, _ = match_inputs()
    out = {}
    for world in (2, 4):
        out[world] = {
            name: torch_dist.run_world(
                torch_dist.solvers_worker, world,
                tmp_path_factory.mktemp(f"w{world}{name}"),
                PROBLEMS[name], PROBLEM_OPTS[name], match_in, RATIO)
            for name in PROBLEMS}
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-process solves of the same problems."""
    out = {}
    for name, arrays in PROBLEMS.items():
        prob = torch_dist.ba_problem(arrays)
        opts = BAOptions(**PROBLEM_OPTS[name])
        ptm, stats = pack_pt_major(prob, chunk=min(opts.dense_chunk, max(
            64, -(-arrays["points"].shape[0] // 2))))
        poses, points, info = dense_schur_bundle_adjust(ptm, opts,
                                                        stats["chunk"])
        cg, cg_info = bundle_adjust_cg(prob, opts)
        out[name] = {
            "dense": {"poses": poses.numpy(),
                      "points": points.numpy()[:arrays["points"].shape[0]],
                      "final_cost": float(info["final_cost"])},
            "cg": {"poses": cg.poses.numpy(), "points": cg.points.numpy(),
                   "final_cost": float(cg_info["final_cost"])}}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_has_the_world_size(worlds, world):
    for res in worlds[world]["padded"]:
        assert res["mesh_size"] == world
        assert res["local_devices"] == 0      # no card on the CPU ranks


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_dense_schur_matches_single_process(worlds, single, world,
                                                    name):
    """dense_schur_bundle_adjust_sharded (through distributed_bundle_adjust)
    equals the unsharded dense-Schur solve within 1e-8 relative on every
    rank, on point counts that do and do not divide the mesh."""
    ref = single[name]["dense"]
    for res in worlds[world][name]:
        d = res["dense"]
        assert rel(d["poses"], ref["poses"]) < 1e-8
        assert rel(d["points"], ref["points"]) < 1e-8
        assert abs(d["final_cost"] - ref["final_cost"]) <= 1e-8 * abs(
            ref["final_cost"])
        assert d["final_cost"] < d["initial_cost"]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_cg_matches_world_of_one(worlds, single, world, name):
    """CG over observation shards equals bundle_adjust_cg in one process
    within 1e-8 relative."""
    ref = single[name]["cg"]
    for res in worlds[world][name]:
        c = res["cg"]
        assert rel(c["poses"], ref["poses"]) < 1e-8
        assert rel(c["points"], ref["points"]) < 1e-8
        assert abs(c["final_cost"] - ref["final_cost"]) <= 1e-8 * abs(
            ref["final_cost"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_dense_schur_matches_jax_sharded(worlds, world):
    """Against JAX's dense_schur_bundle_adjust_sharded on its 8-device CPU
    mesh: 1e-6 relative."""
    from sara_tpu.ba import BAOptions as JBAOptions
    from sara_tpu.ba.dense_schur import (
        dense_schur_bundle_adjust_sharded as jsharded,
        pack_pt_major as jpack)
    from sara_tpu.parallel import make_mesh as jmesh

    arrays = PROBLEMS["padded"]
    ptm, stats = jpack(jax_problem(arrays), chunk=64)
    poses, points, info = jsharded(ptm, jmesh(8), JBAOptions(**OPTS),
                                   stats["chunk"])
    P = arrays["points"].shape[0]
    for res in worlds[world]["padded"]:
        d = res["dense"]
        assert rel(d["poses"], np.asarray(poses)) < 1e-6
        assert rel(d["points"], np.asarray(points)[:P]) < 1e-6
        assert abs(d["final_cost"] - float(info["final_cost"])) <= 1e-6 * \
            float(info["final_cost"])


@pytest.mark.parametrize("world", [2, 4])
def test_batched_matching_on_mesh_matches_jax(worlds, world):
    """batched_match_pairs split over the ranks gives JAX's _match_batch
    indices and mask exactly, distances within 1e-5 relative to the
    squared norms that the GEMM form ||a||^2 + ||b||^2 - 2 a.b cancels
    (an exact match's distance is rounding noise of that size); the
    permuted pairs match perfectly."""
    import jax.numpy as jnp

    from sara_tpu.parallel.dist_frontend import _match_batch as jmatch

    (da, ma, db, mb), perm = match_inputs()
    jj, jok, jd1 = (np.asarray(x) for x in jmatch(
        jnp.asarray(da), jnp.asarray(ma), jnp.asarray(db), jnp.asarray(mb),
        RATIO))
    for res in worlds[world]["padded"]:
        j, ok, d1 = res["match"]
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(np.where(ok, j, -1),
                                      np.where(jok, jj, -1))
        fin = np.isfinite(jd1)
        np.testing.assert_array_equal(np.isfinite(d1), fin)
        scale = 2.0 * float(max((da ** 2).sum(-1).max(),
                                (db ** 2).sum(-1).max()))
        np.testing.assert_allclose(d1[fin], jd1[fin], rtol=1e-5,
                                   atol=1e-5 * scale)
        for b in range(len(perm) // 2):
            assert ok[b].all()
            np.testing.assert_array_equal(j[b], np.argsort(perm[b]))


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    return {name: torch_dist.run_world(
        torch_dist.multihost_worker, 4,
        tmp_path_factory.mktemp(f"mh{name}"), PROBLEMS[name],
        {**PROBLEM_OPTS[name], "solver": "cg"}, 2)
        for name in PROBLEMS}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_multihost_2d_mesh_matches_single_process(multihost, single, name):
    """multihost_bundle_adjust on a 2 x 2 (host, chip) mesh equals
    bundle_adjust_cg in one process within 1e-8 relative; the runtime
    helpers behave as the twin's."""
    ref = single[name]["cg"]
    for rank, res in enumerate(multihost[name]):
        assert res["shape"] == (2, 2)
        assert res["initialized"] is True
        assert res["slice"] == slice(25 * rank, 25 * rank + 25)
        assert rel(res["poses"], ref["poses"]) < 1e-8
        assert rel(res["points"], ref["points"]) < 1e-8
        assert abs(res["final_cost"] - ref["final_cost"]) <= 1e-8 * abs(
            ref["final_cost"])


def test_single_process_runtime_helpers():
    """The twin's single-process no-op path of the distributed start."""
    assert initialize_distributed() is False
    assert process_local_slice(100) == slice(0, 100)


def test_partitioned_on_mesh_matches_unmeshed(tmp_path):
    """tests/test_ba.py::test_partitioned_ba_on_mesh's twin: the blocks of
    each phase split over a "block" mesh of 2 ranks give the unmeshed
    result (1e-8 absolute on poses, as the twin's gate)."""
    from test_torch_partitioned import local_visibility_arrays

    arrays = local_visibility_arrays(n_cams=12, pts_per_cam=25)
    ref, _ = partitioned_bundle_adjust(torch_dist.ba_problem(arrays), 4,
                                       BAOptions(max_iters=8), sweeps=2)
    res = torch_dist.run_world(torch_dist.partitioned_worker, 2, tmp_path,
                               arrays, 4, {"max_iters": 8}, 2)
    for r in res:
        np.testing.assert_allclose(r["poses"], ref.poses.numpy(), atol=1e-8)
        np.testing.assert_allclose(r["points"], ref.points.numpy(),
                                   atol=1e-8)


def test_ba_comm_model_scaling_structure():
    """tests/test_parallel.py's twin: per-shard observation work shrinks
    ~ 1/n while the all-reduced payload stays O(C), independent of n and
    of O; the model predicts >= 80% efficiency at n = 8."""
    C, P, O, cg = 256, 60_000, 800_000, 15
    m1 = BACommModel(C, P, O, cg, 1)
    m2 = BACommModel(C, P, O, cg, 2)
    m8 = BACommModel(C, P, O, cg, 8)
    assert abs(m2.per_shard_obs_flops() / m1.per_shard_obs_flops()
               - 0.5) < 1e-3
    assert abs(m8.per_shard_obs_flops() / m1.per_shard_obs_flops()
               - 0.125) < 1e-3
    assert m2.allreduce_bytes() == m8.allreduce_bytes()
    assert BACommModel(C, P, 10 * O, cg, 8).allreduce_bytes() == \
        m8.allreduce_bytes()
    assert abs(BACommModel(2 * C, P, O, cg, 8).allreduce_bytes()
               / m8.allreduce_bytes() - 2.0) < 0.01
    assert m8.scaling_efficiency(achieved=0.05) > 0.8
    assert m8.allreduce_seconds() < 0.1 * m8.compute_seconds(achieved=0.05)
    assert "NVLink" in m8.report()


def test_comm_model_arithmetic_matches_twin():
    """The model's FLOP and byte counts are the twin's; only the link and
    peak constants are the H100's."""
    from sara_tpu.parallel import BACommModel as JModel

    for args in [(256, 60_000, 800_000, 15, 1), (1024, 5_885, 393_167, 30,
                                                 4)]:
        a, b = BACommModel(*args), JModel(*args)
        assert a.per_shard_flops() == b.per_shard_flops()
        assert a.allreduce_bytes() == b.allreduce_bytes()


@pytest.mark.parametrize("fn,args", [
    ("ba_lm_iteration", (256, 100_000, 800_000, 15)),
    ("sift_frame", (480, 640)),
    ("match_pair", (2048, 2048)),
])
def test_roofline_estimates_match_twin(fn, args):
    """utils/roofline.py counts the twin's FLOPs and bytes; its peaks are
    the H100 SXM data sheet's."""
    from sara_tpu.utils import roofline as jroof

    a, b = getattr(roofline, fn)(*args), getattr(jroof, fn)(*args)
    assert (a.flops, a.bytes, a.note) == (b.flops, b.bytes, b.note)
    assert roofline.PEAK_HBM_BW == 3.35e12
    assert roofline.PEAK_F32_FLOPS == 67e12
    assert roofline.PEAK_BF16_FLOPS == 989e12
    t = a.roofline_seconds()
    assert t == max(a.flops / 67e12, a.bytes / 3.35e12)
    assert "of roofline" in roofline.report(fn, a, 2 * t)
