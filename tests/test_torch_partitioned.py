"""Port parity: ``ba/partitioned.py`` (keyframe/map-block partitioned BA)
and the block axis of the dense-Schur LM loop, against the ``sara_tpu``
twins.

- ``plan_blocks`` and ``_pack_blocks`` are NumPy on both sides and must
  match array for array, on ``tests/test_ba.py``'s local-visibility
  problem and on a 48-view city problem (the config-5 scene's true
  tracks, ``chip_smoke.city_ba_arrays``).
- The partitioned solve keeps the reference test's gates, and in float64
  its final cost equals the JAX solve's within 1e-6 relative.
- The batched block LM loop (``torch.func.vmap`` over blocks) equals a
  block-by-block run of ``dense_schur_bundle_adjust`` within 1e-9
  relative (float64), and cutting the point axis into chunks (the port's
  one change) gives the one-chunk result within 1e-9.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sara_tpu_torch.ba import BAOptions, BAProblem, ba_cost, bundle_adjust
from sara_tpu_torch.ba import partitioned as TP
from sara_tpu_torch.ba.dense_schur import (PtMajorBA,
                                           dense_schur_bundle_adjust)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402
import torch_dist  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module (the suite runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def local_visibility_arrays(**kw) -> dict:
    """tests/test_ba.py::_make_local_visibility_problem as numpy arrays."""
    from test_ba import _make_local_visibility_problem

    prob = _make_local_visibility_problem(**kw)
    return {k: np.asarray(v) for k, v in prob._asdict().items()
            if v is not None}


def jax_problem(arrays):
    from sara_tpu.ba import BAProblem as JBAProblem

    return JBAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})


PROBLEMS = {
    "local_visibility": (lambda: local_visibility_arrays(), 4),
    "city_48": (lambda: chip_smoke.city_ba_arrays(48, capacity=256), 4),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_plan_and_pack_match_jax(name):
    from sara_tpu.ba import partitioned as JP

    make, n_blocks = PROBLEMS[name]
    arrays = make()
    jprob, tprob = jax_problem(arrays), torch_dist.ba_problem(arrays)
    jplan, tplan = JP.plan_blocks(jprob, n_blocks), TP.plan_blocks(
        tprob, n_blocks)
    for field, a, b in zip(jplan._fields, jplan, tplan):
        assert np.array_equal(np.asarray(a), np.asarray(b)), field
    for blocks in (None, [0, 2], [1, 3]):
        jm, jsp = JP._pack_blocks(jprob, jplan, blocks)
        tm, tsp = TP._pack_blocks(tprob, tplan, blocks)
        assert jsp == tsp
        for field in PtMajorBA._fields:
            assert np.array_equal(np.asarray(getattr(jm, field)),
                                  getattr(tm, field).numpy()), field


def test_city_scene_in_numpy_is_the_reference_scene():
    """chip_smoke's numpy city scene and pairs equal
    scripts/bench_city_scale_scene.py's."""
    from bench_city_scale_scene import make_city_scene, proximity_pairs

    jk, jc, jK = make_city_scene(48, capacity=256)
    tk, tc, tK, _, _, _ = chip_smoke.make_city_scene(48, capacity=256)
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(jK, tK)
    for a, b in zip(jk, tk):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert proximity_pairs(jc) == chip_smoke.city_pairs(tc)


def test_partitioned_ba_approaches_global():
    """tests/test_ba.py::test_partitioned_ba_approaches_global's twin with
    its gates, and the final cost of the JAX partitioned solve within 1e-6
    relative (float64 on both sides)."""
    from sara_tpu.ba import ba_cost as jcost
    from sara_tpu.ba.partitioned import partitioned_bundle_adjust as jpart
    from sara_tpu.ba import BAOptions as JBAOptions

    arrays = local_visibility_arrays()
    prob = torch_dist.ba_problem(arrays)
    ref, _ = bundle_adjust(prob, BAOptions(max_iters=25))
    out, info = TP.partitioned_bundle_adjust(
        prob, n_blocks=4, opts=BAOptions(max_iters=12), sweeps=4)
    c_ref = float(ba_cost(ref, 4.0, 6.0))
    c_par = float(ba_cost(out, 4.0, 6.0))
    c_init = float(ba_cost(prob, 4.0, 6.0))
    assert c_par < c_init * 0.02
    assert c_par < c_ref * 1.3 + 1e-6, (c_par, c_ref, c_init)
    jout, jinfo = jpart(jax_problem(arrays), 4, JBAOptions(max_iters=12),
                        sweeps=4)
    c_jax = float(jcost(jout, 4.0, 6.0))
    assert abs(c_par - c_jax) <= 1e-6 * c_jax
    assert abs(info["final_cost"] - float(jinfo["final_cost"])) <= 1e-6 * \
        float(jinfo["final_cost"])
    assert info["sp"] == jinfo["sp"] and info["sweep"] == jinfo["sweep"]


def _blocks(arrays, n_blocks=4):
    prob = torch_dist.ba_problem(arrays)
    plan = TP.plan_blocks(prob, n_blocks)
    return TP._pack_blocks(prob, plan)[0]


def test_batched_block_lm_equals_block_by_block():
    """One vmapped LM loop over the block axis (own lambda, accept/reject
    and cost per block) equals each block through
    dense_schur_bundle_adjust, within 1e-9 relative (float64). A fifth,
    inert block (a mesh's padding) rejects every step while the others
    accept theirs."""
    ptm_b = TP._pad_blocks(_blocks(local_visibility_arrays()), 5)
    opts = BAOptions(max_iters=8)
    Q = ptm_b.points.shape[1]
    poses, points, info = TP._solve_blocks(ptm_b, opts, Q)
    lams = set()
    for b in range(ptm_b.poses.shape[0]):
        one = PtMajorBA(*(a if a is ptm_b.intrinsics else a[b]
                          for a in ptm_b))
        p1, x1, i1 = dense_schur_bundle_adjust(one, opts, Q)
        for got, want in ((poses[b], p1), (points[b], x1),
                          (info["costs"][b], i1["costs"])):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-9 * scale
            assert torch.isfinite(got).all()
        lams.add(float(i1["lambda"]))
        assert float(info["lambda"][b]) == float(i1["lambda"])
    assert len(lams) > 1, "blocks should end on their own lambdas"


def test_point_chunks_equal_one_chunk(monkeypatch):
    """Cutting each block's point axis into chunks (the port's one change
    to the reference's one-chunk blocks) changes only the order of the
    sums: 1e-9 relative in float64."""
    arrays = local_visibility_arrays()
    prob = torch_dist.ba_problem(arrays)
    opts = BAOptions(max_iters=6)
    one, _ = TP.partitioned_bundle_adjust(prob, 4, opts, sweeps=2)
    ptm_b = _blocks(arrays)
    B, Pb, Sp = ptm_b.cam_idx.shape
    per_point = B * Sp * ptm_b.poses.shape[1] * 17
    monkeypatch.setattr(TP, "CHUNK_BYTES", per_point * Pb // 4)
    assert TP._chunk_points(ptm_b) == Pb // 4
    chunked, info = TP.partitioned_bundle_adjust(prob, 4, opts, sweeps=2)
    assert info["chunk"] < Pb
    for a, b in ((chunked.poses, one.poses), (chunked.points, one.points)):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


def test_partitioned_empty_problem_is_a_no_op():
    arrays = local_visibility_arrays(n_cams=4, pts_per_cam=5)
    prob = torch_dist.ba_problem(arrays)
    empty = prob._replace(points=prob.points[:0])
    out, info = TP.partitioned_bundle_adjust(empty, 2)
    assert out is empty and info["sweep"] == 0


def test_partitioned_float32_lowers_the_city_cost():
    """On the 48-view city problem in float32 (the production precision,
    with the reference's bfloat16 casts) every phase lowers the cost and
    the output stays finite."""
    arrays = chip_smoke.city_ba_arrays(48, capacity=256)
    prob = torch_dist.ba_problem(arrays, "float32")
    out, info = TP.partitioned_bundle_adjust(prob, 4, BAOptions(max_iters=6),
                                             sweeps=2)
    c0 = float(ba_cost(prob, 4.0, 6.0))
    c1 = float(ba_cost(out, 4.0, 6.0))
    assert np.isfinite(out.poses.numpy()).all()
    assert np.isfinite(out.points.numpy()).all()
    assert c1 < 0.5 * c0, (c0, c1)
    assert info["final_cost"] <= info["initial_cost"]
    assert isinstance(out, BAProblem) and out.poses.dtype == torch.float32
