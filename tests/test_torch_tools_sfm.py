"""The twins of the BA, SfM and solver command-line tools
(``scripts/torch_bench_ba.py``, ``torch_bench_sfm_scale.py``,
``torch_bench_city_scale.py`` with its scene, ``torch_bench_config5_real.py``,
``torch_mc_fivepoint.py``) on the CPU, against the JAX tools.

Each twin's ``main(argv)`` runs in this process with ``--device cpu`` at a
small size and is gated by ``chip_smoke.tool_failures``, the gates phase
"tools" applies on the card. The JAX tool's output on the same seed and
size, except where a test names another way, is its recording
(``tool_twins.Reference``) where the recording's fingerprint matches the
tree; else the tool runs live in a subprocess (JAX on the CPU, no x64, as
a user runs it), in the two slowest comparisons beside the twin
(``tool_twins.run_beside``).
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tool_twins import (  # noqa: E402
    OUT, PROCEDURAL_ROOM, ROOT, json_fields, last_json, run_beside,
    run_twin, tool_reference)
from chip_smoke import load_tool, tool_failures  # noqa: E402

# Time limits (s) of the JAX tools where they run live: about three times
# each one's wall time in the loaded suite, at least 120 s.
BENCH_BA_SECONDS = 120
BENCH_SFM_SCALE_SECONDS = 440
BENCH_CONFIG5_REAL_SECONDS = 760

TINY = dict(C=8, P=400, O=3200)
BENCH_BA = tool_reference(
    "tools_sfm.bench_ba", "bench_ba",
    ["--sizes", "tiny", "--json", f"{OUT}/j.json"], BENCH_BA_SECONDS,
    patch=f"import bench_ba; bench_ba.SIZES['tiny'] = {TINY!r}",
    files=("j.json",), varies=(
        r"compile\+1st=[\d.]+s", r"run=\d+ms", r"[\d.]+ LM iters/s",
        r"measured [\d.]+ ms, [\d.]+% of roofline",
        r"\([\d.]+x device-resident\)",
        json_fields("lm_iters_per_s", "ms_per_lm_iter", "compile_s",
                    "roofline_frac", "vs_device_resident")))
SFM_SCALE_ARGV = ["--views", "16"]
# The reference's verified edges, printed by its global SfM.
EDGES_PRINTED = (
    "import sara_tpu.sfm.global_sfm as g; _run = g.run_global_sfm\n"
    "def _rec(*a, **k):\n"
    "    o = _run(*a, **k)\n"
    "    print('EDGES', [[int(i) for i in e] for e in o['edges']])\n"
    "    return o\n"
    "g.run_global_sfm = _rec")
BENCH_SFM_SCALE = tool_reference(
    "tools_sfm.bench_sfm_scale", "bench_sfm_scale", SFM_SCALE_ARGV,
    BENCH_SFM_SCALE_SECONDS, patch=EDGES_PRINTED,
    varies=(json_fields("value", "total_s"),))
CONFIG5_ARGV = ["--views", "12", "--ba-blocks", "4", "--mesh", "1"]
BENCH_CONFIG5_REAL = tool_reference(
    "tools_sfm.bench_config5_real", "bench_config5_real",
    CONFIG5_ARGV + ["--json", f"{OUT}/j.json"], BENCH_CONFIG5_REAL_SECONDS,
    patch=PROCEDURAL_ROOM, cpu_flag=False, files=("j.json",), varies=(
        json_fields("total_sfm_s", "wall_s", "speedup", "efficiency",
                    "projected_2x4_efficiency", "host_physical_cores"),
        r'"stage_times_s": \{[^}]*\}'))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the partitioned BA's batched solves stop in MKL
    with more, ROADMAP §3; the suite runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)






def test_bench_ba_against_the_tool(tmp_path, monkeypatch):
    """A tiny size (C=8, P=400, O=3200) through both solvers, the dense
    solver on pre-packed strata and a session re-solve: each initial and
    final cost within 1e-3 relative of the tool's, the same keys in the
    JSON artifact."""
    twin = load_tool("bench_ba")
    monkeypatch.setitem(twin.SIZES, "tiny", TINY)
    argv = ["--sizes", "tiny", "--json", str(tmp_path / "t.json")]
    out = twin.main(argv + ["--device", "cpu"])
    assert not tool_failures("bench_ba", out, argv), out
    ref = BENCH_BA.start(tmp_path).output()
    costs = dict((s, (float(a), float(b))) for s, a, b in re.findall(
        r"tiny\[(dense|cg)\]: .* cost ([\d.]+)->([\d.]+)", ref.text))
    assert set(costs) == {"dense", "cg"}
    for solver, (c0, c1) in costs.items():
        got = out["tiny"][solver]
        assert abs(got["initial_cost"] - c0) <= 1e-3 * c0, (solver, got, c0)
        assert abs(got["final_cost"] - c1) <= 1e-3 * c1, (solver, got, c1)
    t, j = (json.loads(f.read_text()) for f in (tmp_path / "t.json",
                                                 ref.files["j.json"]))
    assert set(t) == set(j)
    assert set(t["results"]["tiny"]) == set(j["results"]["tiny"])


def test_bench_ba_scipy_anchor_and_mesh(monkeypatch):
    """``--scipy-anchor`` (scipy's TRF + LSMR on the port's Jacobians)
    lowers the cost, and ``--mesh`` runs the sharded solver on a gloo
    world of one, equal to the one-device solve."""
    import torch.distributed as dist

    twin = load_tool("bench_ba")
    monkeypatch.setitem(twin.SIZES, "tiny", TINY)
    argv = ["--sizes", "tiny", "--solvers", "dense", "--scipy-anchor",
            "--anchor-nfev", "4", "--mesh", "--device", "cpu"]
    try:
        out = twin.main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    a = out["tiny"]["scipy_anchor"]
    assert a["final_cost_ours"] < out["tiny"]["dense"]["initial_cost"]
    (row,) = out["mesh"]
    assert row["n"] == 1
    assert abs(row["final_cost"] - out["tiny"]["dense"]["final_cost"]) <= \
        1e-5 * out["tiny"]["dense"]["final_cost"]


def test_city_scene_equals_the_tools():
    """64 views of the city sweep: every keypoint array of every view, the
    centres, K and the proximity pairs equal to the tool's scene."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import bench_city_scale_scene as jscene

    twin = load_tool("bench_city_scale_scene")
    kps, centers, K = twin.make_city_scene(64, device="cpu")
    jkps, jcenters, jK = jscene.make_city_scene(64)
    np.testing.assert_array_equal(centers, jcenters)
    np.testing.assert_array_equal(K, jK)
    for kp, jkp in zip(kps, jkps):
        for a, b in zip(kp, jkp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert twin.proximity_pairs(centers) == jscene.proximity_pairs(jcenters)
    np.testing.assert_array_equal(twin.gt_rotations(64),
                                  jscene.gt_rotations(64))


def test_mc_fivepoint_against_the_tool():
    """200 problems (30% near-planar, 15% small-baseline): the tool's and
    the twin's harnesses draw the same problems and list the same oracle
    solutions (within the oracle's deduplication radius, 1e-4: its pencil's
    coefficients come from each package's own float64 code). Recovery, by kind, of the port's solver against the
    reference's (``jax.jit(jax.vmap(five_point_essential))`` on the same
    problems, as the tool runs it; this suite's conftest turns on x64, as
    the tool does): generic and near-planar at the Monte-Carlo gate of
    tests/test_torch_geometry.py on both sides (>= 99%, >= 97%), with at
    most 1% of those solutions found by one side only (2 of 536 generic
    ones here, by the reference only); small-baseline problems (a baseline
    of 1e-3, at the bracketing's resolution) recover about 40% on both
    sides, held within 10% of the oracle's count of each other."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "scripts"))
    import mc_fivepoint

    from sara_tpu.mvg.fivepoint import five_point_essential

    out = run_twin("mc_fivepoint", ["--n", "200"])
    assert not tool_failures("mc_fivepoint", out, ["--n", "200"]), out
    twin = load_tool("mc_fivepoint")
    rs = np.random.RandomState(0)
    probs, kinds = [], []
    for _ in range(200):
        k = rs.rand()
        planar, small = k < 0.3, 0.3 <= k < 0.45
        probs.append(mc_fivepoint.make_problem(rs, near_planar=planar,
                                               small_baseline=small))
        kinds.append("near_planar" if planar else
                     "small_baseline" if small else "generic")
    Ej, vj = (np.asarray(a) for a in jax.jit(jax.vmap(five_point_essential))(
        jnp.asarray(np.stack([p[0] for p in probs])),
        jnp.asarray(np.stack([p[1] for p in probs]))))
    n_oracle = {k: 0 for k in out["oracle_by_kind"]}
    hits = {k: [0, 0] for k in n_oracle}       # reference, one side only
    for k, (u, v, _) in enumerate(probs):
        oracle = mc_fivepoint.oracle_solutions(u, v)
        mine = twin.oracle_solutions(u, v)
        assert len(mine) == len(oracle)
        ref = [Ej[k][i] / np.linalg.norm(Ej[k][i]) for i in range(10)
               if vj[k][i]]
        for E in oracle:
            # Within the oracle's own deduplication radius.
            assert min(min(np.linalg.norm(E - F), np.linalg.norm(E + F))
                       for F in mine) < 1e-4
            n_oracle[kinds[k]] += 1
            hits[kinds[k]][0] += any(
                min(np.linalg.norm(E - F), np.linalg.norm(E + F)) < 1e-3
                for F in ref)
    assert n_oracle == out["oracle_by_kind"]
    rate_ref = {k: h[0] / n_oracle[k] for k, h in hits.items()}
    rate = out["recovery_by_kind"]
    assert rate_ref["generic"] >= 0.99 and rate_ref["near_planar"] >= 0.97
    for kind in ("generic", "near_planar"):
        assert abs(rate[kind] - rate_ref[kind]) <= 0.01, (rate, rate_ref)
    assert abs(rate["small_baseline"] - rate_ref["small_baseline"]) <= 0.1


def test_bench_sfm_scale_against_the_tool():
    """16 ring views: the same verified edges as the tool, the ATE within
    0.02 of the tool's, the same keys on stdout."""
    argv = SFM_SCALE_ARGV
    out, ref = run_beside(BENCH_SFM_SCALE.start(),
                          lambda: run_twin("bench_sfm_scale", argv))
    stdout = ref.text
    assert not tool_failures("bench_sfm_scale", out, argv), out
    edges = json.loads(re.search(r"EDGES (\[.*\])", stdout).group(1))
    ref = last_json(stdout)
    assert sorted(map(tuple, edges)) == sorted(out["edges"])
    assert abs(out["ate"] - ref["ate"]) <= 0.02
    assert set(ref) <= set(out)


def test_bench_config5_real_against_the_tool(tmp_path):
    """12 views of the room loop through the real frontend and the
    partitioned BA (4 blocks), the tool with ``--mesh 1``: the same pairs
    and edges, the artifact's keys, the mesh table at n = 1, and the ATE
    within 1.25 times the tool's own plus 0.02 (a 12-view loop is coarse:
    the tool ends at ATE 0.3663 here, 0.2087 at 24 views; CPU runs)."""
    argv = CONFIG5_ARGV
    run = BENCH_CONFIG5_REAL.start(tmp_path)
    out, ref = run_beside(run, lambda: run_twin(
        "bench_config5_real", argv + ["--json", str(tmp_path / "t.json")]))
    assert not tool_failures("bench_config5_real", out, argv), out
    assert [r["mesh_devices"] for r in out["partitioned_ba_scaling"]] == [1]
    ref = json.loads(ref.files["j.json"].read_text())
    assert set(ref) == set(out)
    assert out["pairs"] == ref["pairs"]
    assert out["edges"] == ref["edges"]
    assert out["ate"] <= 1.25 * ref["ate"] + 0.02, (out["ate"], ref["ate"])


def test_bench_city_scale_twin(tmp_path):
    """The twin end to end on 64 views (16 blocks, 3 sweeps): views - 1
    edges, ATE < 2.0 (phase "city"'s gate), the partitioned BA lowering the
    cost; the artifact holds the tool's keys."""
    argv = ["--views", "64", "--json", str(tmp_path / "t.json")]
    out = run_twin("bench_city_scale", argv)
    assert not tool_failures("bench_city_scale", out, argv), out
    art = json.loads((tmp_path / "t.json").read_text())
    assert {"config", "views", "pairs", "ate", "total_s", "stage_times_s",
            "points", "edges", "ba_blocks", "ba_sweeps", "mesh_devices",
            "projected_2x4_efficiency", "note"} == set(art)
