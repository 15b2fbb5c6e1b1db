"""The twins of the last twelve probes of ``scripts/``
(``scripts/torch_probe_*.py``), on the CPU: ten that run without the
reference's photographs and the two that measure match quality on them.

Each twin runs once at a tiny size with ``--device cpu``, through
``chip_smoke.phase_probes`` (so phase "probes"' gates apply to it as on the
card) in three fresh interpreters that import nothing of JAX: its output
must print its probe's stage names in order (``chip_smoke.PROBE_RUNS``, each
name found in the JAX probe's source). Then each twin is held to the
reference on the same inputs, made from the probes' seeds:

- the SfM stage twin's per-stage errors to the JAX probe's own printout
  (x64, 16 and 24 ring views);
- the city stage twin's error functions, fed the reference's
  ``run_global_sfm`` output (saved by the JAX probe's run at 12 views), to
  the probe's printed lines, character for character;
- the dense ablation's pieces, composed, to one
  ``dense_schur_bundle_adjust_strata`` iteration of both packages in
  float64, and its pass A to the probe's own ``pass_a``;
- the dense micro-probe's lowerings and the descriptor micro-probe's eight
  functions to the probes' own functions (``tool_twins.probe_function``);
- the sweep's configurations to the probe's, field by field;
- the tracker's tracks to the reference tracker's;
- the capacity, bisection and descriptor-fault twins' counts and stage
  sums, from their tiny runs, to the JAX programs' at a 96x128 frame, the
  masked slots of the detector and of the peak finder set to zero in both
  packages (their contents are unspecified and differ between the
  packages' top-k tie orders);
- the two quality twins' ``run_with`` under each of their probes' four
  knob settings (orientation maps at stride 1 or 2, nearest or bilinear
  histogram and descriptor sampling) to the probes' own, on a 120x160
  render and its warp at capacity 512: keypoints by overlap, the paired
  keypoints' descriptors, and the match sets (tolerances in the test).

The JAX programs' outputs are their recordings (``tool_twins.Reference``)
where a recording's fingerprint matches the tree; else the programs start
in subprocesses at the module's start and run beside the twins. The
quality program's arrays (3.8 MB, float32 descriptors that do not
compress) would outgrow the recordings' 2 MB, so it always runs live.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "tests", ROOT / "scripts"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from chip_smoke import PROBE_RUNS, load_tool, stages_in_order  # noqa: E402
from probe_source import probe_function  # noqa: E402
from tool_twins import (  # noqa: E402,F401
    OUT, jax_reference, one_torch_thread, start, tool_reference)

# Time limits (s): of the twins' three interpreters, and of each JAX
# program where it runs live; about three times each one's wall time in
# the loaded suite, at least 120 s.
TWINS_SECONDS = 830
SFM_SECONDS = 840
CITY_SECONDS = 860
CAPACITY_SECONDS = 960
QUALITY_SECONDS = 1060
STAGES_SECONDS = 960

HW = "96x128"
HW_PAIR = (96, 128)
HW_SWEEP = "64x96"
HW_QUALITY = "120x160"
DESC_SHAPE = dict(S=2, Hc=24, Wc=32, FB=36, K=16)
SFM_VIEWS = ["16", "20", "24"]
# The view counts held to the JAX probe (each count is a compile there).
SFM_VIEWS_REF = ["16", "24"]
CITY_VIEWS = 12
# Each twin's tiny argv and the module constants patched.
TINY = {
    "probe_sfm_ate_stages": (["--views", *SFM_VIEWS, "--full",
                              "--ba-iters", "5"], {}),
    "probe_city_stages": ([str(CITY_VIEWS)], {}),
    "probe_dense_ablate": (["--cams", "6", "--points", "120", "--obs",
                            "900"], {"REPS": 1}),
    "probe_dense_micro": (["--cams", "16", "--n", "4096"], {"REPS": 1}),
    "probe_desc_micro": ([], {"REPS": 1, "SHAPE": DESC_SHAPE}),
    "probe_frontend_sweep": (["--hw", HW_SWEEP], {"ITERS": 1}),
    "probe_tracker_flat": (["--frames", "24", "--cap", "256",
                            "--batch-frames", "24"], {}),
    "probe_capacity3072": (["--hw", HW], {}),
    "probe_fault_bisect": (["all", "3072", "--hw", HW], {}),
    "probe_fault_desc": (["all", "--hw", HW], {}),
    "probe_dog_quality": (["--hw", HW_QUALITY, "--cap", "512"], {}),
    "probe_sampling_quality": (["--hw", HW_QUALITY], {}),
}
# The tiny runs in three interpreters at once; the last one's stage sums
# are held to the JAX programs', so its masked slots are zeroed
# (``tool_twins.zero_masked_slots``).
GROUPS = (("probe_sfm_ate_stages", "probe_dense_ablate", "probe_dense_micro",
           "probe_desc_micro", "probe_tracker_flat"),
          ("probe_city_stages", "probe_frontend_sweep", "probe_dog_quality",
           "probe_sampling_quality"),
          ("probe_capacity3072", "probe_fault_bisect", "probe_fault_desc"))
ZEROED_GROUP = GROUPS[-1]
RUNS = [run for run in PROBE_RUNS if run[0] in TINY]
NAMES = [run[0] for run in RUNS]
FORBIDDEN = ("jax", "jaxlib", "sara_tpu", "bench")

RUNNER = """
import json, sys
import torch
torch.set_num_threads(1)
sys.path[:0] = [{root!r}, {root!r} + "/tests"]
import chip_smoke
from sara_tpu_torch.ops import patch_sampler as ps
if {zeroed!r}:
    from tool_twins import zero_masked_slots
    zero_masked_slots()
tiny = {tiny!r}
load = chip_smoke.load_tool
def patched(name):
    mod = load(name)
    for k, v in tiny[name][1].items():
        setattr(mod, k, v)
    return mod
chip_smoke.load_tool = patched
runs = [(n, tiny[n][0], c, s) for n, _, c, s in chip_smoke.PROBE_RUNS
        if n in tiny]
out = chip_smoke.phase_probes(ps, "cpu", device="cpu", runs=runs)
printed = {{n: "\\n".join(r["printed"]) for n, r in out.items()
           if n != "sampler_counts"}}
printed["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in {forbidden!r}
                             or m.split(".")[0].startswith("probe_"))
printed["results"] = {{n: out[n]["result"] for n in tiny}}
print("RESULT " + json.dumps(printed, default=str))
"""

# The JAX subprocesses run on one thread each: six of them compile beside
# the twins' three interpreters. All nine run at the workers' own
# priority: a lower one left them waiting for idle cores that the suite's
# six workers seldom leave, and the twins' tiny runs (about 150 CPU
# seconds in all) then outlasted the ``printed`` fixture's 600 s.
ONE_THREAD = ('import os; os.environ["XLA_FLAGS"] = '
              '"--xla_cpu_multi_thread_eigen=false '
              'intra_op_parallelism_threads=1"\n')
# The reference's programs at the twins' inputs, with the detector's and
# the peak finder's masked slots set to zero.
SIFT_PRELUDE = ONE_THREAD + """
import functools, json
import numpy as np
import jax, jax.numpy as jnp
import torch_bench
from probe_source import probe_function
import sara_tpu.features.dog as D
import sara_tpu.features.orientation as O
(a_np, b_np), _ = torch_bench.probe_frames(2, *{hw!r})
a = jnp.asarray(a_np)
def detect_dog_octave(dog, p):
    det = D.detect_dog_octave(dog, p)
    return dict(det, **{{k: jnp.where(det["mask"], det[k], 0)
                        for k in ("x", "y", "s")}})
def find_orientation_peaks(hist, max_peaks):
    theta, ok = O.find_orientation_peaks(hist, max_peaks=max_peaks)
    return jnp.where(ok, theta, 0.0), ok
ZEROED = dict(detect_dog_octave=detect_dog_octave,
              find_orientation_peaks=find_orientation_peaks)
from sara_tpu.features import compute_sift_keypoints
from sara_tpu.features.api import SIFTParams
from sara_tpu.features.dog import DoGParams
"""
# One program per stage of a probe (the probes' own ``prog``, its stage
# static), each list in a subprocess of its own.
JAX_STAGES = """
params = SIFTParams(dog=DoGParams(capacity=3072))
prog = probe_function({probe!r}, "prog",
                      dict(STAGE={stages[0]!r}, params=params), ZEROED)
out = {{st: float(prog(a, stage=st)) for st in {stages!r}}}
if {merge!r}:
    out["merge"] = int(compute_sift_keypoints(a, params).count())
print(json.dumps(out))
"""
JAX_CAPACITY = """
from sara_tpu.matching import MatchParams, match_descriptors
p = SIFTParams()
ka = compute_sift_keypoints(a, p)
kb = compute_sift_keypoints(jnp.asarray(b_np), p)
m = match_descriptors(ka, kb, MatchParams(ratio=0.8))
print(json.dumps(dict(n_a=int(ka.count()), n_b=int(kb.count()),
                      matches=int(m.count()))))
"""
CITY_KEYS = ("edges", "edge_R", "edge_t", "R", "t", "centers_averaged")
JAX_CITY = ONE_THREAD + """
import numpy as np
import sara_tpu.sfm.global_sfm as g
run = g.run_global_sfm
def saved(*a, **k):
    o = run(*a, **k)
    np.savez({path!r}, **{{k: np.asarray(o[k]) for k in {keys!r}}})
    return o
g.run_global_sfm = saved
import probe_city_stages
sys.argv = ["probe_city_stages", "{views}"]
probe_city_stages.main()
"""

# The quality probes at the tests' size: a render and its warp (cv2, the
# tool's), capacity 512.
QUALITY_HW = (120, 160)
QUALITY_CAP = 512


def dog_probe_configs() -> list:
    """The four (label, knobs) of ``scripts/probe_dog_quality.py``'s
    ``main`` (its ``configs``), read from its source."""
    import ast

    tree = ast.parse((ROOT / "scripts" / "probe_dog_quality.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in main.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "configs")
    return eval(compile(ast.Expression(node.value), "configs", "eval"), {})


# (probe, knobs) of each case: the dog probe's four configurations, then
# the sampling probe's hist x desc nearest at stride 2.
QUALITY_CASES = (
    [("probe_dog_quality", kw) for _, kw in dog_probe_configs()]
    + [("probe_sampling_quality", dict(ds=2, desc_nearest=d,
                                       hist_nearest=h))
       for h in (False, True) for d in (False, True)])
QUALITY_IDS = [
    f"{p[len('probe_'):-len('_quality')]}-ds{kw['ds']}"
    f"-hist_{'near' if kw['hist_nearest'] else 'bilin'}"
    f"-desc_{'near' if kw['desc_nearest'] else 'bilin'}"
    for p, kw in QUALITY_CASES]
KP_FIELDS = ("xy", "scale", "orientation", "descriptors", "mask")
# The probes' own code on the render: the dog probe's ``run_with``, and the
# sampling probe's loop body (its ``SIFTParams(orientation_downsample=2)``
# with the two knobs) at the same capacity; every ``compute_sift_keypoints``
# result is kept, and saved with the matches and both images.
JAX_QUALITY = ONE_THREAD + """
import dataclasses
import numpy as np
import jax.numpy as jnp
import torch_bench
import eval_detection_quality as q
import probe_dog_quality
import sara_tpu.features as F
from sara_tpu.features import SIFTParams
from sara_tpu.matching import MatchParams, match_descriptors
(img,), _ = torch_bench.probe_frames(1, *{hw!r})
H = q.make_warp(*img.shape)
warped = q.warp_image(img, H)
seen = []
run = F.compute_sift_keypoints
def kept(im, p):
    seen.append(run(im, p))
    return seen[-1]
F.compute_sift_keypoints = kept
def sampling(ds, desc_nearest, hist_nearest, cap):
    p = dataclasses.replace(SIFTParams(orientation_downsample=ds),
                            hist_sample_nearest=hist_nearest,
                            desc_sample_nearest=desc_nearest)
    p = dataclasses.replace(p, total_capacity=cap,
                            dog=dataclasses.replace(p.dog, capacity=cap // 2))
    ka = F.compute_sift_keypoints(jnp.asarray(img), p)
    kb = F.compute_sift_keypoints(jnp.asarray(warped), p)
    m = match_descriptors(ka, kb, MatchParams(ratio=0.8))
    sel_a, sel_b = np.asarray(ka.mask), np.asarray(kb.mask)
    ra, rb = np.cumsum(sel_a) - 1, np.cumsum(sel_b) - 1
    mm = np.asarray(m.mask)
    return np.stack([ra[np.asarray(m.i)[mm]], rb[np.asarray(m.j)[mm]]], 1)
out = dict(img=img, warped=warped)
for c, (probe, kw) in enumerate({cases!r}):
    seen.clear()
    if probe == "probe_dog_quality":
        pairs = probe_dog_quality.run_with(img, warped, cap={cap}, **kw)[2]
    else:
        pairs = sampling(cap={cap}, **kw)
    out[f"{{c}}_pairs"] = np.asarray(pairs, np.int64).reshape(-1, 2)
    for side, k in zip("ab", seen):
        for f in {fields!r}:
            out[f"{{c}}_{{side}}_{{f}}"] = np.asarray(getattr(k, f))
np.savez({path!r}, **out)
print("saved", len({cases!r}))
"""


# The JAX programs of the SfM stages (x64), the city stages and the three
# frontend probes.
PRELUDE = SIFT_PRELUDE.format(hw=HW_PAIR)
STAGES = {
    "bisect_a": ("probe_fault_bisect", ("detect", "orient", "peaks"), False),
    "bisect_b": ("probe_fault_bisect", ("compact", "desc"), True),
    "desc": ("probe_fault_desc", ("gather", "einsum"), False)}
JAX_RUNS = {
    "sfm": tool_reference(
        "probes_queue.sfm", "probe_sfm_ate_stages",
        ["--views"] + SFM_VIEWS_REF, SFM_SECONDS, patch=ONE_THREAD,
        cpu_flag=False, x64=True),
    "city": jax_reference(
        "probes_queue.city", JAX_CITY.format(
            path=f"{OUT}/out.npz", keys=CITY_KEYS, views=CITY_VIEWS),
        CITY_SECONDS, files=("out.npz",)),
    "capacity": jax_reference("probes_queue.capacity",
                              PRELUDE + JAX_CAPACITY, CAPACITY_SECONDS),
    **{name: jax_reference(f"probes_queue.{name}", PRELUDE + JAX_STAGES.format(
        probe=probe, stages=st, merge=merge), STAGES_SECONDS)
       for name, (probe, st, merge) in STAGES.items()},
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX programs (``JAX_RUNS``): their recordings, or, where one is
    stale, the program started in a subprocess at the module's start, and
    the quality program, started live; a test waits for its run's standard
    output (``jax_runs(name)``) or its saved file (``jax_runs.file(name)``).
    A live run is killed at the module's end if still running."""
    quality = jax_reference("probes_queue.quality", JAX_QUALITY.format(
        hw=QUALITY_HW, cases=QUALITY_CASES, cap=QUALITY_CAP,
        fields=KP_FIELDS, path=f"{OUT}/out.npz"), QUALITY_SECONDS,
        files=("out.npz",))
    runs = {name: ref.start(tmp_path_factory.mktemp(name))
            for name, ref in JAX_RUNS.items()}
    runs["quality"] = quality.start_live(tmp_path_factory.mktemp("quality"))

    def output(name):
        return runs[name].output().text

    output.file = lambda name: runs[name].output().files["out.npz"]
    yield output
    for run in runs.values():
        run.kill()


@pytest.fixture(scope="module")
def printed(jax_runs):
    """Each twin's output at its tiny size through ``phase_probes``, its
    result, and the forbidden modules the runs imported, from three fresh
    interpreters (while the JAX runs go on)."""
    procs = [start([sys.executable, "-c", RUNNER.format(
        root=str(ROOT), tiny={n: TINY[n] for n in group},
        forbidden=FORBIDDEN, zeroed=group == ZEROED_GROUP)])
        for group in GROUPS]
    out = {"imported": [], "results": {}}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=TWINS_SECONDS)
        assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        res = json.loads(line[len("RESULT "):])
        out["imported"] += res.pop("imported")
        out["results"].update(res.pop("results"))
        out.update(res)
    return out


def test_every_queued_probe_has_a_run_and_a_tiny_size():
    assert sorted(TINY) == sorted(NAMES)
    assert sorted(n for g in GROUPS for n in g) == sorted(NAMES)
    # The other eleven runs are held in tests/test_torch_probes.py.
    assert len(PROBE_RUNS) == 23 and len(NAMES) == 12
    assert all((ROOT / "scripts" / f"torch_{n}.py").exists()
               and (ROOT / "scripts" / f"{n}.py").exists() for n in NAMES)


@pytest.mark.parametrize("run", RUNS, ids=NAMES)
def test_twin_prints_its_probes_stages(run, printed):
    """The twin's output holds its probe's stage names in the probe's
    order, and each name is the probe's own (in its source)."""
    name, _, _, stages = run
    source = (ROOT / "scripts" / f"{name}.py").read_text()
    assert all(s in source for s in stages), name
    assert not stages_in_order(printed[name], stages), printed[name]


def test_twins_import_no_jax(printed):
    """No twin imports JAX, ``sara_tpu``, ``bench`` or a JAX probe."""
    assert printed["imported"] == []


@pytest.mark.parametrize("name", NAMES)
def test_twin_without_a_card_raises(name):
    """Without ``--device cpu`` a twin takes the card, and without one it
    raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_tool(name).main(TINY[name][0])


def test_sfm_stages_against_the_probe(jax_runs):
    """The same noisy edges (16 and 24 ring views) through both
    packages' rotation averaging, translation averaging and pose-graph
    polish in float64: each printed error (mean and max rotation error,
    the two ATEs) within 2e-4 of the probe's (printed to 4 decimals)."""
    rows = re.findall(
        r"V=\s*(\d+) edges=\s*(\d+) rot_err mean=([\d.]+) max=([\d.]+) deg"
        r" \| ATE ta=([\d.]+) pg=([\d.]+)", jax_runs("sfm"))
    twin = load_tool("probe_sfm_ate_stages").main(
        ["--views", *SFM_VIEWS_REF, "--dtype", "float64", "--device",
         "cpu"])
    assert [r[0] for r in rows] == SFM_VIEWS_REF
    for V, edges, *nums in rows:
        got = twin[int(V)]
        assert got["edges"] == int(edges)
        for key, want in zip(("rot_err_mean", "rot_err_max", "ate_ta",
                              "ate_pg"), nums):
            assert abs(got[key] - float(want)) <= 2e-4, (V, key, got, want)


def test_city_error_functions_on_the_reference_output(jax_runs, capsys):
    """The twin's error report fed the reference's ``run_global_sfm``
    output on 12 city views prints the JAX probe's lines exactly."""
    ref = jax_runs("city")
    twin = load_tool("probe_city_stages")
    scene = load_tool("bench_city_scale_scene")
    _, centers, _ = scene.make_city_scene(CITY_VIEWS, device="cpu")
    n_pairs = len(scene.proximity_pairs(centers))
    arrays = dict(np.load(jax_runs.file("city")))
    arrays["edges"] = [tuple(e) for e in arrays["edges"]]
    capsys.readouterr()
    twin.report(arrays, scene.gt_rotations(CITY_VIEWS), centers, n_pairs)
    lines = capsys.readouterr().out.strip().splitlines()
    want = [ln for ln in ref.splitlines()
            if ln.startswith(("edges ", "global rotations", "final ATE",
                              "post-averaging ATE"))]
    assert len(want) == 4 and lines == want


def test_dense_ablate_pieces_against_both_solvers_float64():
    """In float64 (C=6, P=120, O=900): the twin's pieces composed give one
    ``dense_schur_bundle_adjust_strata`` iteration's cost, the port's
    within 1e-9 and the reference's within 1e-6 relative; each pass A
    variant's Ucat, and the right-hand side of "noS" and "full", equal
    the probe's own ``pass_a`` within 1e-9 relative (its S contraction
    runs in bfloat16 even in float64, so S is held to the port's solver:
    "full" is ``_chunk_stats``)."""
    import jax.numpy as jnp

    from sara_tpu.ba import BAProblem as JBAProblem
    from sara_tpu.ba import dense_schur as JDS
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.dense_schur import (
        dense_schur_bundle_adjust_strata, pack_pt_major_strata)
    from torch_bench_ba import make_problem

    twin = load_tool("probe_dense_ablate")
    prob = make_problem(6, 120, 900, device="cpu")
    prob = prob._replace(**{f: getattr(prob, f).double() for f in
                            ("poses", "points", "intrinsics", "uv")})
    strata, _, stats = pack_pt_major_strata(prob)
    Qs = tuple(stats["chunks"])
    opts = BAOptions(max_iters=1)
    got = float(twin.compose(strata, Qs, opts))
    _, _, info = dense_schur_bundle_adjust_strata(tuple(strata), opts, Qs)
    assert abs(got - float(info["final_cost"])) <= 1e-9 * got

    jprob = JBAProblem(*(None if t is None else jnp.asarray(t.numpy())
                         for t in prob))
    jstrata, _, jstats = JDS.pack_pt_major_strata(jprob)
    jQs = tuple(jstats["chunks"])
    _, _, jinfo = JDS.dense_schur_bundle_adjust_strata(tuple(jstrata), opts,
                                                       jQs)
    assert abs(got - float(jinfo["final_cost"])) <= 1e-6 * got

    pass_a = probe_function("probe_dense_ablate", "pass_a", dict(
        strata=jstrata, Qs=jQs, C=6, dt=jnp.float64,
        lam=jnp.asarray(opts.lambda_init, jnp.float64), delta=4.0,
        cutoff=6.0))
    mine, _, _, _ = twin.pieces(strata, Qs, opts)

    free = ~prob.pose_fixed.numpy()

    def close(a, b):
        # The free cameras' rows: the port zeroes the fixed camera's
        # blocks in pass A, the probe's body leaves them.
        a, b = a.numpy()[free], np.asarray(b)[free]
        return np.abs(a - b).max() <= 1e-9 * np.abs(b).max()

    for mode in twin.MODES:
        u, s, rh = mine(mode)
        ju, _, jrh = pass_a(jstrata[0].poses, mode)
        assert close(u, ju), mode
        if mode != "jac":
            assert close(rh, jrh), mode
        if mode != "full":
            assert not s.any(), mode


def test_dense_micro_lowerings_equal_the_probes_rank3_float64():
    """At N = 4096 slots and 16 cameras in float64: every Ucat lowering of
    the twin (``pairs`` mapped onto the 42 columns) equals the probe's
    ``ucat_rank3`` within 1e-12 relative, each function the probe's
    namesake, and the pose sums the probe's."""
    import jax
    import jax.numpy as jnp

    twin = load_tool("probe_dense_micro")
    N, C = 4096, 16
    inputs = twin.make_inputs(N, C, "cpu", torch.float64)
    jin = [jnp.asarray(t.numpy()) for t in inputs]
    ns = dict(np=np, N=N, C=C, II=np.repeat(np.arange(6), 6),
              JJ=np.tile(np.arange(6), 6))
    ns["IIp"], ns["JJp"] = np.triu_indices(14)
    probe = {name: probe_function("probe_dense_micro", fn, ns) for name, fn
             in zip(twin.NAMES, ("ehot_only", "ucat_rank3", "ucat_take",
                                 "ucat_pairs", "ucat_stack", "pose_mm",
                                 "pose_gather"))}
    mine = twin.lowerings(C)
    want = np.asarray(probe["rank3"](*jin[:5]))
    scale = np.abs(want).max()
    for name in twin.NAMES:
        args = {"onehot": jin[4:5], "poseMM": jin[4:],
                "poseGather": jin[4:]}.get(name, jin[:5])
        ref = np.asarray(probe[name](*args))
        got = mine[name](*inputs).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(),
                                                       1.0), name
        if name in ("rank3", "take", "stack42", "pairs"):
            if name == "pairs":
                got = twin.as_ucat(torch.as_tensor(got)).numpy()
            assert np.abs(got - want).max() <= 1e-12 * scale, name
    assert jax.config.jax_enable_x64


def test_desc_micro_functions_equal_the_probes():
    """On maps (2, 24, 32, 36) bfloat16 and K = 16 slots from the probe's
    seed: each of the eight timed functions equals the probe's own within
    1e-5 relative (float32 sums in another order)."""
    import jax.numpy as jnp

    twin = load_tool("probe_desc_micro")
    inp = twin.make_inputs("cpu", **DESC_SHAPE)
    j = {k: jnp.asarray(v.float().numpy()) for k, v in inp.items()}
    j["maps"] = j["maps"].astype(jnp.bfloat16)
    j["si"] = jnp.asarray(inp["si"].numpy())
    ns = dict(np=np, maps=j["maps"], NO=twin.NO,
              **{k: v for k, v in DESC_SHAPE.items()})
    names = ("gathers", "wfo_build", "einsum_collapse", "fixed_gemm_shift",
             "lowe", "peaks", "argmax_peaks", "sample_hist")
    mine = twin.functions(inp["maps"])
    assert len(mine) == len(names)
    for (label, (fn, keys)), probe_name in zip(mine.items(), names):
        ref = float(probe_function("probe_desc_micro", probe_name, ns)(
            *(j[k] for k in keys)))
        got = float(fn(*(inp[k] for k in keys)))
        assert abs(got - ref) <= 1e-5 * max(abs(ref), 1.0), (label, got, ref)


def test_frontend_sweep_configs_equal_the_probes():
    """The six configurations, field by field, the probe's; the one
    deviation of the port's defaults (``low_precision``, which the
    reference applies only on a TPU) aside."""
    import dataclasses

    import probe_frontend_sweep

    mine = load_tool("probe_frontend_sweep").configs()
    ref = probe_frontend_sweep.configs()
    assert list(mine) == list(ref)
    for name in ref:
        a, b = dataclasses.asdict(mine[name]), dataclasses.asdict(ref[name])
        assert a.pop("low_precision") is False
        assert b.pop("low_precision") is True
        assert a == b, name


def test_tracker_runs_equal_the_reference_trackers(monkeypatch):
    """24 frames of 256 features: the twin's tracker, native and NumPy,
    ends with the reference tracker's tracks (the same run in the JAX
    probe, its tracker recorded)."""
    import probe_tracker_flat
    import sara_tpu.sfm.tracker as jtracker

    made = []

    class Recorded(jtracker.FeatureTracker):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(jtracker, "FeatureTracker", Recorded)
    twin = load_tool("probe_tracker_flat")
    for native in (True, False):
        marks, got = twin.run(24, 256, native)
        ref_marks = probe_tracker_flat.run(24, 256, native)
        ref = made[-1]
        assert sorted(marks) == sorted(ref_marks) == [3, 6, 12, 18, 23]
        assert got.num_tracks == ref.num_tracks > 0
        np.testing.assert_array_equal(got.track_of_feature,
                                      ref.track_of_feature)
        np.testing.assert_array_equal(got.rep_of_track, ref.rep_of_track)


# Stage sums of the two packages: float32 sums of 10^3-10^5 terms in
# other orders.
ACC_RTOL = 1e-4


def test_fault_bisect_stages_equal_the_jax_programs(jax_runs, printed):
    """At a 96x128 frame, masked slots zeroed in both packages: every
    prefix's acc within ``ACC_RTOL`` of the probe's ``prog``, the merged
    keypoint count equal."""
    got = printed["results"]["probe_fault_bisect"]
    ref = {k: v for part in ("bisect_a", "bisect_b") for k, v in json.loads(
        jax_runs(part).strip().splitlines()[-1]).items()}
    assert sorted(got) == sorted(ref)
    assert ref["merge"] == got["merge"] > 50
    for st in ("detect", "orient", "peaks", "compact", "desc"):
        assert abs(got[st] - ref[st]) <= ACC_RTOL * abs(ref[st]), (st, got,
                                                                  ref)


def test_fault_desc_stages_equal_the_jax_programs(jax_runs, printed):
    """At a 96x128 frame, masked slots zeroed in both packages: every
    stage's acc within ``ACC_RTOL`` of the probe's ``prog``; whole and in
    sections, the twin's descriptors are equal. The probe's "full" stage
    is the bisection probe's "desc" prefix (the same descriptors, summed
    with the same count), and at 96x128 every octave's K2 is under 1,920,
    so its "chunk" program is "full" in one section: both are held to the
    JAX "desc" prefix."""
    got = printed["results"]["probe_fault_desc"]
    ref = json.loads(jax_runs("desc").strip().splitlines()[-1])
    full = json.loads(jax_runs("bisect_b").strip().splitlines()[-1])["desc"]
    ref.update(full=full, chunk=full)
    assert got.pop("full_vs_chunk") == 0.0
    assert sorted(got) == sorted(ref)
    for st, want in ref.items():
        assert abs(got[st] - want) <= ACC_RTOL * abs(want), (st, got, ref)


def test_capacity_counts_equal_the_jax_program(jax_runs, printed):
    """At 96x128 with ``SIFTParams()``: both frames' keypoint counts and the
    match count equal the reference's (the masked slots play no part); on
    the probe's synthetic scene the twin's relative pose passes the
    probe's assert, every point an inlier."""
    got = printed["results"]["probe_capacity3072"]
    ref = json.loads(jax_runs("capacity").strip().splitlines()[-1])
    assert (got["n_a"], got["n_b"], got["matches"]) == (
        ref["n_a"], ref["n_b"], ref["matches"])
    assert ref["matches"] > 20
    assert got["inliers"] == got["n"] == 300
    assert got["rerr"] < 0.5 and got["terr"] < 1.0


def test_dog_twin_configs_are_the_probes():
    """The dog twin's four configurations are its probe's, label for
    label."""
    assert load_tool("probe_dog_quality").CONFIGS == dog_probe_configs()


def _pair_keypoints(ref: dict, got) -> tuple:
    """Pair each valid reference keypoint (``ref``: the saved fields) with
    the twin's (``got``: port Keypoints) nearest in position + orientation
    (``tests/test_torch_sift.py``'s rule): (paired mask over the
    reference's rows, the twin's row of each)."""
    mj, mt = ref["mask"].astype(bool), got.mask.numpy()
    xj, xt = ref["xy"][mj], got.xy.numpy()[mt]
    oj, ot = ref["orientation"][mj], got.orientation.numpy()[mt]
    dpos = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
    dang = np.abs(np.angle(np.exp(1j * (oj[:, None] - ot[None]))))
    nn = (dpos + dang).argmin(axis=1)
    rows = np.arange(len(nn))
    return (dpos[rows, nn] < 0.5) & (dang[rows, nn] < 1e-2), nn


def _match_share(xa, xb, pairs, ya, yb, other) -> float:
    """Share of the matches ``pairs`` (rows into ``xa``, ``xb``) with a
    match of ``other`` (rows into ``ya``, ``yb``) within 0.5 px at both
    ends."""
    if len(pairs) == 0:
        return 1.0
    a, b = xa[pairs[:, 0]], xb[pairs[:, 1]]
    c, d = ya[other[:, 0]], yb[other[:, 1]]
    near = ((np.linalg.norm(a[:, None] - c[None], axis=-1) < 0.5)
            & (np.linalg.norm(b[:, None] - d[None], axis=-1) < 0.5))
    return float(near.any(axis=1).mean())


@pytest.mark.parametrize("case", range(len(QUALITY_CASES)), ids=QUALITY_IDS)
def test_quality_twin_against_the_probe(case, jax_runs, monkeypatch):
    """The twin's ``run_with`` against its probe's own code (the dog
    probe's ``run_with``, the sampling probe's loop body) at one knob
    setting, on the same 120x160 render and its cv2 warp at capacity 512,
    the reference without x64. On each image: the keypoint counts within
    2%, >= 98% of the reference's keypoints paired (within 0.5 px and
    1e-2 rad, ``tests/test_torch_sift.py``'s pairing), and the paired
    descriptors >= 99% within 1e-3 and >= 90% within 1e-4 (max abs). The
    sift test holds 95% within 1e-4 on its fixture; on the warp's
    interpolated pixels Newton refinement is conditioned worse, and 6-7%
    of the warped side's descriptors move by 1e-4..1e-3 while every
    keypoint pairs and the match sets are equal (measured: 92.98-94.13%
    within 1e-4, >= 99.67% within 1e-3 on either image; a flipped nearest
    sample moves one by up to 0.02). The matches: counts within 2%, >= 98%
    of each side's found among the other's (both ends within 0.5 px).
    The first end-to-end test of nearest histogram sampling and of
    stride-2 maps through ``compute_sift_keypoints``."""
    import sara_tpu_torch.features as TF

    d = np.load(jax_runs.file("quality"))
    probe, kw = QUALITY_CASES[case]
    seen, run = [], TF.compute_sift_keypoints

    def kept(im, p, device=None):
        seen.append(run(im, p, device=device))
        return seen[-1]

    monkeypatch.setattr(TF, "compute_sift_keypoints", kept)
    xa, xb, pairs = load_tool(probe).run_with(
        d["img"], d["warped"], cap=QUALITY_CAP, device="cpu", **kw)
    assert len(seen) == 2
    ys = []
    for side, got in zip("ab", seen):
        ref = {f: d[f"{case}_{side}_{f}"] for f in KP_FIELDS}
        mj = ref["mask"].astype(bool)
        nj, nt = int(mj.sum()), int(got.count())
        assert nj > 100 and abs(nj - nt) <= 0.02 * nj, (side, nj, nt)
        paired, nn = _pair_keypoints(ref, got)
        assert paired.mean() >= 0.98, (side, paired.mean())
        dj = ref["descriptors"][mj][paired]
        dt = got.descriptors.numpy()[got.mask.numpy()][nn[paired]]
        err = np.abs(dj - dt).max(axis=1)
        assert (err <= 1e-3).mean() >= 0.99, (side, (err <= 1e-3).mean())
        assert (err <= 1e-4).mean() >= 0.90, (side, (err <= 1e-4).mean())
        ys.append(ref["xy"][mj])
    ref_pairs = d[f"{case}_pairs"]
    assert len(ref_pairs) > 50
    assert abs(len(pairs) - len(ref_pairs)) <= 0.02 * len(ref_pairs)
    assert _match_share(xa, xb, pairs, *ys, ref_pairs) >= 0.98
    assert _match_share(*ys, ref_pairs, xa, xb, pairs) >= 0.98
