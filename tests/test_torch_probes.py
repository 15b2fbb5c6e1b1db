"""The probe twins ``scripts/torch_probe_*.py`` on the CPU.

Each twin's ``main`` runs at a tiny size with ``--device cpu`` in one
subprocess that imports nothing of JAX (and then reports whether JAX,
``sara_tpu``, ``bench`` or a JAX probe got imported); its output must
print its probe's stage names in order (``chip_smoke.PROBE_RUNS``, each
name found in the JAX probe's source). Then the pieces each twin times
are held to the port's pipeline and to the reference: the frontend's full
prefixes to ``compute_sift_keypoints`` and ``_process_octave``, twin 4's
kernel route to its bilinear gather, twin 9's segment sums to
``jax.ops.segment_sum``, twin 7's composed pieces to one dense-Schur
iteration in float64, and the two batch probes' twins to the JAX probes
at the same tiny size, the photographs replaced by ``make_room(seed=1)``
as the twins replace them: their recordings (``tool_twins.Reference``)
where a recording's fingerprint matches the tree, else the probes run live
in subprocesses started with the twins' run.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "tests"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from chip_smoke import PROBE_RUNS, load_tool, stages_in_order  # noqa: E402
from tool_twins import (  # noqa: E402
    PROCEDURAL_ROOM, json_fields, tool_reference)

# Time limits (s): of the twins' interpreter, and of each JAX probe where
# it runs live; about three times each one's wall time in the loaded
# suite, at least 120 s.
TWINS_SECONDS = 760
BATCH_PARITY_SECONDS = 800
AB_VO_SECONDS = 820

HW = (64, 96)
# The tiny sizes of the two batch probes, for the twin and the JAX probe
# alike: at 180x240 the five frames are all accepted in both packages.
BATCH_PARITY_ARGV = ["--frames", "3", "--width", "128", "--height", "96"]
AB_VO_ARGV = ["--frames", "5", "--seeds", "1", "--width", "240", "--height",
              "180"]
JAX_PROBES = {name: tool_reference(
    f"probes.{name}", name, argv, seconds, patch=PROCEDURAL_ROOM,
    varies=varies)
    for name, argv, seconds, varies in (
        ("probe_batch_parity", BATCH_PARITY_ARGV, BATCH_PARITY_SECONDS, ()),
        ("probe_ab_vo", AB_VO_ARGV, AB_VO_SECONDS,
         (json_fields("ms_per_frame"),)))}
# The tiny sizes: each twin's argv and the module constants patched.
TINY = {
    "probe_sift_stages": ([], {"ITERS": 1}),
    "probe_sift_prefix": (["128", "2"], {"ITERS": 1}),
    "probe_trace_frontend": (["128"], {}),
    "probe_pallas_sampler": ([], {"REPS": 1, "SHAPE": dict(
        S=2, H=24, W=32, C=36, K=16, N=16)}),
    "probe_vo_stages": (["--hw", "96x128", "--samples", "32"],
                        {"REPS": 1}),
    "probe_ba_stages": (["--cams", "6", "--points", "120", "--obs", "900",
                         "--cg", "3"], {"REPS": 1}),
    "probe_dense_ba": (["--cams", "6", "--points", "120", "--obs", "900"],
                       {"REPS": 1}),
    "probe_dense_passA": (["--cams", "6", "--points", "120", "--obs",
                           "900"], {"REPS": 1}),
    "probe_segsum": (["--obs", "2048", "--cams", "16", "--points", "300"],
                     {"REPS": 1}),
    "probe_batch_parity": (BATCH_PARITY_ARGV, {}),
    "probe_ab_vo": (AB_VO_ARGV, {}),
}
# This module's eleven runs (the last ten: tests/test_torch_probes_queue.py).
RUNS = [run for run in PROBE_RUNS if run[0] in TINY]
NAMES = [run[0] for run in RUNS]
FORBIDDEN = ("jax", "jaxlib", "sara_tpu", "bench")

RUNNER = """
import contextlib, io, json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
import torch_bench
from chip_smoke import load_tool
full = torch_bench.load_pair
torch_bench.load_pair = lambda: full{hw!r}
out = {{}}
for name, (argv, patch) in {tiny!r}.items():
    mod = load_tool(name)
    for k, v in patch.items():
        setattr(mod, k, v)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), \\
            contextlib.redirect_stderr(printed):
        mod.main(argv + ["--device", "cpu"])
    out[name] = printed.getvalue()
out["imported"] = sorted(m for m in sys.modules
                         if m.split(".")[0] in {forbidden!r}
                         or m.split(".")[0].startswith("probe_"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_probes():
    """The two JAX batch probes at the twins' tiny sizes, the photographs
    replaced by ``make_room(seed=1)`` (``JAX_PROBES``): their recordings,
    or, where one is stale, the probe started in a subprocess before the
    twins run (mostly JAX compiles); a test waits for its probe's
    standard output. A live run is killed at the module's end if still
    running."""
    runs = {name: ref.start() for name, ref in JAX_PROBES.items()}
    yield lambda name: runs[name].output().text
    for run in runs.values():
        run.kill()


@pytest.fixture(scope="module")
def printed(jax_probes):
    """Each twin's output at its tiny size, and the forbidden modules the
    run imported, from one fresh interpreter (while the JAX probes run)."""
    code = RUNNER.format(root=str(ROOT), hw=HW, tiny=TINY,
                         forbidden=FORBIDDEN)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True,
                       timeout=TWINS_SECONDS)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_every_probe_run_has_a_twin_and_a_tiny_size():
    assert sorted(TINY) == sorted(NAMES) and len(NAMES) == 11
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


@pytest.fixture(scope="module")
def pair_a():
    import torch_bench

    return torch.as_tensor(torch_bench.load_pair(*HW)[0])


def test_sift_stages_full_prefix_is_compute_sift_keypoints(pair_a):
    """Twin 1's last prefix is the port's ``compute_sift_keypoints``: the
    same keypoints, field by field."""
    from sara_tpu_torch.features.api import (SIFTParams,
                                             compute_sift_keypoints)

    params = SIFTParams(total_capacity=512)
    fns = load_tool("probe_sift_stages").stage_fns(pair_a, params)
    got = fns["+descr"]()
    want = compute_sift_keypoints(pair_a, params, device="cpu")
    assert int(want.count()) > 10
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sift_prefix_desc_is_process_octave(pair_a):
    """Twin 2's prefixes rebuild ``_process_octave`` step by step: its
    "desc" prefix sums exactly the descriptors and masks of each octave of
    ``compute_sift_keypoints`` before the merge, and its "detect" prefix
    the detector's outputs."""
    from sara_tpu_torch.features.api import SIFTParams, _process_octave
    from sara_tpu_torch.features.dog import DoGParams, detect_dog_octave
    from sara_tpu_torch.image.pyramid import dog_pyramid, gaussian_pyramid

    params = SIFTParams(dog=DoGParams(capacity=128, refine_iters=2))
    twin = load_tool("probe_sift_prefix")
    gp = gaussian_pyramid(pair_a, params.pyramid)
    dg = dog_pyramid(gp)
    desc = det = 0.0
    for gauss, dog in zip(gp.octaves, dg.octaves):
        s_, h_, w_ = dog.shape
        cap = min(params.dog.capacity, max(64, (s_ * h_ * w_) // 512))
        p = dataclasses.replace(params, dog=dataclasses.replace(
            params.dog, capacity=cap))
        out = _process_octave(gauss, dog, p, gp.sigmas)
        desc = desc + out["desc"].float().sum() + out["mask"].sum()
        d = detect_dog_octave(dog, p.dog)
        det = det + d["x"].sum() + d["mask"].sum()
    assert torch.equal(twin.per_octave("desc", pair_a, params), desc)
    assert torch.equal(twin.per_octave("detect", pair_a, params), det)


def test_pallas_twin_kernel_route_equals_bilinear_gather():
    """Twin 4 on float32 maps: its "pallas patches" route (the kernel's
    plain version on the CPU) within 1e-6 of its bilinear row gathers,
    and its nearest gathers reading the rounded positions."""
    twin = load_tool("probe_pallas_sampler")
    maps, si, ys, xs = twin.make_inputs("cpu", torch.float32, S=3, H=40,
                                        W=48, C=36, K=64, N=16)
    fns = twin.samplers(maps, si)
    kern = fns["pallas patches"](ys, xs)
    bil = fns["xla bilinear"](ys, xs)
    assert kern.shape == (64, 16, 36)
    assert float((kern - bil).abs().max()) <= 1e-6
    near = fns["xla nearest"](ys.round(), xs.round())
    assert float((near - fns["xla bilinear"](ys.round(), xs.round()))
                 .abs().max()) <= 1e-6


@pytest.mark.parametrize("nseg,k", [(256, 36), (60_000, 9)],
                         ids=["U-blocks", "V-blocks"])
def test_segsum_twin_matches_jax_segment_sum(nseg, k):
    """Twin 9's variants on the probe's data at O = 4096 against
    ``jax.ops.segment_sum`` on the same float32 input: the scatters within
    1e-5 relative (per segment over |segment| + mean |segment|, the
    probe's measure), the cumsums within sqrt(O) = 64 float32 epsilons of
    the largest prefix sum (a segment is the difference of two rounded
    prefixes; phase "probes"' bound)."""
    import jax
    import jax.numpy as jnp

    twin = load_tool("probe_segsum")
    idx, data, _ = twin.problem(np.random.RandomState(0), 4096, nseg, k)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(data, jnp.float32), jnp.asarray(idx), nseg),
        np.float64)
    for name, fn in twin.variants(torch.as_tensor(idx), nseg).items():
        got = fn(torch.as_tensor(data)).double().numpy()
        if "cumsum" in name:
            assert twin.prefix_eps(got, want, data) <= 64.0, name
        else:
            assert twin.rel_err(got, want) <= 1e-5, name


def test_dense_ba_composed_pieces_equal_one_iteration_float64():
    """Twin 7's pieces (pass A, the solve, pass B, the cost) composed into
    one LM step with accept / reject give ``dense_schur_bundle_adjust``'s
    one-iteration cost within 1e-6 relative, in float64; the step is
    accepted."""
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.dense_schur import (dense_schur_bundle_adjust,
                                               pack_pt_major, ptm_cost)

    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_bench_ba import make_problem

    twin = load_tool("probe_dense_ba")
    prob = make_problem(8, 300, 2400, device="cpu")
    prob = prob._replace(**{f: getattr(prob, f).double() for f in
                            ("poses", "points", "intrinsics", "uv")})
    ptm, stats = pack_pt_major(prob)
    Q = stats["chunk"]
    opts = BAOptions(max_iters=1)
    got = float(twin.compose(ptm, Q, opts))
    _, _, info = dense_schur_bundle_adjust(ptm, opts, Q)
    want = float(info["final_cost"])
    assert abs(got - want) <= 1e-6 * abs(want)
    assert want < float(ptm_cost(ptm, ptm.poses, ptm.points, 4.0, 6.0, Q))


@pytest.mark.parametrize("name", ["torch_bench"] + NAMES)
def test_twin_without_a_card_raises(name):
    """Without ``--device cpu`` a twin takes the card, and without one it
    raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import torch_bench

    mod = torch_bench if name == "torch_bench" else load_tool(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_batch_parity_twin_against_jax_probe(printed, jax_probes):
    """The twin of ``probe_batch_parity`` and the JAX probe on the same
    three 96x128 frames: the same stages; on the CPU each package's
    batched detection and matching equal its per-frame ones (every
    keypoint within 0.05 px, no mask or index differing); keypoint and
    match counts within 5% + 1 of the probe's; the same RANSAC successes,
    and with the samples the twin hands both its calls (where the probe
    shares its keys) the same inlier masks batched and single."""
    ref = {r["probe"]: r for r in _json_lines(
        jax_probes("probe_batch_parity"))}
    twin = {r["probe"]: r for r in _json_lines(printed["probe_batch_parity"])}
    assert list(twin) == list(ref) == ["setup", "detect", "match", "ransac"]
    for side in (ref, twin):
        assert all(f["frac_matched"] == 1.0
                   for f in side["detect"]["per_frame"])
        assert all(p["mask_diff"] == 0 and p["j_diff_on_common"] == 0
                   for p in side["match"]["per_pair"])
    for t, r in zip(twin["detect"]["per_frame"], ref["detect"]["per_frame"]):
        assert abs(t["n_a"] - r["n_a"]) <= 0.05 * r["n_a"] + 1
    for t, r in zip(twin["match"]["per_pair"], ref["match"]["per_pair"]):
        assert abs(t["n_single"] - r["n_single"]) <= 0.05 * r["n_single"] + 1
    for t, r in zip(twin["ransac"]["per_pair"], ref["ransac"]["per_pair"]):
        assert t["single"]["ok"] == r["single"]["ok"]
        assert t["batch"]["ok"] == r["batch"]["ok"] == t["single"]["ok"]
        assert t["batch_vs_single"]["inlier_mask_diff"] == 0


def test_ab_vo_twin_against_jax_probe(printed, jax_probes):
    """The twin of ``probe_ab_vo`` and the JAX probe on the same five
    180x240 frames, one seed: the same runs in the same order (per_frame,
    batched, then the two summaries); both packages accept all five frames
    in both modes, at an ATE within 0.05 of the probe's."""
    ref = _json_lines(jax_probes("probe_ab_vo"))
    twin = _json_lines(printed["probe_ab_vo"])
    order = [(r.get("mode"), r.get("summary")) for r in ref]
    assert [(r.get("mode"), r.get("summary")) for r in twin] == order == [
        ("per_frame", None), ("batched", None), (None, "per_frame"),
        (None, "batched")]
    for t, r in zip(twin[:2], ref[:2]):
        assert t["seed"] == r["seed"] == 0
        assert t["accepted"] == r["accepted"] == 5
        assert abs(t["ate"] - r["ate"]) <= 0.05
