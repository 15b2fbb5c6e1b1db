"""The port as a package: isolation from JAX, devices, conversion, types."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sara_tpu_torch
from sara_tpu.core import types as jtypes
from sara_tpu.features.api import SIFTParams as JaxSIFTParams
from sara_tpu.matching.brute_force import MatchParams as JaxMatchParams
from sara_tpu_torch.convert import keypoints_from_numpy, params_from_jax
from sara_tpu_torch.core import cameras as tcam
from sara_tpu_torch.core import types as ttypes
from sara_tpu_torch.features.api import SIFTParams, compute_sift_keypoints
from sara_tpu_torch.image.filtering import gaussian_kernel_1d
from sara_tpu_torch.io import load_sfm_state, save_sfm_state
from sara_tpu_torch.sfm.global_sfm import run_global_sfm
from sara_tpu_torch.sfm.loop_closure import LoopCloser
from sara_tpu_torch.sfm.odometry import OdometryConfig, OdometryPipeline

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = (sorted((ROOT / "sara_tpu_torch").rglob("*.py"))
                + sorted((ROOT / "examples").glob("torch_*.py"))
                + sorted((ROOT / "scripts").glob("torch_*.py"))
                + [ROOT / "chip_smoke.py", ROOT / "torch_bench.py"])
# The command-line tools of scripts/ that have no torch_ twin, and why.
TOOLS_WITHOUT_TWIN = {
    "calibrate_camera.py": "its twin is the module sara_tpu_torch/calib/"
                           "cli.py (python -m sara_tpu_torch.calib.cli)",
}
# The probes of scripts/ not ported yet, and why each waits (none is
# declared unnecessary). Every probe has its twin.
PROBES_QUEUED = {}
# The probe twins of the last two slices, loaded by the JAX-free import
# check.
LAST_PROBE_TWINS = ("probe_sfm_ate_stages", "probe_city_stages",
                    "probe_dense_ablate", "probe_dense_micro",
                    "probe_desc_micro", "probe_frontend_sweep",
                    "probe_tracker_flat", "probe_capacity3072",
                    "probe_fault_bisect", "probe_fault_desc",
                    "probe_dog_quality", "probe_sampling_quality")


def test_import_leaves_jax_out():
    code = ("import sys, sara_tpu_torch, sara_tpu_torch.convert, "
            "sara_tpu_torch.features.api, sara_tpu_torch.matching, "
            "sara_tpu_torch.mvg, sara_tpu_torch.ransac, "
            "sara_tpu_torch.ransac.orsa, sara_tpu_torch.core.lie, "
            "sara_tpu_torch.mvg.extra_solvers, sara_tpu_torch.core.cameras, "
            "sara_tpu_torch.image.color, sara_tpu_torch.ba, "
            "sara_tpu_torch.ba.dense_schur, sara_tpu_torch.sfm, "
            "sara_tpu_torch.sfm.odometry, sara_tpu_torch.utils, "
            "sara_tpu_torch.viz, sara_tpu_torch.io, "
            "sara_tpu_torch.sfm.pose_graph_opt, "
            "sara_tpu_torch.sfm.rotation_averaging, "
            "sara_tpu_torch.sfm.edge_scales, sara_tpu_torch.sfm.loop_closure, "
            "sara_tpu_torch.sfm.global_sfm, sara_tpu_torch.utils.log, "
            "sara_tpu_torch.ba.partitioned, sara_tpu_torch.parallel, "
            "sara_tpu_torch.utils.roofline, sara_tpu_torch.calib, "
            "sara_tpu_torch.calib.cli, sara_tpu_torch.calib.squares, "
            "sara_tpu_torch.core.geometry, sara_tpu_torch.image.edges, "
            "sara_tpu_torch.image.edge_chains, sara_tpu_torch.config, "
            "sara_tpu_torch.utils.timing, sara_tpu_torch.utils.clustering, "
            "sara_tpu_torch.utils.admm, sara_tpu_torch.nn, "
            "sara_tpu_torch.tracking, sara_tpu_torch.io.nuscenes, "
            "sara_tpu_torch.io.features_io, sara_tpu_torch.viz.draw, "
            "sara_tpu_torch.features.multiscale, "
            "sara_tpu_torch.features.affine, sara_tpu_torch.features.dense, "
            "sara_tpu_torch.matching.ncc, "
            "sara_tpu_torch.matching.key_proximity, "
            "sara_tpu_torch.core.contours, sara_tpu_torch.image.deriche, "
            "sara_tpu_torch.image.im2col, sara_tpu_torch.image.levelsets, "
            "sara_tpu_torch.image.segmentation, sara_tpu_torch.image.slic; "
            # The quality tool's twin, run through its SIFT and matcher.
            "import chip_smoke, numpy as np; "
            "q = chip_smoke.load_tool('eval_detection_quality'); "
            "img = np.random.RandomState(0).rand(64, 64).astype('f4'); "
            "q.run_ours(img, img, 0, 256, 128, device='cpu'); "
            f"[chip_smoke.load_tool(n) for n in {LAST_PROBE_TWINS!r}]; "
            # The photograph probes' twins, through their SIFT runs.
            "[chip_smoke.load_tool(n).run_with(img, img, 2, True, True, "
            "cap=256, device='cpu') for n in ('probe_dog_quality', "
            "'probe_sampling_quality')]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sara_tpu.')) or m == 'sara_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_demo_twins_are_in_the_source_check():
    """The six demo twins are among the sources checked for JAX."""
    demos = [p.name for p in PORT_SOURCES if p.parent.name == "examples"]
    assert sorted(demos) == sorted(
        f"torch_{p.name}" for p in (ROOT / "examples").glob("*_demo.py")
        if not p.name.startswith("torch_"))
    assert len(demos) == 6


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    for needle in ("import jax", "from jax", "sara_tpu.", "import sara_tpu\n"):
        assert needle not in text, f"{path.name} contains {needle!r}"


def test_entry_point_without_device_raises_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_sift_keypoints(np.zeros((32, 32), np.float32))
    with pytest.raises(RuntimeError):
        sara_tpu_torch.default_device()
    assert sara_tpu_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda **kw: ttypes.Keypoints.empty(4, **kw).xy,
    lambda **kw: ttypes.Matches.empty(3, **kw).i,
    lambda **kw: gaussian_kernel_1d(1.3, **kw),
    lambda **kw: tcam.Pinhole.from_values(300.0, 300.0, 160.0, 120.0,
                                          **kw).fx,
    lambda **kw: tcam.Pinhole.from_matrix(np.eye(3), **kw).u0,
    lambda **kw: tcam.BrownConrady.from_values(300.0, 300.0, 160.0, 120.0,
                                               **kw).k,
    lambda **kw: OdometryPipeline(np.eye(3), **kw)._K,
    lambda **kw: LoopCloser(np.eye(3), **kw)._K,
    lambda **kw: _loaded_pipeline(**kw)._prev_keypoints.descriptors,
], ids=["Keypoints.empty", "Matches.empty", "gaussian_kernel_1d",
        "Pinhole.from_values", "Pinhole.from_matrix",
        "BrownConrady.from_values", "OdometryPipeline", "LoopCloser",
        "load_sfm_state"])
def test_constructors_default_to_the_card(make):
    """Without a device these build on the card, or raise without one; the
    CPU only when asked."""
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert make(device="cpu").device == torch.device("cpu")


def _loaded_pipeline(**kw):
    """A checkpoint of two keypoint frames (written on the CPU) loaded into
    a pipeline built with ``kw``: its restored keypoints follow that
    pipeline's device."""
    import tempfile

    sys.path.insert(0, str(ROOT / "tests"))
    from test_sfm_pipeline import _make_sequence

    kps, _, K = _make_sequence(n_frames=2, noise=0.1)
    cfg = OdometryConfig(rel_pose_samples=100, pnp_samples=100,
                         rel_pose_min_inliers=30, pnp_min_inliers=15)
    # Written where it is read (a generator takes only the state of a
    # generator of its own device type).
    src = kw.get("device", "cuda" if torch.cuda.is_available() else "cpu")
    pipe = OdometryPipeline(K, cfg, device=src)
    for f, kp in enumerate(kps):
        pipe.process_keypoints(keypoints_from_numpy(kp, src), f)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.npz")
        save_sfm_state(path, pipe)
        return load_sfm_state(path, OdometryPipeline(K, cfg, **kw))


def test_run_global_sfm_defaults_to_the_card():
    """run_global_sfm(device=None) resolves the card before any work, and
    raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (the card run is in "
                    "chip_smoke.py's phase global_sfm)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_global_sfm([], np.eye(3))


def test_make_mesh_defaults_to_the_card():
    """make_mesh(device=None) starts its world on the card (NCCL), and
    raises without one instead of falling back to gloo."""
    from sara_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (the card run is in "
                    "chip_smoke.py's phase dist)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("make", ["make_mesh", "make_host_chip_mesh"])
def test_card_mesh_refuses_a_gloo_group(make, monkeypatch, tmp_path):
    """Over a gloo group already started, a mesh on the card raises instead
    of running the card's collectives through gloo (the device check is
    monkeypatched to "cuda", so no card is needed)."""
    import torch.distributed as dist

    from sara_tpu_torch import parallel
    from sara_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="NCCL process group"):
            getattr(parallel, make)()
    finally:
        dist.destroy_process_group()


# --- F1: every public name of a ported module is its twin's ---------------

# The deliberate changes (ROADMAP F1): a torch.Generator where the twin
# takes a PRNG key; no TPU-only arguments (chunked_top_k's ``chunk`` with
# its bound, sample_field_patches' ``interpret``, orientation_maps'
# ``pad_channels``, which pads the channels to the TPU's 128-lane tiles);
# entry points add
# ``device=``. Slice D2 adds the H100's constants where the twin names the
# TPU's (the comm model's links, the roofline's VPU peak).
RENAMED_ARGS = {"key": "generator"}
DROPPED_ARGS = {("ops/topk.py", "chunked_top_k"): {"chunk"},
                ("ops/patch_sampler.py", "sample_field_patches"):
                    {"interpret"},
                ("features/orientation.py", "orientation_maps"):
                    {"pad_channels"}}
ADDED_ARGS = {"device"}
REPLACED_NAMES = {
    "ops/topk.py": {"MAX_TOPK_CHUNK"},               # chunked_top_k's chunk
    "parallel/comm_model.py": {"ICI_BW", "DCN_BW"},  # NVLINK_BW, NIC_BW
    "utils/roofline.py": {"PEAK_VPU_FLOPS"},         # no TPU VPU on a GPU
}
# Names of partly ported modules that a later slice ports (none are left:
# the image modules' last names came with Slice E).
QUEUED = {}


def _public(path):
    """Top-level public names of a module: functions (with their argument
    names), classes and constants; and ``__all__`` with the module each
    name is imported from."""
    import ast

    names, exported, origin = {}, set(), {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            names[n.name] = [a.arg for a in n.args.args + n.args.kwonlyargs]
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            names[n.name] = None
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                if isinstance(t, ast.Name) and t.id == "__all__":
                    exported = set(ast.literal_eval(n.value))
                elif isinstance(t, ast.Name) and not t.id.startswith("_"):
                    names[t.id] = None
        elif isinstance(n, ast.ImportFrom) and n.module:
            for a in n.names:
                origin[a.asname or a.name] = n.module
    return names, exported, origin


PORTED = sorted(p.relative_to(ROOT / "sara_tpu_torch").as_posix()
                for p in (ROOT / "sara_tpu_torch").rglob("*.py")
                if (ROOT / "sara_tpu" / p.relative_to(
                    ROOT / "sara_tpu_torch")).exists())


def test_every_module_has_a_twin():
    """Every module file of the JAX package has a file at the same path
    under sara_tpu_torch/."""
    twins = sorted(p.relative_to(ROOT / "sara_tpu").as_posix()
                   for p in (ROOT / "sara_tpu").rglob("*.py"))
    missing = [rel for rel in twins
               if not (ROOT / "sara_tpu_torch" / rel).exists()]
    assert not missing, f"no twin for {missing}"
    assert PORTED == twins


def test_every_tool_has_a_twin():
    """Every command-line tool of scripts/ has a twin scripts/torch_<name>,
    or a reason in TOOLS_WITHOUT_TWIN; every probe_*.py has one too or
    stands in PROBES_QUEUED with its reason (0 of the 23); bench.py's
    twin is torch_bench.py at the root; every twin has its tool."""
    tools = sorted(p.name for p in (ROOT / "scripts").glob("*.py")
                   if not p.name.startswith("torch_"))
    missing = [t for t in tools
               if not (ROOT / "scripts" / f"torch_{t}").exists()
               and t not in TOOLS_WITHOUT_TWIN and t not in PROBES_QUEUED]
    assert not missing, f"no twin for {missing}"
    orphans = [p.name for p in (ROOT / "scripts").glob("torch_*.py")
               if p.name[len("torch_"):] not in tools]
    assert not orphans, f"twins without a tool: {orphans}"
    assert all(not (ROOT / "scripts" / f"torch_{t}").exists()
               for t in list(TOOLS_WITHOUT_TWIN) + list(PROBES_QUEUED))
    assert set(PROBES_QUEUED) <= set(tools)
    assert (ROOT / "sara_tpu_torch" / "calib" / "cli.py").exists()
    assert (ROOT / "torch_bench.py").exists() and (ROOT / "bench.py").exists()
    probes = [t for t in tools if t.startswith("probe_")]
    assert len(probes) == 23
    assert len(PROBES_QUEUED) == 0
    assert sum((ROOT / "scripts" / f"torch_{t}").exists()
               for t in probes) == 23


@pytest.mark.parametrize("rel", PORTED)
def test_public_names_match_twin(rel):
    twin, t_all, t_origin = _public(ROOT / "sara_tpu" / rel)
    port, p_all, _ = _public(ROOT / "sara_tpu_torch" / rel)
    skip = REPLACED_NAMES.get(rel, set()) | QUEUED.get(rel, set())
    missing = sorted(set(twin) - set(port) - skip)
    assert not missing, f"{rel} lacks {missing}"
    for name, args in twin.items():
        if args is None or name not in port:
            continue
        want = [RENAMED_ARGS.get(a, a) for a in args
                if a not in DROPPED_ARGS.get((rel, name), set())]
        got = [a for a in port[name] if a not in ADDED_ARGS]
        assert got == want, f"{rel}::{name} takes {got}, the twin {want}"
    for name in sorted(t_all - p_all):
        # Only names of modules that have no port yet may be missing.
        mod = t_origin.get(name, "")
        src = ROOT / (mod.replace(".", "/") + ".py")
        port_src = ROOT / (mod.replace("sara_tpu", "sara_tpu_torch", 1)
                           .replace(".", "/") + ".py")
        queued = QUEUED.get(
            port_src.relative_to(ROOT / "sara_tpu_torch").as_posix()
            if port_src.exists() else "", set())
        assert src.exists() and (not port_src.exists() or name in queued), \
            f"{rel}: __all__ lacks {name}"


def test_package_data_ships_every_native_source():
    """Every file under sara_tpu_torch/**/csrc/ matches a package-data
    pattern, so an installed package builds the native union-find (and the
    kernels) instead of quietly running NumPy."""
    import fnmatch
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = data["tool"]["setuptools"]["package-data"]["sara_tpu_torch"]
    pkg = ROOT / "sara_tpu_torch"
    sources = [p.relative_to(pkg).as_posix()
               for p in pkg.rglob("csrc/*") if p.is_file()]
    assert "sfm/csrc/sara_native.cpp" in sources
    assert "ops/csrc/patch_sampler.cu" in sources
    for src in sources:
        assert any(fnmatch.fnmatch(src, pat) for pat in patterns), src


def test_tf32_pinned_off():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("jax_params", [
    JaxSIFTParams(),
    JaxSIFTParams(desc_sampler="pallas", desc_sample_nearest=False),
    JaxMatchParams(ratio=0.7, mutual=False),
], ids=["sift_default", "slice", "match"])
def test_params_from_jax_round_trip(jax_params):
    port = params_from_jax(jax_params)
    assert type(port).__name__ == type(jax_params).__name__
    want = dataclasses.asdict(jax_params)
    if "desc_sampler" in want:
        want["desc_sampler"] = {"pallas": "kernel"}.get(
            want["desc_sampler"], want["desc_sampler"])
        want["low_precision"] = False       # the twin's takes effect on a TPU
        on = dataclasses.replace(port, low_precision=True)
        assert params_from_jax(on) == on           # the port's own is kept
    assert dataclasses.asdict(port) == want
    assert params_from_jax(port) == port          # twins map onto themselves


def test_sift_params_defaults_match_twin():
    # One deliberate deviation: low_precision is off by default (the twin's
    # True takes effect only on a TPU; PERF.md, F2).
    assert dataclasses.asdict(SIFTParams()) == dict(
        dataclasses.asdict(JaxSIFTParams()), low_precision=False)


def test_keypoints_from_numpy_and_container_ops():
    rs = np.random.RandomState(0)
    n = 6
    fields = (rs.rand(n, 2), rs.rand(n), rs.rand(n), rs.rand(n),
              rs.rand(n, 128), rs.rand(n) > 0.5)
    jk = jtypes.Keypoints(*(jnp.asarray(f) for f in fields))
    tk = keypoints_from_numpy(jk, "cpu")
    assert tk.xy.dtype == torch.float32 and tk.mask.dtype == torch.bool
    assert tk.capacity == jk.capacity
    assert int(tk.count()) == int(jk.count())
    idx = np.array([5, 0, 2])
    valid = np.array([True, False, True])
    jt = jtypes.take_keypoints(jk, jnp.asarray(idx), jnp.asarray(valid))
    tt = ttypes.take_keypoints(tk, torch.from_numpy(idx),
                               torch.from_numpy(valid))
    jc = jtypes.concat_keypoints(jt, jk)
    tc = ttypes.concat_keypoints(tt, tk)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   b.numpy().astype(np.float32), rtol=1e-6)
    e = ttypes.Keypoints.empty(4, device="cpu")
    assert e.capacity == 4 and int(e.count()) == 0
    assert ttypes.Matches.empty(3, device="cpu").capacity == 3
    with pytest.raises(ValueError):
        keypoints_from_numpy(fields[:5], "cpu")


def test_logger_is_the_twin():
    """get_logger: the port's root is ``sara_tpu_torch`` (one stderr
    handler, not propagated), the reference's format and level variable."""
    import logging

    from sara_tpu.utils import log as jlog
    from sara_tpu_torch.utils import get_logger
    from sara_tpu_torch.utils import log as tlog

    lg = get_logger("sara_tpu_torch.loop")
    root = logging.getLogger("sara_tpu_torch")
    assert lg.name == "sara_tpu_torch.loop" and lg.parent is root
    assert len(root.handlers) == 1 and not root.propagate
    assert get_logger() is root and len(root.handlers) == 1
    assert tlog._FORMAT == jlog._FORMAT
    assert "SARA_TPU_LOG" in Path(tlog.__file__).read_text()
