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
from sara_tpu_torch.core import types as ttypes
from sara_tpu_torch.features.api import SIFTParams, compute_sift_keypoints
from sara_tpu_torch.image.filtering import gaussian_kernel_1d

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "sara_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = ("import sys, sara_tpu_torch, sara_tpu_torch.convert, "
            "sara_tpu_torch.features.api, sara_tpu_torch.matching, "
            "sara_tpu_torch.mvg, sara_tpu_torch.ransac, "
            "sara_tpu_torch.ransac.orsa, sara_tpu_torch.core.lie, "
            "sara_tpu_torch.mvg.extra_solvers; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sara_tpu.')) or m == 'sara_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


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
], ids=["Keypoints.empty", "Matches.empty", "gaussian_kernel_1d"])
def test_constructors_default_to_the_card(make):
    """Without a device these build on the card, or raise without one; the
    CPU only when asked."""
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert make(device="cpu").device == torch.device("cpu")


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
    assert dataclasses.asdict(port) == want
    assert params_from_jax(port) == port          # twins map onto themselves


def test_sift_params_defaults_match_twin():
    assert dataclasses.asdict(SIFTParams()) == dataclasses.asdict(
        JaxSIFTParams())


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
