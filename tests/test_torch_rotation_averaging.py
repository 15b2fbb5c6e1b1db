"""Port parity: global rotation averaging (``sfm/rotation_averaging.py``)
against its ``sara_tpu`` twin.

The subspace iteration's QR may pick other column signs in LAPACK than in
JAX (or cuSOLVER), and the gauge removal ``B_k B_0^T`` is invariant to
them, so rotations are compared, never the subspace ``B``. Graphs are
numpy arrays given to both packages in float64 (the conftest turns on JAX
x64); rotations are held within a chordal distance of 1e-6, the SO(3)
helpers to 1e-12.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometry_fixtures import rotation_distance
from sara_tpu.core import lie as jlie
from sara_tpu.sfm import rotation_averaging as J
from sara_tpu_torch.sfm import rotation_averaging as T

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_pose_graph_opt import _circle_trajectory, _rel  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the machine's cores, and torch's default of a thread per core makes
    the port's many small operations wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def so3_exp(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w)))


def circle_graph(case):
    """(n, edge_i, edge_j, R_rel, edge_mask, ground-truth rotations) of the
    reference tests' graphs: "noisy" (n = 20, neighbours 1-2, 0.01 rad
    noise), "outliers" (n = 16, neighbours 1-3, 15% of the edges replaced
    by random rotations), "repeated" (the outlier graph with eight edges
    measured twice more, some reversed, and two masked)."""
    seed, n, hops = {"noisy": (1, 20, (1, 2)), "outliers": (2, 16, (1, 2, 3)),
                     "repeated": (2, 16, (1, 2, 3))}[case]
    rs = np.random.RandomState(seed)
    gt = _circle_trajectory(n)
    ei, ej, Rr = [], [], []
    for k in range(n):
        for d in hops:
            j = (k + d) % n
            R, _ = _rel(gt[k], gt[j])
            if case == "noisy":
                R = so3_exp(np.asarray(jlie.so3_log(jnp.asarray(R)))
                            + rs.normal(scale=0.01, size=3))
            ei.append(k)
            ej.append(j)
            Rr.append(R)
    if case != "noisy":
        bad = rs.choice(len(Rr), len(Rr) * 15 // 100, replace=False)
        for b in bad:
            Rr[b] = so3_exp(rs.normal(size=3))
    mask = np.ones(len(Rr), bool)
    if case == "repeated":
        for e in rs.choice(len(Rr), 8, replace=False):
            a, b = ei[e], ej[e]
            R, _ = _rel(gt[a], gt[b])
            R = so3_exp(np.asarray(jlie.so3_log(jnp.asarray(R)))
                        + rs.normal(scale=0.01, size=3))
            if e % 2:
                ei.append(b), ej.append(a), Rr.append(R.T)
            else:
                ei.append(a), ej.append(b), Rr.append(R)
        mask = np.ones(len(Rr), bool)
        mask[[3, 17]] = False
    return (n, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(Rr), mask, [g[0] for g in gt])


def chordal(A, B):
    return np.linalg.norm(A - B, axis=(-2, -1))


@pytest.mark.parametrize("case", ["noisy", "outliers", "repeated"])
def test_average_rotations_matches_jax(case):
    n, ei, ej, Rr, mask, gt = circle_graph(case)
    ref = np.asarray(J.average_rotations(
        n, jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(Rr),
        jnp.asarray(mask)))
    got = T.average_rotations(n, torch.from_numpy(ei), torch.from_numpy(ej),
                              torch.from_numpy(Rr), torch.from_numpy(mask))
    assert got.dtype == torch.float64 and got.shape == (n, 3, 3)
    assert chordal(got.numpy(), ref).max() <= 1e-6
    np.testing.assert_allclose(got[0].numpy(), np.eye(3), atol=1e-12)
    # And the reference tests' outcome gate against the ground truth.
    G = gt[0] @ got[0].numpy().T
    err = max(rotation_distance(G @ R, g) for R, g in zip(got.numpy(), gt))
    assert err < 0.1, err


def test_stages_match_jax_one_by_one():
    """The spectral solve and the tangent refinement, each from the same
    inputs, on the graph with repeated edges; weights as IRLS makes them."""
    n, ei, ej, Rr, mask, _ = circle_graph("repeated")
    w = mask.astype(np.float64) * np.random.RandomState(0).uniform(
        0.2, 1.0, len(mask))
    j = [jnp.asarray(a) for a in (ei, ej, Rr, w)]
    t = [torch.from_numpy(a) for a in (ei, ej, Rr, w)]
    R0 = np.asarray(J._solve_once(n, *j))
    R0_t = T._solve_once(n, *t)
    assert chordal(R0_t.numpy(), R0).max() <= 1e-6
    R1 = np.asarray(J._refine_tangent(n, jnp.asarray(R0), *j))
    R1_t = T._refine_tangent(n, torch.from_numpy(R0.copy()), *t)
    assert chordal(R1_t.numpy(), R1).max() <= 1e-9


def test_so3_helpers_match_jax():
    rs = np.random.RandomState(3)
    M = rs.normal(size=(40, 3, 3))
    M[5] = np.diag([1.0, 1.0, -1.0])                   # det -1
    np.testing.assert_allclose(T._project_so3(torch.from_numpy(M)).numpy(),
                               np.asarray(J._project_so3(jnp.asarray(M))),
                               atol=1e-12)
    v = rs.normal(scale=0.8, size=(40, 3))
    v[0] = 0.0                                          # the small branches
    v[1] = [1e-9, 0, 0]
    v[2] = [0, 5e-5, 0]
    R = np.asarray(J._exp_batch(jnp.asarray(v)))
    np.testing.assert_allclose(T._exp_batch(torch.from_numpy(v)).numpy(), R,
                               atol=1e-12)
    np.testing.assert_allclose(T._log_batch(torch.from_numpy(R)).numpy(),
                               np.asarray(J._log_batch(jnp.asarray(R))),
                               atol=1e-12)


def test_float32_run_tracks_float64():
    """The production precision: float32 rotations within a chordal
    distance of 1e-4 of the float64 ones (outlier graph)."""
    n, ei, ej, Rr, _, _ = circle_graph("outliers")
    args = (torch.from_numpy(ei), torch.from_numpy(ej))
    R64 = T.average_rotations(n, *args, torch.from_numpy(Rr))
    R32 = T.average_rotations(n, *args, torch.from_numpy(Rr).float())
    assert R32.dtype == torch.float32
    assert chordal(R32.double().numpy(), R64.numpy()).max() <= 1e-4
