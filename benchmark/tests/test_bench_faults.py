"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``run.run_cell``, the look for a
card skipped) at CPU sizes with one fault planted in the program: half of
a batch left out, an answer altered where it is produced, a solve that
returns its state unchanged, one that returns its points unsolved, half of
the observations left out. No cell
spans chips, so no exchange between chips can be left out."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run


def _run(root, cell, seed):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return run.run_cell(bench, cell, seed, 0.5, 0, device="cpu", root=root)


@pytest.fixture
def sift_api():
    from sara_tpu_torch.features import api
    return api


@pytest.fixture
def brute_force():
    from sara_tpu_torch.matching import brute_force
    return brute_force


@pytest.fixture
def ba_core():
    from sara_tpu_torch.ba import core
    return core


def test_sound_runs_are_correct(tiny_root):
    for cell in ("sift_kitti.seq8", "ba_bal_dubrovnik356.cg10"):
        assert _run(tiny_root, cell, 2 ** 31 + 5)["correct"]


def test_half_the_batch_left_out(tiny_root, monkeypatch, sift_api):
    real = sift_api._compute_sift_batch

    def half(images, *a, **k):
        kp = real(images[: max(1, images.shape[0] // 2)], *a, **k)
        idx = torch.arange(images.shape[0]) % kp.xy.shape[0]
        return type(kp)(*(f[idx] for f in kp))
    monkeypatch.setattr(sift_api, "_compute_sift_batch", half)
    out = _run(tiny_root, "sift_kitti.seq8", 2 ** 31 + 6)
    assert not out["correct"] and out["checks"]["desc_off"]["value"] > 0.1


def test_an_altered_match(tiny_root, monkeypatch, brute_force):
    real = brute_force._match_sets

    def altered(da, ma, db, mb, ratio, mutual=True):
        j, ok, d1 = real(da, ma, db, mb, ratio, mutual)
        return torch.where(ok, (j + 1) % db.shape[-2], j), ok, d1
    monkeypatch.setattr(brute_force, "_match_sets", altered)
    out = _run(tiny_root, "sift_kitti.seq8", 2 ** 31 + 7)
    assert not out["correct"] and out["checks"]["match_off"]["value"] > 0.1


def test_a_solve_that_returns_its_state(tiny_root, monkeypatch, ba_core):
    real = ba_core.bundle_adjust

    def unchanged(p, opts):
        return p, real(p, opts)[1]
    monkeypatch.setattr(ba_core, "bundle_adjust", unchanged)
    out = _run(tiny_root, "ba_bal_dubrovnik356.cg10", 2 ** 31 + 8)
    assert not out["correct"]


def test_points_left_unsolved(tiny_root, monkeypatch, ba_core):
    real = ba_core.bundle_adjust

    def poses_only(p, opts):
        q, info = real(p, opts)
        return q._replace(points=p.points), info
    monkeypatch.setattr(ba_core, "bundle_adjust", poses_only)
    out = _run(tiny_root, "ba_bal_dubrovnik356.cg10", 2 ** 31 + 10)
    assert not out["correct"]
    assert out["checks"]["pose_gap"]["value"] <= 0.02
    assert out["checks"]["point_gap_median"]["value"] > 0.5


def test_half_the_observations_left_out(tiny_root, monkeypatch, ba_core):
    real = ba_core.bundle_adjust

    def half(p, opts):
        keep = torch.arange(p.obs_mask.shape[0], device=p.obs_mask.device)
        return real(p._replace(obs_mask=p.obs_mask & (keep % 2 == 0)), opts)
    monkeypatch.setattr(ba_core, "bundle_adjust", half)
    out = _run(tiny_root, "ba_bal_dubrovnik356.cg10", 2 ** 31 + 9)
    assert not out["correct"]
