"""The work counts behind the rooflines, against small cases worked by
hand."""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import ba, match, sift


def test_pair_work_by_hand():
    # 2 x 3 valid rows of 4 floats: (2*4 + 6) * 6 + 4 * 2 operations;
    # (16 + 1) * 5 bytes read, 13 * 2 written.
    assert match.pair_work(6, 2, 3, 4) == (92.0, 111.0)


def test_ba_cg_iteration_by_hand():
    # Two cameras, one point seen twice, one CG step: 594 * 2 + 60
    # + 432 * 2 + 42 * 2 + (81 * 2 + 18 + 210 * 2) operations.
    assert ba.cg_iteration_work(2, 1, 2, 1) == (2796.0, 168.0)


def test_sift_frame_by_hand():
    # 16 x 16: two octaves (32^2 and 16^2 after the x2 upsample); the
    # five incremental blurs have 11 + 15 + 17 + 21 + 27 = 91 taps, so
    # 4 * 91 + 5 + 3 * 52 = 525 operations per octave pixel; the first
    # blur has 11 taps over 32^2, the upsample 8 per output pixel.
    ops, byts = sift.frame_work((16, 16), 0)
    assert ops == 8 * 1024 + 4 * 11 * 1024 + 525 * (1024 + 256)
    assert byts == 4 * 256
    # Per keypoint: window radius ceil(4.5 * 1.6 * 2^(1/3)) = 10.
    ops10, byts10 = sift.frame_work((16, 16), 10)
    per_kp = 3 * 120 + 40 * 21 ** 2 + 6 * 36 * 3 + 50 * 256 + 6 * 128
    assert ops10 - ops == pytest.approx(10 * per_kp)
    assert byts10 - byts == 10 * 533


def test_sift_octaves_follow_the_reference_pyramid():
    from benchmark.reference import sift as ref
    img = torch.rand(64, 160)
    octaves, _ = ref.pyramid(img)
    assert [tuple(o.shape[-2:]) for o in octaves] == sift._octave_sizes(
        64, 160)
