"""The port's host I/O and drawing twins (``sara_tpu_torch/io/{nuscenes,
datasets,features_io}.py``, ``sara_tpu_torch/viz/draw.py``) against
``sara_tpu``'s on the CPU: the nuScenes tables on synthetic JSON, HDF5
files written by one package and read by the other, Strecha camera files,
and PNGs from each drawing under the Agg backend."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.core import types as jtypes
from sara_tpu import io as jio
from sara_tpu.io import nuscenes as jns
from sara_tpu_torch import io as tio
from sara_tpu_torch.core import types as ttypes
from sara_tpu_torch.io import nuscenes as tns
from sara_tpu_torch.viz import (draw_keypoints, draw_matches,
                                draw_point_cloud, draw_trajectory)


def _write_tables(root, tables):
    d = root / "v1.0-mini"
    os.makedirs(d, exist_ok=True)
    for name, rows in tables.items():
        with open(d / f"{name}.json", "w") as f:
            json.dump(rows, f)


_CAM = {
    "sensor": [{"token": "s1", "channel": "CAM_FRONT", "modality": "camera"},
               {"token": "s2", "channel": "CAM_BACK", "modality": "camera"}],
    "calibrated_sensor": [
        {"token": "c1", "sensor_token": "s1",
         "camera_intrinsic": [[1000, 0, 800], [0, 1000, 450], [0, 0, 1]],
         "rotation": [0.9961947, 0.0, 0.0871557, 0.0],
         "translation": [1.5, 0.0, 1.6]},
        {"token": "c2", "sensor_token": "s2",
         "camera_intrinsic": [[800, 0, 640], [0, 800, 360], [0, 0, 1]],
         "rotation": [1, 0, 0, 0], "translation": [0, 0, 0]}],
    "ego_pose": [{"token": "e1", "rotation": [0.9998477, 0.0, 0.0, 0.0174524],
                  "translation": [3.0, -1.0, 0.0], "timestamp": 2},
                 {"token": "e2", "rotation": [1, 0, 0, 0],
                  "translation": [0, 0, 0], "timestamp": 1}],
    "sample_data": [
        {"token": "d1", "sample_token": "smp1",
         "calibrated_sensor_token": "c1", "ego_pose_token": "e1",
         "timestamp": 2, "filename": "a.jpg"},
        {"token": "d0", "sample_token": "smp1",
         "calibrated_sensor_token": "c1", "ego_pose_token": "e2",
         "timestamp": 1, "filename": "b.jpg"},
        {"token": "d2", "sample_token": "smp1",
         "calibrated_sensor_token": "c2", "ego_pose_token": "e2",
         "timestamp": 1, "filename": "c.jpg"}],
    "scene": [], "sample": [{"token": "smp1"}],
}


def _annotations(rs, n=12):
    return [{"token": f"a{k}", "sample_token": "smp1",
             "instance_token": f"i{k % 3}", "visibility_token": "4",
             "attribute_tokens": [],
             "translation": [float(v) for v in rs.uniform(-20, 40, 3)],
             "size": [1.8, 4.5, 1.6], "rotation": [1, 0, 0, 0],
             "num_lidar_pts": 3, "num_radar_pts": 0, "prev": "", "next": ""}
            for k in range(n)]


def test_nuscenes_tables_match_twin(tmp_path):
    """Twin of ``test_io_misc.py::test_nuscenes_loader``, on two channels
    and out-of-order timestamps: the same joined records."""
    _write_tables(tmp_path, _CAM)
    for ch in ("CAM_FRONT", "CAM_BACK"):
        got = tns.NuScenesTables(str(tmp_path)).camera_frames(ch)
        want = jns.NuScenesTables(str(tmp_path)).camera_frames(ch)
        assert got == want and len(got) == {"CAM_FRONT": 2,
                                            "CAM_BACK": 1}[ch]
    assert got[0]["camera_intrinsic"][0][0] == 800


def test_nuscenes_annotations_and_projection_match_twin(tmp_path):
    """Twin of ``test_io_misc.py::test_nuscenes_annotations_and_
    projection``, with rotated ego and sensor poses: equal annotation
    records and projected boxes."""
    rs = np.random.RandomState(0)
    tables = dict(_CAM, sample_annotation=_annotations(rs),
                  instance=[{"token": f"i{k}", "category_token": f"cat{k}",
                             "nbr_annotations": 4} for k in range(3)],
                  category=[{"token": f"cat{k}", "name": n, "description": ""}
                            for k, n in enumerate(["vehicle.car", "human",
                                                   "vehicle.truck"])],
                  attribute=[], visibility=[])
    _write_tables(tmp_path, tables)
    tn, jn = (m.NuScenesAnnotations(str(tmp_path)) for m in (tns, jns))
    assert tn.annotations_of_sample("smp1") == jn.annotations_of_sample("smp1")
    for frame in tn.camera_frames("CAM_FRONT"):
        got, want = tn.boxes_in_camera(frame), jn.boxes_in_camera(frame)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            np.testing.assert_allclose(a["uv"], b["uv"], rtol=1e-12)
            assert a["depth"] == pytest.approx(b["depth"], rel=1e-12)
            assert (a["category_name"], a["instance_token"]) == (
                b["category_name"], b["instance_token"])


def test_nuimages_tables_match_twin(tmp_path):
    tables = {"sample_data": [], "category": [
        {"token": "c1", "name": "vehicle.car"}, {"token": "c2",
                                                 "name": "human"}],
        "object_annotation": [
            {"token": f"o{k}", "sample_data_token": f"d{k % 2}",
             "category_token": f"c{1 + k % 2}", "bbox": [k, k, k + 5, k + 9]}
            for k in range(5)]}
    _write_tables(tmp_path, tables)
    for sd in ("d0", "d1"):
        got = tns.NuImagesTables(str(tmp_path)).object_annotations(sd)
        want = jns.NuImagesTables(str(tmp_path)).object_annotations(sd)
        assert got == want and got


def _keypoints(rs, n=8):
    return (rs.random((n, 2)).astype(np.float32) * 100,
            rs.random(n).astype(np.float32) + 1, rs.random(n).astype(
                np.float32), rs.random(n).astype(np.float32),
            rs.random((n, 128)).astype(np.float32), rs.random(n) > 0.3)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_features_h5_across_packages(tmp_path, writer):
    """Keypoints and matches written by one package read in the other to
    equal arrays, with the port's dtypes."""
    rs = np.random.default_rng(0)
    kf = _keypoints(rs)
    mf = (np.arange(5, dtype=np.int32), rs.permutation(5).astype(np.int32),
          rs.random(5).astype(np.float32), rs.random(5) > 0.4)
    p = str(tmp_path / "f.h5")
    if writer == "jax":
        jio.save_keypoints_h5(p, jtypes.Keypoints(*map(jnp.asarray, kf)))
        jio.save_matches_h5(p, jtypes.Matches(*map(jnp.asarray, mf)))
        kp = tio.load_keypoints_h5(p, device="cpu")
        m = tio.load_matches_h5(p, device="cpu")
        got_k = [f.numpy() for f in kp]
        got_m = [f.numpy() for f in m]
        assert kp.mask.dtype == torch.bool and m.i.dtype == torch.int32
        assert kp.xy.dtype == torch.float32
    else:
        tio.save_keypoints_h5(p, ttypes.Keypoints(*map(torch.from_numpy, kf)))
        tio.save_matches_h5(p, ttypes.Matches(*map(torch.from_numpy, mf)))
        got_k = [np.asarray(f) for f in jio.load_keypoints_h5(p)]
        got_m = [np.asarray(f) for f in jio.load_matches_h5(p)]
    for a, b in zip(got_k + got_m, kf + mf):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_two_view_geometry_h5_across_packages(tmp_path, writer):
    """Twin of ``test_io_misc.py::test_two_view_geometry_h5_roundtrip``,
    across packages (the port's writer also takes tensors)."""
    rs = np.random.RandomState(0)
    path = str(tmp_path / "tv.h5")
    E = rs.normal(size=(3, 3))
    t = np.array([1.0, 0, 0])
    X = rs.normal(size=(50, 3)).astype(np.float32)
    inl = rs.rand(50) > 0.3
    if writer == "jax":
        jio.save_two_view_geometry_h5(path, E=E, R=np.eye(3), t=t, X=X,
                                      inliers=inl, K1=np.eye(3))
        out = tio.load_two_view_geometry_h5(path)
    else:
        tio.save_two_view_geometry_h5(path, E=E, R=np.eye(3),
                                      t=torch.from_numpy(t),
                                      X=torch.from_numpy(X),
                                      inliers=inl, K1=np.eye(3))
        out = jio.load_two_view_geometry_h5(path)
    np.testing.assert_array_equal(out["E"], E)
    np.testing.assert_array_equal(out["X"], X)
    np.testing.assert_array_equal(out["t"], t)
    np.testing.assert_array_equal(out["inliers"], inl)
    assert "F" not in out and sorted(out) == ["E", "K1", "R", "X", "inliers",
                                              "t"]


def test_strecha_camera(tmp_path):
    """Twin of ``test_io_misc.py::test_strecha_camera``."""
    K = np.array([[2759.48, 0, 1520.69], [0, 2764.16, 1006.81], [0, 0, 1]])
    p = str(tmp_path / "img.camera")
    with open(p, "w") as f:
        for row in K:
            f.write(" ".join(str(v) for v in row) + "\n")
        f.write("0\n")
    got = tio.read_strecha_camera(p)
    np.testing.assert_allclose(got, K)
    np.testing.assert_array_equal(got, jio.read_strecha_camera(p))


def test_reference_data_names_the_twins_directory():
    """``load_image_pair`` reads the twin's fixed data directory, never a
    path relative to the checkout."""
    from sara_tpu.io import datasets as jds
    from sara_tpu_torch.io import datasets as tds

    assert tds.REFERENCE_DATA == jds.REFERENCE_DATA
    assert os.path.isabs(tds.REFERENCE_DATA)


@pytest.mark.parametrize("what", ["keypoints", "matches", "point_cloud",
                                  "trajectory"])
def test_draw_writes_png(tmp_path, what):
    rs = np.random.default_rng(1)
    img = rs.random((48, 64)).astype(np.float32)
    kp = ttypes.Keypoints(*map(torch.from_numpy, _keypoints(rs)))
    p = str(tmp_path / f"{what}.png")
    if what == "keypoints":
        draw_keypoints(torch.from_numpy(img), kp, path=p)
    elif what == "matches":
        m = ttypes.Matches(torch.arange(8, dtype=torch.int32),
                           torch.arange(8, dtype=torch.int32).flip(0),
                           torch.ones(8), torch.ones(8, dtype=torch.bool))
        draw_matches(img, torch.from_numpy(img), kp, kp, m, path=p)
    elif what == "point_cloud":
        draw_point_cloud(torch.from_numpy(rs.normal(size=(200, 3))),
                         colors=rs.random((200, 3)), path=p)
    else:
        c = np.cumsum(rs.normal(size=(20, 3)), axis=0)
        draw_trajectory(torch.from_numpy(c), gt=c + 0.1, path=p)
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(p) > 1000
