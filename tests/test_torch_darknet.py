"""The port's Darknet / YOLO inference (``sara_tpu_torch/nn``) against its
twin ``sara_tpu/nn`` on the CPU: config parsing, parameters drawn bit for
bit alike, the ``.weights`` format across packages, the forward at
yolov4-tiny's full channel widths on a small input and on a network of
the edge cases, YOLO decoding and NMS."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darknet_cfgs import perturb_batch_norm, write_cfg
from sara_tpu.nn import darknet as jdn
from sara_tpu_torch.convert import darknet_params_from_jax
from sara_tpu_torch.nn import darknet as tdn
from sara_tpu_torch.nn import (nms_boxes, parse_darknet_cfg, yolo_decode)

FWD_TOL = dict(atol=2e-3, rtol=1e-3)     # the JAX package's torch parity


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    return {name: (write_cfg(d, name), jdn.parse_darknet_cfg(
        write_cfg(d, name))) for name in ("yolov4-tiny", "edge-cases")}


def _conv_layers(cfg):
    return [i for i, s in enumerate(cfg[1:]) if s["type"] == "convolutional"]


def test_parse_cfg_yolov4_tiny(cfgs):
    path, jcfg = cfgs["yolov4-tiny"]
    cfg = parse_darknet_cfg(path)
    assert cfg == jcfg
    assert cfg[0]["type"] == "net"
    types = [s["type"] for s in cfg[1:]]
    assert types.count("yolo") == 2 and types.count("convolutional") == 21


@pytest.mark.parametrize("name", ["yolov4-tiny", "edge-cases"])
def test_init_params_bitwise(cfgs, name):
    _, cfg = cfgs[name]
    jp, jch = jdn.init_darknet_params(cfg, seed=3)
    tp, tch = tdn.init_darknet_params(cfg, seed=3, device="cpu")
    assert tch == jch
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        assert sorted(a) == sorted(b)
        for k in a:
            want = np.asarray(a[k], np.float32)
            if k == "w":
                want = want.transpose(3, 2, 0, 1)
            got = b[k].numpy()
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_params_from_jax_equal(cfgs):
    _, cfg = cfgs["yolov4-tiny"]
    jp, _ = jdn.init_darknet_params(cfg, seed=5)
    tp, _ = tdn.init_darknet_params(cfg, seed=5, device="cpu")
    conv = darknet_params_from_jax(jp, device="cpu")
    for a, b in zip(conv, tp):
        assert (a is None) == (b is None)
        if a is not None:
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k])


def _perturbed(params, seed):
    """The JAX package's parameters with every batch-norm statistic and
    bias moved off its default (``darknet_cfgs.perturb_batch_norm``), as
    jax arrays."""
    return [None if p is None else
            {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in p.items()}
            for p in perturb_batch_norm(params, seed)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_weights_round_trip_across_packages(cfgs, tmp_path, writer):
    """A file that either package writes loads in the other to equal
    arrays, and both writers write the same bytes."""
    _, cfg = cfgs["yolov4-tiny"]
    jp0, _ = jdn.init_darknet_params(cfg, seed=3)
    jp = _perturbed(jp0, 1)
    tp = darknet_params_from_jax(jp, device="cpu")
    pj, pt = str(tmp_path / "jax.weights"), str(tmp_path / "torch.weights")
    jdn.save_darknet_weights(cfg, jp, pj)
    tdn.save_darknet_weights(cfg, tp, pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()

    if writer == "jax":
        got, header = tdn.load_darknet_weights(cfg, pj, device="cpu")
        for i in _conv_layers(cfg):
            for k in jp[i]:
                want = np.asarray(jp[i][k], np.float32)
                if k == "w":
                    want = want.transpose(3, 2, 0, 1)
                np.testing.assert_array_equal(got[i][k].numpy(), want)
    else:
        got, header = jdn.load_darknet_weights(cfg, pt)
        for i in _conv_layers(cfg):
            for k in tp[i]:
                want = tp[i][k].numpy()
                if k == "w":
                    want = want.transpose(2, 3, 1, 0)
                np.testing.assert_array_equal(np.asarray(got[i][k]), want)
    np.testing.assert_array_equal(header, [0, 2, 5, 0, 0])


@pytest.mark.parametrize("name,shape", [
    ("yolov4-tiny", (1, 128, 128, 3)),
    ("edge-cases", (2, 33, 33, 3)),
], ids=["yolov4_tiny_128", "edge_cases_33"])
def test_forward_matches_twin(cfgs, name, shape):
    """Every layer's output within the JAX package's tolerance, with the
    batch-norm statistics and biases off the identity; the heads' shapes
    are the twin's (yolov4-tiny: 4x4 and 8x8 at 128x128)."""
    _, cfg = cfgs[name]
    jp = _perturbed(jdn.init_darknet_params(cfg, seed=3)[0], 2)
    tp = darknet_params_from_jax(jp, device="cpu")
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    jy, jo = jdn.darknet_forward(jp, cfg, jnp.asarray(x))
    ty, to = tdn.darknet_forward(tp, cfg, torch.from_numpy(x))
    assert [i for i, _, _ in ty] == [i for i, _, _ in jy]
    assert len(to) == len(jo) == len(cfg) - 1
    for a, b in zip(jo, to):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), a, **FWD_TOL)
    if name == "yolov4-tiny":
        assert sorted(tuple(f.shape[1:]) for _, f, _ in ty) == [
            (4, 4, 255), (8, 8, 255)]
    else:
        # maxpool size=2 stride=1 shrinks 33 -> 32; the head is 32x32.
        assert tuple(to[5].shape) == (2, 32, 32, 24)
        assert tuple(ty[0][1].shape) == (2, 32, 32, 21)


@pytest.mark.parametrize("scale_x_y", [None, "1.05"])
def test_yolo_decode_matches_twin(scale_x_y):
    sec = {"anchors": "10,14, 23,27, 37,58, 81,82", "mask": "1,2,3",
           "classes": "4"}
    if scale_x_y:
        sec["scale_x_y"] = scale_x_y
    rs = np.random.RandomState(2)
    feat = rs.normal(scale=2.0, size=(1, 5, 6, 3 * 9)).astype(np.float32)
    j = jdn.yolo_decode(jnp.asarray(feat), sec, img_w=96, img_h=80,
                        conf_thres=0.3)
    t = yolo_decode(torch.from_numpy(feat), sec, img_w=96, img_h=80,
                    conf_thres=0.3)
    for k in ("boxes", "score"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t["cls"].numpy(), np.asarray(j["cls"]))
    np.testing.assert_array_equal(t["mask"].numpy(), np.asarray(j["mask"]))
    assert t["mask"].any() and not t["mask"].all()


def test_nms_matches_twin():
    """200 seeded boxes with distinct scores, 30% masked out: the same
    picks in the same order, the same keep mask (160 slots, more than
    survive)."""
    rs = np.random.RandomState(4)
    n = 200
    boxes = np.concatenate([rs.uniform(0, 200, (n, 2)),
                            rs.uniform(8, 60, (n, 2))], 1).astype(np.float32)
    scores = rs.permutation(n).astype(np.float32) / n + 0.001
    mask = rs.rand(n) > 0.3
    ji, jk = jdn.nms_boxes(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(mask), iou_thres=0.45, max_out=160)
    ti, tk = nms_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(mask), iou_thres=0.45, max_out=160)
    assert ti.dtype == torch.int32 and tk.dtype == torch.bool
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy()[tk.numpy()],
                                  np.asarray(ji)[np.asarray(jk)])
    assert 0 < int(tk.sum()) < 160


def test_yolo_decode_geometry():
    """Twin of ``test_nn_darknet.py::test_yolo_decode_geometry``."""
    sec = {"anchors": "10,14", "mask": "0", "classes": "2"}
    Hf = Wf = 2
    feat = np.zeros((1, Hf, Wf, 1 * 7), np.float32)
    feat[0, 0, 0, 4] = 10.0   # high objectness at cell (0,0)
    feat[0, 0, 0, 5] = 10.0   # class 0
    out = yolo_decode(torch.from_numpy(feat), sec, img_w=64, img_h=64,
                      conf_thres=0.5)
    m = out["mask"].numpy()
    assert m.sum() == 1
    box = out["boxes"].numpy()[m][0]
    np.testing.assert_allclose(box[:2], [16.0, 16.0], atol=1e-4)
    np.testing.assert_allclose(box[2:], [10.0, 14.0], atol=1e-4)
    assert int(out["cls"].numpy()[m][0]) == 0


def test_nms_suppresses_overlaps():
    """Twin of ``test_nn_darknet.py::test_nms_suppresses_overlaps``."""
    boxes = torch.tensor([[10.0, 10, 8, 8], [11.0, 10, 8, 8],
                          [40.0, 40, 8, 8]])
    scores = torch.tensor([0.9, 0.8, 0.7])
    idx, keep = nms_boxes(boxes, scores, torch.ones(3, dtype=torch.bool),
                          iou_thres=0.45, max_out=4)
    assert set(idx[keep].tolist()) == {0, 2}
    assert keep.tolist() == [True, True, False, False]
