"""Darknet config parsing, functional inference and YOLO decoding.

Twin of ``sara_tpu/nn/darknet.py``. The network is a list of parameter
dicts (``None`` for layers without weights) and a pure forward function.
Convolution weights are stored OIHW, PyTorch's layout and the ``.weights``
file's; the twin stores HWIO. ``darknet_forward`` takes and returns NHWC
tensors as the twin does; inside it runs NCHW ``F.conv2d``, and every
output it returns is an NHWC view (``permute``) of the NCHW tensor it
computed. (cuDNN's float32 convolutions on the H100 run NCHW kernels: on
channels-last tensors it transposes every input and output.) The
convolutions are cuDNN's (the twin's are
``lax.conv_general_dilated`` outside any Pallas kernel) in full float32:
TF32 is pinned off in the package's ``__init__``. Batch norm stays unfused,
``(y - mean) / sqrt(var + 1e-5) * gamma + beta``, as in the twin.

YOLO decoding and NMS are fixed-capacity masked programs: ``nms_boxes`` is
a loop of ``max_out`` greedy argmax steps with no host read inside.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from sara_tpu_torch import resolve_device
from sara_tpu_torch.utils.host import put


# ---------------------------------------------------------------------------
# Config parsing (host).
# ---------------------------------------------------------------------------

def parse_darknet_cfg(path: str) -> List[Dict]:
    """Parse a .cfg into a list of {type, **options} dicts
    (reference: Darknet/Parser.hpp)."""
    sections = []
    cur = None
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            if line.startswith("["):
                cur = {"type": line.strip("[]")}
                sections.append(cur)
            elif "=" in line and cur is not None:
                k, v = line.split("=", 1)
                cur[k.strip()] = v.strip()
    return sections


def _int_list(s):
    return [int(x) for x in s.split(",") if x.strip() != ""]


def _layers(cfg: List[Dict]):
    """The layer sections' convolution shapes and output channel counts,
    tracked as the twin's ``init_darknet_params`` tracks them. Returns
    (shapes, out_ch): per layer, (filters, in_channels / groups, size,
    size) for a convolution and None otherwise, and its channel count."""
    channels = int(cfg[0].get("channels", 3))
    shapes, out_ch = [], []
    for sec in cfg[1:]:
        t = sec["type"]
        shape = None
        if t == "convolutional":
            f = int(sec["filters"])
            k = int(sec["size"])
            shape = (f, channels // int(sec.get("groups", 1)), k, k)
            channels = f
        elif t == "route":
            ch = 0
            for l in _int_list(sec["layers"]):
                ch += out_ch[l if l >= 0 else len(out_ch) + l]
            channels = ch // int(sec.get("groups", 1))
        shapes.append(shape)
        out_ch.append(channels)
    return shapes, out_ch


def _conv_weight(w, dev) -> torch.Tensor:
    """An OIHW weight array as a contiguous float32 tensor on ``dev``."""
    return put(np.ascontiguousarray(w, np.float32), dev)


# ---------------------------------------------------------------------------
# Parameter construction / weight loading.
# ---------------------------------------------------------------------------

def init_darknet_params(cfg: List[Dict], seed: int = 0,
                        device: str | torch.device | None = None):
    """Random-init parameters on ``device`` (None: the card); returns
    (params list aligned with layer sections, output channel count per
    layer). The draws are the twin's (``np.random.RandomState(seed)``, one
    HWIO normal array per convolution), so with the same seed every array
    equals the twin's bit for bit, transposed to OIHW."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    shapes, out_ch = _layers(cfg)
    params = []
    for sec, shape in zip(cfg[1:], shapes):
        if shape is None:
            params.append(None)
            continue
        f, in_ch, k, _ = shape
        w = rs.normal(scale=0.05, size=(k, k, in_ch, f)).astype(np.float32)
        p = {"w": _conv_weight(w.transpose(3, 2, 0, 1), dev)}
        ones = torch.ones((f,), dtype=torch.float32, device=dev)
        zeros = torch.zeros((f,), dtype=torch.float32, device=dev)
        if int(sec.get("batch_normalize", 0)):
            p.update(gamma=ones, beta=zeros, mean=zeros.clone(),
                     var=ones.clone())
        else:
            p["bias"] = zeros
        params.append(p)
    return params, out_ch


def load_darknet_weights(cfg: List[Dict], path: str,
                         device: str | torch.device | None = None):
    """Load the binary .weights format: 5 int32 header then float32 params
    in layer order (bn: beta, gamma, mean, var; else bias; then conv weights
    OIHW) (reference: Darknet/Parser.hpp load_weights). Returns (params on
    ``device`` (None: the card), header)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        header = np.fromfile(f, np.int32, 5)
        buf = np.fromfile(f, np.float32)
    pos = 0

    def take(n):
        nonlocal pos
        out = buf[pos: pos + n]
        pos += n
        return put(out.copy(), dev)

    params = []
    for sec, shape in zip(cfg[1:], _layers(cfg)[0]):
        if shape is None:
            params.append(None)
            continue
        fout = shape[0]
        p = {}
        if int(sec.get("batch_normalize", 0)):
            for key in ("beta", "gamma", "mean", "var"):
                p[key] = take(fout)
        else:
            p["bias"] = take(fout)
        n = int(np.prod(shape))
        p["w"] = _conv_weight(buf[pos: pos + n].reshape(shape), dev)
        pos += n
        params.append(p)
    if pos != len(buf):
        raise ValueError(f"weight file mismatch: used {pos}/{len(buf)}")
    return params, header


def save_darknet_weights(cfg: List[Dict], params, path: str,
                         header=(0, 2, 5, 0, 0)):
    """Write params in the binary Darknet .weights format (the exact
    inverse of :func:`load_darknet_weights`); the bytes equal the twin's
    for the same parameters."""
    chunks = [np.asarray(header, np.int32).tobytes()]
    for i, sec in enumerate(cfg[1:]):
        if sec["type"] != "convolutional":
            continue
        p = params[i]
        keys = (("beta", "gamma", "mean", "var") if "gamma" in p
                else ("bias",)) + ("w",)
        for key in keys:
            chunks.append(p[key].detach().cpu().numpy()
                          .astype(np.float32).tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------

def _activate(x, name):
    if name == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if name == "mish":
        # The twin's softplus: logaddexp(x, 0).
        return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))
    if name == "logistic":
        return torch.sigmoid(x)
    return x


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def darknet_forward(params, cfg: List[Dict], x):
    """Run the network. x: (N, H, W, C) float (a tensor, or an array that
    goes to the parameters' device). Returns the list of YOLO head outputs
    (layer index, raw (N, Hf, Wf, C) feature map, section) and the list of
    all layer outputs, every map NHWC as in the twin."""
    dev = next(p["w"].device for p in params if p is not None)
    x = torch.as_tensor(x).to(dev, torch.float32)
    x = x.permute(0, 3, 1, 2).contiguous()
    outputs = []                         # NCHW
    yolo_outs = []
    for i, sec in enumerate(cfg[1:]):
        t = sec["type"]
        if t == "convolutional":
            p = params[i]
            stride = int(sec.get("stride", 1))
            k = int(sec.get("size", 1))
            pad = (k - 1) // 2 if int(sec.get("pad", 0)) else 0
            y = F.conv2d(x, p["w"], stride=stride, padding=pad,
                         groups=int(sec.get("groups", 1)))
            if "gamma" in p:
                c = lambda v: v[:, None, None]
                y = (y - c(p["mean"])) / torch.sqrt(c(p["var"]) + 1e-5)
                y = y * c(p["gamma"]) + c(p["beta"])
            else:
                y = y + p["bias"][:, None, None]
            y = _activate(y, sec.get("activation", "linear"))
        elif t == "route":
            groups = int(sec.get("groups", 1))
            gid = int(sec.get("group_id", 0))
            parts = [outputs[l if l >= 0 else len(outputs) + l]
                     for l in _int_list(sec["layers"])]
            y = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
            if groups > 1:
                cs = y.shape[1] // groups
                y = y[:, gid * cs:(gid + 1) * cs]
        elif t == "shortcut":
            frm = int(sec["from"])
            y = outputs[-1] + outputs[frm if frm >= 0 else len(outputs) + frm]
            y = _activate(y, sec.get("activation", "linear"))
        elif t == "maxpool":
            # The twin pads (k-1)//2 on both sides with -inf and keeps the
            # VALID windows; max_pool2d's implicit padding is -inf and its
            # floor-mode size the same (size=2, stride=1 shrinks by one).
            k = int(sec.get("size", 2))
            stride = int(sec.get("stride", k))
            y = F.max_pool2d(x, k, stride=stride, padding=(k - 1) // 2)
        elif t == "upsample":
            s = int(sec.get("stride", 2))
            y = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        elif t == "yolo":
            y = x
            yolo_outs.append((i, _nhwc(x), sec))
        else:
            y = x
        outputs.append(y)
        x = y
    return yolo_outs, [_nhwc(y) for y in outputs]


# ---------------------------------------------------------------------------
# YOLO decoding + NMS (reference: Darknet/YoloUtilities.hpp).
# ---------------------------------------------------------------------------

def yolo_decode(feat: torch.Tensor, sec: Dict, img_w: int, img_h: int,
                conf_thres: float = 0.25):
    """Decode one YOLO head: (1, Hf, Wf, A*(5+C)) NHWC -> flat boxes.

    Returns dict with boxes (N, 4) as (cx, cy, w, h) in pixels, score (N,),
    cls (N,), mask (N,)."""
    anchors = _int_list(sec["anchors"])
    mask_idx = _int_list(sec["mask"])
    num_classes = int(sec["classes"])
    A = len(mask_idx)
    _, Hf, Wf, _ = feat.shape
    dev = feat.device
    f = feat.reshape(Hf, Wf, A, 5 + num_classes).float()

    xs = torch.sigmoid(f[..., 0])
    ys = torch.sigmoid(f[..., 1])
    scale_xy = float(sec.get("scale_x_y", 1.0))
    if scale_xy != 1.0:
        xs = xs * scale_xy - 0.5 * (scale_xy - 1.0)
        ys = ys * scale_xy - 0.5 * (scale_xy - 1.0)
    gx = torch.arange(Wf, dtype=torch.float32, device=dev)[None, :, None]
    gy = torch.arange(Hf, dtype=torch.float32, device=dev)[:, None, None]
    cx = (xs + gx) / Wf * img_w
    cy = (ys + gy) / Hf * img_h
    anc = put(np.asarray([[anchors[2 * m], anchors[2 * m + 1]]
                          for m in mask_idx], np.float32), dev)
    # Darknet anchors are in network-input pixels; rescale to image pixels
    # (the network's input is the image here, as in the twin).
    net_w, net_h = img_w, img_h
    bw = torch.exp(f[..., 2]) * anc[:, 0] / net_w * img_w
    bh = torch.exp(f[..., 3]) * anc[:, 1] / net_h * img_h
    obj = torch.sigmoid(f[..., 4])
    score = obj[..., None] * torch.sigmoid(f[..., 5:])
    best_score, best_cls = torch.max(score, dim=-1)   # first maximum

    boxes = torch.stack([cx, cy, bw, bh], dim=-1).reshape(-1, 4)
    return {
        "boxes": boxes,
        "score": best_score.reshape(-1),
        "cls": best_cls.reshape(-1).to(torch.int32),
        "mask": best_score.reshape(-1) >= conf_thres,
    }


def nms_boxes(boxes, scores, mask, iou_thres: float = 0.45,
              max_out: int = 64):
    """Greedy class-agnostic NMS over (cx, cy, w, h) boxes, fixed capacity:
    ``max_out`` steps, each taking the first maximum of the live scores
    (``torch.max`` over a dim returns the first, like ``jnp.argmax``) and
    suppressing what overlaps it, with no host read.

    Returns (indices (max_out,) int32, keep_mask (max_out,) bool)."""
    half = boxes[:, 2:] / 2
    xyxy = torch.cat([boxes[:, :2] - half, boxes[:, :2] + half], dim=1)
    x1, y1, x2, y2 = xyxy.unbind(1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ar = torch.arange(boxes.shape[0], device=boxes.device)
    s = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    idx, best_scores = [], []
    for _ in range(max_out):
        best, i = torch.max(s, dim=0, keepdim=True)
        b = xyxy.index_select(0, i)[0]
        inter = (torch.clamp(torch.minimum(b[2], x2) - torch.maximum(b[0], x1),
                             min=0)
                 * torch.clamp(torch.minimum(b[3], y2)
                               - torch.maximum(b[1], y1), min=0))
        iou = inter / torch.clamp(area.index_select(0, i) + area - inter,
                                  min=1e-9)
        idx.append(i)
        best_scores.append(best)
        s = torch.where((iou > iou_thres) | (ar == i), float("-inf"), s)
    return (torch.cat(idx).to(torch.int32),
            torch.cat(best_scores) > float("-inf"))
