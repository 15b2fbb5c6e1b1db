"""Darknet configurations for the port's tests and ``chip_smoke.py``.

``YOLOV4_TINY`` is the yolov4-tiny architecture written out from the
published ``cfg/yolov4-tiny.cfg`` of AlexeyAB/darknet: 21 convolutions,
CSP blocks built from channel-split routes, and two YOLO heads (13x13 and
26x26 for a 416x416 input, 3 x (5 + 80) = 255 channels each). No trained
weights ship with the repository: the tests and the smoke run draw them
with ``init_darknet_params(cfg, seed)``. Both packages parse the same
text, so their parity does not hang on how closely it matches the
published file.

``EDGE_CASES`` is a small network that reaches what yolov4-tiny does not:
``shortcut``, the ``mish`` and ``logistic`` activations, a grouped
convolution, and ``maxpool size=2 stride=1``, where the twin's padding of
(k - 1) // 2 = 0 per side shrinks the map by one.

``perturb_batch_norm`` moves the drawn batch-norm statistics off the
identity, so that a forward shows the batch norm's arithmetic.
"""

from pathlib import Path

import numpy as np

YOLOV4_TINY = """\
[net]
# Testing
#batch=1
#subdivisions=1
# Training
batch=64
subdivisions=1
width=416
height=416
channels=3
momentum=0.9
decay=0.0005
angle=0
saturation = 1.5
exposure = 1.5
hue=.1

learning_rate=0.00261
burn_in=1000

max_batches = 2000200
policy=steps
steps=1600000,1800000
scales=.1,.1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[route]
layers = -1,-2

[convolutional]
batch_normalize=1
filters=64
size=1
stride=1
pad=1
activation=leaky

[route]
layers = -6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[route]
layers = -1,-2

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[route]
layers = -6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[route]
layers = -1,-2

[convolutional]
batch_normalize=1
filters=256
size=1
stride=1
pad=1
activation=leaky

[route]
layers = -6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

##################################

[convolutional]
batch_normalize=1
filters=256
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=80
num=6
jitter=.3
scale_x_y = 1.05
cls_normalizer=1.0
iou_normalizer=0.07
iou_loss=ciou
ignore_thresh = .7
truth_thresh = 1
random=0
resize=1.5
nms_kind=greedynms
beta_nms=0.6

[route]
layers = -4

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers = -1, 23

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 1,2,3
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=80
num=6
jitter=.3
scale_x_y = 1.05
cls_normalizer=1.0
iou_normalizer=0.07
iou_loss=ciou
ignore_thresh = .7
truth_thresh = 1
random=0
resize=1.5
nms_kind=greedynms
beta_nms=0.6
"""

EDGE_CASES = """\
[net]
width=32
height=32
channels=3

# 0: batch-normalized, mish
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=mish

# 1: grouped convolution (4 groups of 4 channels)
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
groups=4
activation=leaky

# 2: residual sum with layer 0, then leaky
[shortcut]
from=-2
activation=leaky

# 3: the second half of the channels
[route]
layers=-1
groups=2
group_id=1

# 4: 8 + 16 channels
[route]
layers=-1,-3

# 5: the padding trap: (k-1)//2 = 0 on each side, the map shrinks by one
[maxpool]
size=2
stride=1

# 6: strided, logistic
[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=logistic

# 7: padded by one on each side, same size
[maxpool]
size=3
stride=1

# 8
[upsample]
stride=2

# 9: a head of 3 x (5 + 2) channels, with a bias
[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

# 10
[yolo]
mask = 0,1,2
anchors = 4,6,  9,8,  12,20
classes=2
num=3
scale_x_y = 1.1
"""


def write_cfg(directory, name: str = "yolov4-tiny") -> str:
    """Write one of the configurations (``"yolov4-tiny"`` or
    ``"edge-cases"``) as ``<directory>/<name>.cfg``; returns its path."""
    text = {"yolov4-tiny": YOLOV4_TINY, "edge-cases": EDGE_CASES}[name]
    path = Path(directory) / f"{name}.cfg"
    path.write_text(text)
    return str(path)


def perturb_batch_norm(params, seed: int):
    """``params`` with every batch-norm vector (gamma, beta, mean, var) and
    every bias drawn from ``RandomState(seed)`` in [0.5, 1.5], in sorted key
    order, instead of the identity that ``init_darknet_params`` gives
    (gamma 1, beta 0, mean 0, var 1). A forward that dropped the batch
    norm or swapped two of its vectors then differs. Conv weights pass
    through as they are; the drawn vectors are float32 numpy arrays."""
    rs = np.random.RandomState(seed)
    out = []
    for p in params:
        if p is None:
            out.append(None)
            continue
        out.append({k: p[k] if k == "w" else
                    rs.uniform(0.5, 1.5, np.shape(p[k])).astype(np.float32)
                    for k in sorted(p)})
    return out
