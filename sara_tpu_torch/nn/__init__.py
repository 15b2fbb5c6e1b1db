"""Neural network inference (twin of ``sara_tpu/nn``): Darknet / YOLO.

The reference's NeuralNetworks layer (reference:
cpp/src/DO/Sara/NeuralNetworks/Darknet/ — Parser.hpp, Layer.hpp,
Network.hpp, YoloUtilities.hpp; python/oddkiva/shakti/inference/darknet/).
"""

from sara_tpu_torch.nn.darknet import (
    parse_darknet_cfg, init_darknet_params, load_darknet_weights,
    save_darknet_weights,
    darknet_forward, yolo_decode, nms_boxes)

__all__ = [
    "parse_darknet_cfg", "init_darknet_params", "load_darknet_weights",
    "save_darknet_weights",
    "darknet_forward", "yolo_decode", "nms_boxes",
]
