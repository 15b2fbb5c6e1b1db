"""HDF5 serialization of keypoints and matches.

Twin of ``sara_tpu/io/features_io.py`` (reference:
cpp/src/DO/Sara/Core/HDF5.hpp, Features/IO.hpp, Match/HDF5.hpp,
MultiViewGeometry/HDF5.hpp:27+). The file layout is the twin's (one group,
one dataset per field), so a file either package writes reads in the
other. ``h5py`` is imported inside each function. Loaded containers take
the port's dtypes (float32 fields, int32 indices, bool masks) on
``device`` (None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.types import Keypoints, Matches
from sara_tpu_torch.utils.host import fetch, put


def _write_group(path: str, group: str, fields: dict):
    import h5py

    with h5py.File(path, "a") as f:
        if group in f:
            del f[group]
        g = f.create_group(group)
        for name, val in fields.items():
            if val is not None:
                g.create_dataset(name, data=np.asarray(val))


def _read_fields(path: str, group: str, names, dtypes, device):
    import h5py

    dev = resolve_device(device)
    with h5py.File(path, "r") as f:
        g = f[group]
        return {name: put(np.asarray(g[name]).astype(dtypes.get(
                    name, np.float32)), dev) for name in names}


def save_keypoints_h5(path: str, kp: Keypoints, group: str = "keypoints"):
    _write_group(path, group, dict(zip(kp._fields, fetch(*kp))))


def load_keypoints_h5(path: str, group: str = "keypoints",
                      device: str | torch.device | None = None) -> Keypoints:
    return Keypoints(**_read_fields(path, group, Keypoints._fields,
                                    {"mask": bool}, device))


def save_matches_h5(path: str, m: Matches, group: str = "matches"):
    _write_group(path, group, dict(zip(m._fields, fetch(*m))))


def load_matches_h5(path: str, group: str = "matches",
                    device: str | torch.device | None = None) -> Matches:
    return Matches(**_read_fields(
        path, group, Matches._fields,
        {"i": np.int32, "j": np.int32, "mask": bool}, device))


def _host(val):
    if isinstance(val, torch.Tensor):
        return fetch(val)[0]
    return val


def save_two_view_geometry_h5(path: str, group: str = "two_view", *,
                              E=None, F=None, R=None, t=None, X=None,
                              inliers=None, cheirality=None, K1=None,
                              K2=None):
    """Serialize a two-view geometry estimate.

    Mirrors the reference's HDF5 types for EssentialMatrix /
    FundamentalMatrix / PinholeCameraDecomposition (K, R, t) and the
    TwoViewGeometry record (cameras + triangulated points + cheirality)
    (reference: MultiViewGeometry/HDF5.hpp:27-60,
    Geometry/TwoViewGeometry.hpp). All fields are optional (arrays or
    tensors); present ones are written as named datasets.
    """
    fields = {"E": E, "F": F, "R": R, "t": t, "X": X, "inliers": inliers,
              "cheirality": cheirality, "K1": K1, "K2": K2}
    _write_group(path, group, {k: _host(v) for k, v in fields.items()})


def load_two_view_geometry_h5(path: str, group: str = "two_view") -> dict:
    """Load a two-view geometry group as a dict of numpy arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f[group]
        return {name: np.asarray(g[name]) for name in g}
