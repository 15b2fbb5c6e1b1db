"""nuScenes / nuImages JSON metadata loaders.

Twin of ``sara_tpu/io/nuscenes.py``, host code (the port keeps its own
copy) — the reference's loaders
(reference: cpp/src/DO/Sara/Datasets/NuScenes/NuScenes.hpp, NuImages.hpp —
nlohmann-json table readers with token cross-references).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List


class NuScenesTables:
    """Lazy loader of the nuScenes relational tables (sample, sample_data,
    ego_pose, calibrated_sensor, sensor, scene)."""

    TABLES = ["scene", "sample", "sample_data", "ego_pose",
              "calibrated_sensor", "sensor"]

    def __init__(self, dataroot: str, version: str = "v1.0-mini"):
        self.dataroot = dataroot
        self.version = version
        self._tables: Dict[str, List[dict]] = {}
        self._by_token: Dict[str, Dict[str, dict]] = {}

    def table(self, name: str) -> List[dict]:
        if name not in self._tables:
            path = os.path.join(self.dataroot, self.version, f"{name}.json")
            with open(path) as f:
                self._tables[name] = json.load(f)
            self._by_token[name] = {r["token"]: r for r in self._tables[name]}
        return self._tables[name]

    def get(self, name: str, token: str) -> dict:
        self.table(name)
        return self._by_token[name][token]

    def camera_frames(self, channel: str = "CAM_FRONT") -> List[dict]:
        """All sample_data records of a camera channel, with calibration and
        ego pose joined in."""
        out = []
        for sd in self.table("sample_data"):
            cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
            sensor = self.get("sensor", cs["sensor_token"])
            if sensor["channel"] != channel:
                continue
            rec = dict(sd)
            rec["camera_intrinsic"] = cs.get("camera_intrinsic")
            rec["sensor_rotation"] = cs.get("rotation")
            rec["sensor_translation"] = cs.get("translation")
            rec["ego_pose"] = self.get("ego_pose", sd["ego_pose_token"])
            out.append(rec)
        out.sort(key=lambda r: r["timestamp"])
        return out


class NuScenesAnnotations(NuScenesTables):
    """Annotation-side tables: sample_annotation (3-D boxes), instance,
    category, attribute, visibility (reference: NuScenes.hpp:95-170,
    load_sample_annotation_table / load_category_table)."""

    TABLES = NuScenesTables.TABLES + [
        "sample_annotation", "instance", "category", "attribute",
        "visibility"]

    def annotations_of_sample(self, sample_token: str) -> List[dict]:
        """All 3-D box annotations of one sample, with instance/category
        joined in (box: translation (3,), size (w, l, h), rotation
        quaternion (w, x, y, z))."""
        out = []
        for ann in self.table("sample_annotation"):
            if ann["sample_token"] != sample_token:
                continue
            rec = dict(ann)
            inst = self.get("instance", ann["instance_token"])
            rec["category_name"] = self.get(
                "category", inst["category_token"])["name"]
            out.append(rec)
        return out

    def boxes_in_camera(self, sd_rec: dict, max_depth: float = 80.0):
        """Project a camera frame's 3-D annotation boxes into the image.

        ``sd_rec`` is a record from :meth:`camera_frames`. Returns a list
        of dicts with the box center in pixels, depth, and category —
        global -> ego -> camera transform chain per the nuScenes devkit
        conventions."""
        import numpy as np

        def quat_to_R(q):
            w, x, y, z = q
            return np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)],
            ])

        ego = sd_rec["ego_pose"]
        R_e = quat_to_R(ego["rotation"])
        t_e = np.asarray(ego["translation"])
        R_s = quat_to_R(sd_rec["sensor_rotation"])
        t_s = np.asarray(sd_rec["sensor_translation"])
        Kcam = np.asarray(sd_rec["camera_intrinsic"])
        out = []
        for ann in self.annotations_of_sample(sd_rec["sample_token"]):
            c = np.asarray(ann["translation"])
            # global -> ego -> sensor.
            ce = R_e.T @ (c - t_e)
            cs = R_s.T @ (ce - t_s)
            if cs[2] <= 0.5 or cs[2] > max_depth:
                continue
            uv = Kcam @ cs
            out.append({
                "uv": (uv[:2] / uv[2]).tolist(),
                "depth": float(cs[2]),
                "size": ann["size"],
                "category_name": ann["category_name"],
                "instance_token": ann["instance_token"],
            })
        return out


class NuImagesTables(NuScenesTables):
    """nuImages metadata loader (reference: NuImages.hpp:29-149 —
    object_annotation 2-D boxes + masks, surface_annotation, and the
    camera-distortion-extended calibrated_sensor)."""

    TABLES = ["sample", "sample_data", "object_annotation",
              "surface_annotation", "category", "attribute", "ego_pose",
              "calibrated_sensor", "sensor", "log"]

    def object_annotations(self, sample_data_token: str) -> List[dict]:
        """2-D box annotations of one image, category joined in."""
        out = []
        for ann in self.table("object_annotation"):
            if ann["sample_data_token"] != sample_data_token:
                continue
            rec = dict(ann)
            rec["category_name"] = self.get(
                "category", ann["category_token"])["name"]
            out.append(rec)
        return out
