"""Checkpoint / resume of the incremental SfM state.

Twin of ``sara_tpu/io/checkpoint.py`` (the reference has no
checkpointing). The pose graph (+ relative-pose edges), map, tracker
state, per-frame host keypoint copies and the last accepted frame's full
keypoints (descriptors included — the next frame matches against them)
are serialized as one compressed NPZ in the reference's layout, so a
restored pipeline processes the next frame exactly as an uninterrupted run
would. Where the reference stores its PRNG key, the port stores the
pipeline generator's state (``torch.Generator.get_state()``, uint8) under
the same name; the meta also keeps the full-BA cadence counter, so a run
with ``full_ba_every`` resumes on the same beat. Device tensors come to
the host in one transfer; restored keypoints go to the pipeline's device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sara_tpu_torch.utils.host import fetch, put

_KP_FIELDS = ("xy", "scale", "orientation", "response", "descriptors",
              "mask")


def save_sfm_state(path: str, pipeline):
    """Serialize an OdometryPipeline's full resumable state."""
    pg = pipeline.pose_graph
    pc = pipeline.point_cloud
    tr = pipeline.tracker
    meta = {
        "num_poses": len(pg),
        "frame_indices": [p.frame_index for p in pg.poses],
        "tracker_offsets": tr.offsets,
        "tracker_counts": tr.counts,
        "scene_point_of_track": {str(k): int(v)
                                 for k, v in pc.scene_point_of_track.items()},
        "frames_since_ba": int(getattr(pipeline, "_frames_since_ba", 0)),
        "frames_since_full_ba": int(getattr(pipeline,
                                            "_frames_since_full_ba", 0)),
        "frame_tracker_ids": [f["tracker_id"] for f in pipeline.frames],
    }
    arrays = {
        "poses_R": np.stack([p.R for p in pg.poses]) if pg.poses else np.zeros((0, 3, 3)),
        "poses_t": np.stack([p.t for p in pg.poses]) if pg.poses else np.zeros((0, 3)),
        "points": pc.points,
        "colors": pc.colors,
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    }
    if tr.edges_a:
        arrays["edges_a"] = np.concatenate(tr.edges_a)
        arrays["edges_b"] = np.concatenate(tr.edges_b)
    if tr.responses:
        arrays["responses"] = np.concatenate(tr.responses)
    # Relative-pose edges (graph topology for pose-graph opt/loop closure).
    E = pg.edges
    arrays["edge_src"] = np.asarray([e.src for e in E], np.int64)
    arrays["edge_dst"] = np.asarray([e.dst for e in E], np.int64)
    arrays["edge_R"] = (np.stack([e.R for e in E]) if E
                        else np.zeros((0, 3, 3)))
    arrays["edge_t"] = np.stack([e.t for e in E]) if E else np.zeros((0, 3))
    arrays["edge_nm"] = np.asarray([e.num_matches for e in E], np.int64)
    arrays["edge_ni"] = np.asarray([e.num_inliers for e in E], np.int64)
    # Per-frame host keypoint copies (concatenated; split by tracker_counts
    # on load — add_frame registers exactly kp.capacity rows per frame).
    fr = pipeline.frames
    if fr:
        for name in ("xy", "scale", "response", "mask"):
            arrays["frames_" + name] = np.concatenate(
                [f["kp"][name] for f in fr], axis=0)
    # Last accepted frame's full keypoints (the matching target of the next
    # frame) + generator state: what load_sfm_state needs to resume.
    kp = pipeline._prev_keypoints
    if kp is not None:
        host = fetch(*(getattr(kp, name) for name in _KP_FIELDS))
        for name, a in zip(_KP_FIELDS, host):
            arrays["prev_kp_" + name] = a
    arrays["prng_key"] = pipeline._gen.get_state().numpy()
    np.savez_compressed(path, **arrays)


def load_sfm_state(path: str, pipeline):
    """Restore a pipeline saved by save_sfm_state into a RESUMABLE state:
    the returned pipeline's next process_frame/process_keypoints call
    behaves exactly as the uninterrupted run's would."""
    from sara_tpu_torch.core.types import Keypoints

    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    # The generator state is checked before anything of the pipeline is
    # touched: a JAX key, or the state of a generator on another device
    # type (the CPU generator's state is 5056 bytes, a CUDA generator's is
    # another size), cannot seed it.
    state = data["prng_key"] if "prng_key" in data else None
    if state is not None and state.dtype != np.uint8:
        raise ValueError(
            f"{path}: 'prng_key' holds a {state.dtype} PRNG key, not a "
            "torch.Generator state (uint8); it cannot seed the port's "
            "generator")
    want = pipeline._gen.get_state().numel()
    if state is not None and state.size != want:
        raise ValueError(
            f"{path}: a generator state of {state.size} bytes, but the "
            f"pipeline's generator on {pipeline.device} takes {want}; load "
            "it into a pipeline on the device type that saved it")

    pg = pipeline.pose_graph
    pg.poses = []
    pg.edges = []
    pg._adj = {}
    for i in range(meta["num_poses"]):
        pg.add_absolute_pose(data["poses_R"][i], data["poses_t"][i],
                             meta["frame_indices"][i])
    if "edge_src" in data:
        for k in range(len(data["edge_src"])):
            pg.add_relative_pose(int(data["edge_src"][k]),
                                 int(data["edge_dst"][k]),
                                 data["edge_R"][k], data["edge_t"][k],
                                 int(data["edge_nm"][k]),
                                 int(data["edge_ni"][k]))

    pc = pipeline.point_cloud
    pc.points = data["points"]
    pc.colors = data["colors"]
    pc.scene_point_of_track = {int(k): v for k, v
                               in meta["scene_point_of_track"].items()}

    tr = pipeline.tracker
    tr.offsets = list(meta["tracker_offsets"])
    tr.counts = list(meta["tracker_counts"])
    tr._total = (tr.offsets[-1] + tr.counts[-1]) if tr.offsets else 0
    # The persistent union-find / native tracker core may hold unions from
    # whatever this pipeline object did before the load — rebuild from the
    # loaded state.
    tr._uf = None
    tr._uf_edges_done = 0
    tr._tk = None
    if "responses" in data:
        # Split back into one batch per frame (the incremental core keys
        # features to frames by responses-batch position).
        resp = data["responses"]
        tr.responses = [resp[o:o + c] for o, c in zip(tr.offsets, tr.counts)]
    else:
        tr.responses = []
    if "edges_a" in data:
        tr.edges_a = [data["edges_a"]]
        tr.edges_b = [data["edges_b"]]
    else:
        tr.edges_a, tr.edges_b = [], []
    tr.compute_tracks()

    # Per-frame host keypoint copies.
    pipeline.frames = []
    if "frames_xy" in data:
        tids = meta.get("frame_tracker_ids",
                        list(range(len(meta["tracker_counts"]))))
        lo = 0
        for i, n in enumerate(meta["tracker_counts"]):
            kp_host = {name: data["frames_" + name][lo:lo + n]
                       for name in ("xy", "scale", "response", "mask")}
            pipeline.frames.append({"kp": kp_host, "tracker_id": tids[i],
                                    "image": None})
            lo += n

    if "prev_kp_xy" in data:
        pipeline._prev_keypoints = Keypoints(
            *(put(data["prev_kp_" + name], pipeline.device)
              for name in _KP_FIELDS))
    else:
        pipeline._prev_keypoints = None
    if state is not None:
        pipeline._gen.set_state(torch.from_numpy(state.copy()))
    pipeline._frames_since_ba = meta.get("frames_since_ba", 0)
    pipeline._frames_since_full_ba = meta.get("frames_since_full_ba", 0)
    pipeline._pending_image = None
    return pipeline
