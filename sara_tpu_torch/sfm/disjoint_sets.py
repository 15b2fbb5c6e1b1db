"""Union-find / connected components with a native C++ fast path.

Twin of ``sara_tpu/sfm/disjoint_sets.py`` (reference:
cpp/src/DO/Sara/DisjointSets/DisjointSets.hpp, DisjointSetsV2.hpp). This is
host code next to the Python orchestrator. The native library is the
package's copy of the reference's union-find source, ``sfm/csrc/
sara_native.cpp``, compiled with the host C++ compiler into
``sara_tpu_torch/_build/`` at first use (``ops/_build.py``) and loaded by
ctypes. The NumPy union-find is the plain version, taken only when the
library cannot be built; :func:`backend` says which one is in use.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from sara_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sara_native.cpp"
_lock = threading.Lock()
_lib = None
_lib_error: str | None = None


def _load_native():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.ds_create.restype = ptr
            lib.ds_create.argtypes = [i64]
            lib.ds_destroy.argtypes = [ptr]
            lib.ds_union_edges.argtypes = [ptr, ptr, ptr, i64]
            lib.ds_components.argtypes = [ptr, ptr, i64]
            lib.connected_components.argtypes = [i64, ptr, ptr, i64, ptr]
            lib.compress_labels.restype = i64
            lib.compress_labels.argtypes = [ptr, i64, ptr]
            lib.tk_create.restype = ptr
            lib.tk_create.argtypes = [i64]
            lib.tk_destroy.argtypes = [ptr]
            lib.tk_add_features.argtypes = [ptr, ctypes.c_int32, ptr, i64]
            lib.tk_union_edges.argtypes = [ptr, ptr, ptr, i64]
            lib.tk_fill.argtypes = [ptr, i64, ptr, ptr, ptr, ptr]
            lib.tk_tracks.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr,
                                      ptr, ptr]
            _lib = lib
        except (OSError, RuntimeError) as e:
            _lib_error = str(e)
    return _lib


def backend() -> str:
    """``"native"`` when the C++ library is loaded (building it first if
    needed), else ``"numpy"``."""
    return "native" if _load_native() is not None else "numpy"


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class DisjointSets:
    """Incremental union-find over n elements (native-backed)."""

    def __init__(self, n: int):
        self.n = int(n)
        lib = _load_native()
        if lib is not None:
            self._h = lib.ds_create(self.n)
            self._lib = lib
            self._parent = None
        else:
            self._h = None
            self._lib = None
            self._parent = np.arange(self.n, dtype=np.int64)
            self._rank = np.zeros(self.n, dtype=np.int8)

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.ds_destroy(self._h)
            self._h = None

    def union_edges(self, a: np.ndarray, b: np.ndarray):
        a = np.ascontiguousarray(a, dtype=np.int64)
        b = np.ascontiguousarray(b, dtype=np.int64)
        if self._h is not None:
            self._lib.ds_union_edges(self._h, _ptr(a), _ptr(b), len(a))
        else:
            for x, y in zip(a, b):
                self._union(int(x), int(y))

    def components(self) -> np.ndarray:
        """Root label of every element."""
        out = np.empty(self.n, dtype=np.int64)
        if self._h is not None:
            self._lib.ds_components(self._h, _ptr(out), self.n)
        else:
            for i in range(self.n):
                out[i] = self._find(i)
        return out

    # -- NumPy plain version --
    def _find(self, x: int) -> int:
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:
            self._parent[x], x = root, self._parent[x]
        return root

    def _union(self, a: int, b: int):
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1


class TrackerCore:
    """Native incremental union-find + per-(component, frame) non-max
    suppression (winner maps merged small-into-large on union). Returns
    None from :func:`make_tracker_core` when the native library is
    unavailable; callers then use the batch path."""

    def __init__(self, capacity: int, lib):
        self.capacity = int(capacity)
        self.n = 0
        self._lib = lib
        self._h = lib.tk_create(self.capacity)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.tk_destroy(self._h)
            self._h = None

    def add_features(self, frame: int, responses: np.ndarray):
        r = np.ascontiguousarray(responses, dtype=np.float32)
        self._lib.tk_add_features(self._h, int(frame), _ptr(r), len(r))
        self.n += len(r)

    def union_edges(self, a: np.ndarray, b: np.ndarray):
        a = np.ascontiguousarray(a, dtype=np.int64)
        b = np.ascontiguousarray(b, dtype=np.int64)
        self._lib.tk_union_edges(self._h, _ptr(a), _ptr(b), len(a))

    def fill(self):
        """(roots, kept, comp_min_gid, comp_nframes), all per feature."""
        n = self.n
        roots = np.empty(n, np.int64)
        kept = np.empty(n, np.uint8)
        comp_min = np.empty(n, np.int64)
        comp_nframes = np.empty(n, np.int32)
        self._lib.tk_fill(self._h, n, _ptr(roots), _ptr(kept),
                          _ptr(comp_min), _ptr(comp_nframes))
        return roots, kept.astype(bool), comp_min, comp_nframes

    def tracks(self, min_length: int):
        """One native pass: (track_of_feature, component_of_feature,
        comp_min_gid (k,), rep_of_track (t,), k, t)."""
        n = self.n
        out_track = np.empty(n, np.int64)
        out_label = np.empty(n, np.int64)
        comp_min = np.empty(n, np.int64)
        reps = np.empty(n, np.int64)
        k = ctypes.c_int64()
        t = ctypes.c_int64()
        self._lib.tk_tracks(self._h, n, int(min_length), _ptr(out_track),
                            _ptr(out_label), _ptr(comp_min), _ptr(reps),
                            ctypes.byref(k), ctypes.byref(t))
        return (out_track, out_label, comp_min[:k.value].copy(),
                reps[:t.value].copy(), k.value, t.value)


def make_tracker_core(capacity: int):
    lib = _load_native()
    if lib is None:
        return None
    return TrackerCore(capacity, lib)


def dense_labels(raw: np.ndarray):
    """Compress arbitrary integer labels in [0, n) to dense [0, k).
    Returns (labels (n,) int64, k). Native fast path; np.unique otherwise."""
    raw = np.ascontiguousarray(raw, dtype=np.int64)
    n = len(raw)
    lib = _load_native()
    if lib is not None and n:
        out = raw.copy()
        scratch = np.empty(n, dtype=np.int64)
        k = lib.compress_labels(_ptr(out), n, _ptr(scratch))
        return out, int(k)
    uniq, labels = np.unique(raw, return_inverse=True)
    return labels.astype(np.int64), len(uniq)


def connected_components(n: int, a: np.ndarray, b: np.ndarray):
    """One-shot CC over an edge list. Returns (labels (n,), num_components)
    with dense labels in [0, k)."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    lib = _load_native()
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        lib.connected_components(n, _ptr(a), _ptr(b), len(a), _ptr(out))
        scratch = np.empty(n, dtype=np.int64)
        k = lib.compress_labels(_ptr(out), n, _ptr(scratch))
        return out, int(k)
    ds = DisjointSets(n)
    ds.union_edges(a, b)
    roots = ds.components()
    uniq, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64), len(uniq)
