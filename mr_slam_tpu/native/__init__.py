"""ctypes bindings for the native runtime components.

The reference ships its combinatorial and I/O layers as C++ (the
fast_max-clique_finder used by PCM, rosbag/driver deserialization); this
package keeps those host-side pieces native too. The shared library
is built on demand with `make` (g++ only, no external deps); every
binding has a pure-Python fallback so the package works unbuilt.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libmrslam_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _try_build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-j4"],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.mrslam_max_clique.restype = ctypes.c_int
    lib.mrslam_max_clique.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mrslam_scanlog_writer_open.restype = ctypes.c_void_p
    lib.mrslam_scanlog_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.mrslam_scanlog_write.restype = ctypes.c_int
    lib.mrslam_scanlog_write.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
    ]
    lib.mrslam_scanlog_writer_close.argtypes = [ctypes.c_void_p]
    lib.mrslam_scanlog_open.restype = ctypes.c_void_p
    lib.mrslam_scanlog_open.argtypes = [ctypes.c_char_p]
    lib.mrslam_scanlog_n_frames.restype = ctypes.c_uint32
    lib.mrslam_scanlog_n_frames.argtypes = [ctypes.c_void_p]
    lib.mrslam_scanlog_max_points.restype = ctypes.c_uint32
    lib.mrslam_scanlog_max_points.argtypes = [ctypes.c_void_p]
    lib.mrslam_scanlog_next.restype = ctypes.c_int64
    lib.mrslam_scanlog_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.mrslam_scanlog_close.argtypes = [ctypes.c_void_p]
    lib.mrslam_kdtree_create.restype = ctypes.c_void_p
    lib.mrslam_kdtree_create.argtypes = [ctypes.c_int]
    lib.mrslam_kdtree_insert.restype = ctypes.c_int
    lib.mrslam_kdtree_insert.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
    ]
    lib.mrslam_kdtree_size.restype = ctypes.c_int
    lib.mrslam_kdtree_size.argtypes = [ctypes.c_void_p]
    lib.mrslam_kdtree_knn.restype = ctypes.c_int
    lib.mrslam_kdtree_knn.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
    ]
    lib.mrslam_kdtree_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def max_clique(adj: np.ndarray, exact: bool = True) -> Optional[np.ndarray]:
    """Native max clique; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    adj = np.ascontiguousarray(adj.astype(np.uint8))
    n = adj.shape[0]
    out = np.zeros((max(n, 1),), np.int32)
    size = lib.mrslam_max_clique(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        0 if exact else 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out[:size].astype(np.int64)


class ScanLogWriter:
    """Write a binary scan log (see scanlog.cpp for the format)."""

    def __init__(self, path: str, max_points: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.mrslam_scanlog_writer_open(path.encode(), max_points)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write(self, stamp: float, pose12: np.ndarray, xyz: np.ndarray) -> None:
        pose12 = np.ascontiguousarray(pose12, np.float32)
        xyz = np.ascontiguousarray(xyz, np.float32)
        self._lib.mrslam_scanlog_write(
            self._h, float(stamp),
            pose12.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            xyz.shape[0],
        )

    def close(self) -> None:
        if self._h:
            self._lib.mrslam_scanlog_writer_close(self._h)
            self._h = None


class ScanLogReader:
    """Iterate prefetched frames: (stamp, pose12, xyz_padded, n)."""

    def __init__(self, path: str):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.mrslam_scanlog_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.n_frames = lib.mrslam_scanlog_n_frames(self._h)
        self.max_points = lib.mrslam_scanlog_max_points(self._h)

    def __iter__(self):
        while True:
            stamp = ctypes.c_double()
            pose = np.zeros((12,), np.float32)
            xyz = np.zeros((self.max_points, 3), np.float32)
            n = self._lib.mrslam_scanlog_next(
                self._h, ctypes.byref(stamp),
                pose.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if n < 0:
                return
            yield stamp.value, pose, xyz, int(n)

    def close(self) -> None:
        if self._h:
            self._lib.mrslam_scanlog_close(self._h)
            self._h = None


class DescriptorKNN:
    """Incremental KNN over descriptor vectors — the descriptor-database
    index of the back-end (reference: the insertion-capable kd-tree of
    `global_manager/src/kdtree.cpp`, rebuilt per query at
    `global_manager.cpp:1002`). Uses the native kd-tree when the shared
    library is available; otherwise an exact brute-force numpy fallback
    (equivalent results, descriptors are high-dimensional anyway)."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self._lib = load()
        self._h = None
        if self._lib is not None:
            self._h = self._lib.mrslam_kdtree_create(self.dim)
        self._rows: list[np.ndarray] = []  # fallback store

    def __len__(self) -> int:
        if self._h:
            return self._lib.mrslam_kdtree_size(self._h)
        return len(self._rows)

    def insert(self, vec: np.ndarray) -> int:
        vec = np.ascontiguousarray(np.asarray(vec, np.float32).ravel())
        if vec.shape[0] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vec.shape[0]}")
        if self._h:
            return self._lib.mrslam_kdtree_insert(
                self._h, vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        self._rows.append(vec)
        return len(self._rows) - 1

    def knn(self, query: np.ndarray, k: int):
        """(indices (m,), distances (m,)) of the m<=k nearest rows."""
        query = np.ascontiguousarray(np.asarray(query, np.float32).ravel())
        if query.shape[0] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {query.shape[0]}")
        if self._h:
            k = max(int(k), 0)
            idx = np.zeros((max(k, 1),), np.int32)
            dist = np.zeros((max(k, 1),), np.float32)
            m = self._lib.mrslam_kdtree_knn(
                self._h, query.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                k, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return idx[:m].astype(np.int64), dist[:m]
        if not self._rows or k <= 0:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
        db = np.stack(self._rows)
        d = np.linalg.norm(db - query[None, :], axis=1)
        m = min(int(k), d.shape[0])
        idx = np.argpartition(d, m - 1)[:m]
        idx = idx[np.argsort(d[idx])]
        return idx.astype(np.int64), d[idx].astype(np.float32)

    def close(self) -> None:
        if self._h:
            self._lib.mrslam_kdtree_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
