"""The host library of the input pipeline (`native/host_ops.cc`, C++ bound
with ctypes), and its plain numpy/scipy versions.

Three jobs of the indoor datasets run on the host, in the loader's worker
threads: the ground-truth overlap labels (a radius search, Open3D's in the
original), the 1-NN of one cloud into another, and the sequential FPS of one
cloud. The library is a copy of the JAX package's, compiled with the same
flags, so both packages give the same labels, indices and distances.

It is compiled with `g++` at its first use into `ogmm_tpu_torch/_build/`,
named by the hash of the source and the flags (a changed source never loads
a stale library), under a lock across processes (`buildlock.build_lock`: one
build however many processes find it missing), and nothing is built next to
the source or when the module is imported. A failed build raises with the compiler's message: nothing
falls back. The plain versions (`*_plain`) are the reference the tests hold
the library against.

    radius_overlap(src_t, tgt, thresh) -> (src_label, tgt_label)
    nearest_neighbor(src, dst)         -> (dist, idx)
    fps_indices(xyz, npoint, start)    -> idx
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from ogmm_tpu_torch.buildlock import build_lock

SOURCE = Path(__file__).resolve().parent / "host_ops.cc"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> Path:
    """The library's path, named by the hash of the source and the flags."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libogmm_host_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is there (another process's build is
    waited for); raises with g++'s message."""
    out = lib_path()
    if out.exists():
        return out
    with build_lock(BUILD_DIR):
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the host library cannot be built: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i32, f32 = ctypes.c_int32, ctypes.c_float
            lib.ogmm_radius_overlap.argtypes = [f32p, i32, f32p, i32, f32,
                                                f32p, f32p]
            lib.ogmm_radius_overlap.restype = None
            lib.ogmm_nearest_neighbor.argtypes = [f32p, i32, f32p, i32,
                                                  f32p, i32p]
            lib.ogmm_nearest_neighbor.restype = None
            lib.ogmm_fps.argtypes = [f32p, i32, i32, i32, i32p]
            lib.ogmm_fps.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the host library builds (g++ at its first use) and loads
    here; where it does not, the functions below raise."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _c3(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a[:, :3], dtype=np.float32)


def radius_overlap(src_t: np.ndarray, tgt: np.ndarray, thresh: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Overlap masks of the ground-truth-aligned source src_t (N, 3) and tgt
    (M, 3), float32: a source point overlaps if a target point lies within
    `thresh`, a target point if some source point found it (Open3D's radius
    search semantics)."""
    lib = _load()
    s, t = _c3(src_t), _c3(tgt)
    src_label = np.empty(len(s), np.float32)
    tgt_label = np.empty(len(t), np.float32)
    lib.ogmm_radius_overlap(s, len(s), t, len(t), ctypes.c_float(thresh),
                            src_label, tgt_label)
    return src_label, tgt_label


def nearest_neighbor(src: np.ndarray, dst: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """1-NN distances (float32) and indices (int32) of src (N, 3) in dst."""
    lib = _load()
    s, d = _c3(src), _c3(dst)
    dist = np.empty(len(s), np.float32)
    idx = np.empty(len(s), np.int32)
    lib.ogmm_nearest_neighbor(s, len(s), d, len(d), dist, idx)
    return dist, idx


def fps_indices(xyz: np.ndarray, npoint: int, start: int) -> np.ndarray:
    """Sequential farthest-point sampling of one cloud from index `start`:
    (npoint,) int32."""
    lib = _load()
    x = _c3(xyz)
    idx = np.empty(npoint, np.int32)
    lib.ogmm_fps(x, len(x), npoint, int(start), idx)
    return idx


# ------------------------------------------------------------ plain versions

def radius_overlap_plain(src_t, tgt, thresh):
    """`radius_overlap` by a scipy KD-tree."""
    from scipy.spatial import cKDTree
    s, t = _c3(src_t), _c3(tgt)
    neigh = cKDTree(t).query_ball_point(s, thresh)
    src_label = np.array([len(nb) > 0 for nb in neigh], dtype=np.float32)
    tgt_label = np.zeros(len(t), np.float32)
    tgt_label[sorted({j for nb in neigh for j in nb})] = 1.0
    return src_label, tgt_label


def nearest_neighbor_plain(src, dst):
    """`nearest_neighbor` by a scipy KD-tree."""
    from scipy.spatial import cKDTree
    dist, idx = cKDTree(_c3(dst)).query(_c3(src), k=1)
    return dist.ravel().astype(np.float32), idx.ravel().astype(np.int32)


def fps_indices_plain(xyz, npoint, start):
    """`fps_indices` in numpy (float64 distances)."""
    x = _c3(xyz)
    n = len(x)
    dist = np.full(n, np.inf, np.float64)
    idx = np.zeros(npoint, np.int32)
    farthest = int(np.clip(start, 0, n - 1))
    for i in range(npoint):
        idx[i] = farthest
        np.minimum(dist, np.sum((x - x[farthest]) ** 2, -1), out=dist)
        farthest = int(np.argmax(dist))
    return idx
