"""Device rules and the loader for the hand-written CUDA kernels.

The rule of this package: a function that owns a kernel launches it when the
tensor it was given lies on a CUDA device, and uses the kernel's plain
PyTorch version only when the tensor lies on the CPU. Nothing falls back: a
build or launch failure raises.

The kernels live in `ogmm_tpu_torch/csrc/*.cu` (shared device code in
`csrc/*.cuh`). Each source has a plain C interface and is compiled on first
use with `nvcc` for `sm_90a` into a shared library under
`ogmm_tpu_torch/_build/` (one `nvcc` per library, all started together) and
bound with `ctypes`. `csrc/dgcnn_bwd.cu` gives one library a row class
(`dgcnn_bwd_k<KP>`, compiled with `-DBWD_KP=<KP>`). Nothing is built when a
module is imported. Builds hold a lock across processes
(`buildlock.build_lock`), so that the ranks of a fresh checkout run each
`nvcc` once between them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ogmm_tpu_torch.buildlock import build_lock

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# the row classes of the DGCNN backward kernels: a library of class KP takes
# graphs of k <= KP neighbours (ops/cuda_dgcnn_bwd.py:row_class)
BWD_ROW_CLASSES = (4, 8, 12, 16, 20, 24, 32)
# the libraries, each a source and the defines it is compiled with
VARIANTS = {f"dgcnn_bwd_k{kp}": ("dgcnn_bwd", (f"-DBWD_KP={kp}",))
            for kp in BWD_ROW_CLASSES}
SOURCES = ("dgcnn_eval", "sinkhorn_em", "graph_stage1", "nn1", *VARIANTS,
           "knn", "posenc_angles", "knn_stream", "wproject", "fps", "icp",
           "pointmlp")
# the kernels' wrappers; dgcnn_bwd.cu holds bwd_reduce, bwd_stage, bwd_edge,
# knn_stream.cu knn_stream and nn1_stream, dgcnn_eval.cu also dgcnn_edges
KERNELS = ("dgcnn_eval", "sinkhorn_em", "graph_stage1", "nn1", "bwd_reduce",
           "bwd_stage", "bwd_edge", "knn", "posenc_angles", "dgcnn_edges",
           "knn_stream", "nn1_stream", "wproject", "fps", "icp", "pointmlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches per kernel wrapper: a wrapper adds one where it launches its
# kernel and nowhere else
launch_counts: dict[str, int] = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means the card; the CPU has to be asked for by name."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ogmm_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of one library and the defines it is compiled with."""
    stem, defines = VARIANTS.get(name, (name, ()))
    return CSRC / f"{stem}.cu", defines


def _lib_path(name: str) -> Path:
    """The library of one source, named by the hash of the source, every
    header under csrc/ (a changed header must not load a stale library), the
    flags and the defines."""
    source, defines = _source(name)
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_kernels(names=SOURCES, verbose: bool = False) -> dict[str, Path]:
    """Compile every missing kernel library, all `nvcc` runs in parallel,
    under the build directory's lock (another process's build of the same
    libraries is waited for, not repeated).
    Returns {name: path of the shared library}."""
    paths = {name: _lib_path(name) for name in names}
    if all(p.exists() for p in paths.values()):
        return paths
    with build_lock(BUILD_DIR):
        _build_missing(paths, verbose)
    return paths


def _build_missing(paths: dict[str, Path], verbose: bool) -> None:
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, defines = _source(name)
        cmd = [_nvcc(), *NVCC_FLAGS, *defines]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(source)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load_kernel(name: str) -> ctypes.CDLL:
    """The shared library of one kernel source, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernels((name,))[name]))
        _libs[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str, symbol: str, argtypes: tuple):
    """The launcher `symbol` of kernel library `name`, its ctypes prototype
    (returns int, takes `argtypes`) bound once, at its first call."""
    fn = getattr(load_kernel(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check_launch(code: int, what: str) -> None:
    """Raise on the cudaError_t a launcher returned."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def current_stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's device (without the
    `torch.cuda.Stream` object `torch.cuda.current_stream` builds)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
