"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/kernels/lib<name>_<digest>.so`` at the repo root, where ``<digest>``
hashes the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing is built at import time: the first wrapper call that launches a
kernel builds it (``build_all`` builds several sources at once, one ``nvcc``
process each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None) and the paths it writes."""
    out = library_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, out, tmp


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named source, all ``nvcc`` processes at once; returns the
    library paths.  Raises with the compiler's log if one fails."""
    started = {n: _start(n) for n in names}
    # wait for every nvcc before reporting a failure, so none outlives us
    codes = {n: proc.wait() for n, (proc, _, _) in started.items() if proc is not None}
    paths = {}
    for name, (proc, out, tmp) in started.items():
        if proc is not None:
            if codes[name] != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                                   + out.with_suffix(".log").read_text())
            os.replace(tmp, out)
        paths[name] = out
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LIBS[name] = lib
        return lib


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device, align: int = 16) -> None:
    """What a kernel takes: ``t`` on ``device`` with this dtype and shape,
    contiguous, and starting on an ``align``-byte boundary (16 for the
    kernels' vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")


# The one-launch step kernels' scan words (K5, K7, K9; csrc/episode_scan.cuh's
# step_scan_ints): two 64-bit head words, then one a tile, at most one tile
# a 256 worlds
def step_scan_ints(num_envs: int) -> int:
    return 2 * (2 + (num_envs + 255) // 256)


def check_step_scan(c_ints: Callable[[int], int], source: str) -> None:
    """Raise unless a library's count of scan words equals step_scan_ints."""
    for n in (1, 256, 257, 1 << 20):
        if c_ints(n) != step_scan_ints(n):
            raise RuntimeError(f"csrc/{source}'s scan words for {n} envs differ from "
                               "ops._build.step_scan_ints")


# Scan words by (device index, stream), shared by the step kernels: each
# launch leaves them zero, so they are zeroed once, on the stream whose
# launches then use them in order, and grow with the largest batch
_STEP_SCAN: Dict[Tuple[int, int], torch.Tensor] = {}


def step_scan(num_envs: int, device: torch.device, stream: int) -> torch.Tensor:
    """Zeroed int32 scan words for a step of ``num_envs`` envs on ``stream``
    of ``device``: the same buffer for every call on that stream while it is
    large enough."""
    key, need = (device.index or 0, stream), step_scan_ints(num_envs)
    scan = _STEP_SCAN.get(key)
    if scan is None or scan.numel() < need:
        scan = _STEP_SCAN[key] = torch.zeros(need, dtype=torch.int32, device=device)
    return scan


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for the current build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
