"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by its own `nvcc`
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface under `istio_tpu_torch/_build/`, and loaded with
ctypes. Nothing here runs at import time: the CPU tests import every
module of the package on a machine with no nvcc and no card.

`launches` counts, per kernel, the calls of its wrapper that launched
the kernel on the card (a wrapper given CPU tensors runs its plain
version and counts nothing); `launches.grids` counts the `__global__`
launches those calls made (rule_match and verdict_fold chain up to
three each). Inside `launches.capture()` each call also records the
wrapper's inputs, so a check can replay the kernel and its plain
version on exactly what the main path gave it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Sequence

import torch

KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold")

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class LaunchCounts(dict):
    """kernel name → wrapper calls that launched it since the last
    reset(); `grids`: kernel name → `__global__` launches of those calls."""

    def __init__(self) -> None:
        super().__init__({k: 0 for k in KERNELS})
        self.grids = {k: 0 for k in KERNELS}
        self.captured: list | None = None

    def reset(self) -> None:
        for k in KERNELS:
            self[k] = 0
            self.grids[k] = 0

    @contextmanager
    def capture(self):
        """Collect (kernel name, wrapper inputs) of every launch made
        inside the block."""
        self.captured = []
        try:
            yield self.captured
        finally:
            self.captured = None


launches = LaunchCounts()


def launched(name: str, grids: int, *inputs) -> None:
    """Called by a wrapper right after it launched kernel `name` as
    `grids` `__global__` launches."""
    launches[name] += 1
    launches.grids[name] += grids
    if launches.captured is not None:
        launches.captured.append((name, inputs))


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def _lib_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNELS) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library yet,
    one nvcc per source, all started together. → {name: {"seconds",
    "log", "cached"}}; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        dst = _lib_path(name)
        if dst.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, dst)
    failed = []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                     "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, dst)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point `symbol` of kernel `name`, typed: every pointer and
    the stream as c_void_p (a bare int would be cut to 32 bits), and an
    int return: the number of kernels launched, or -cudaError_t."""
    key = (name, symbol)
    fn = _funcs.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def check(rc: int, name: str) -> int:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError
    right after its launches); → the number of kernels it launched."""
    if rc < 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {-rc}")
    return rc


def stream_ptr() -> int:
    """The caller's current CUDA stream, on which every kernel launches."""
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
