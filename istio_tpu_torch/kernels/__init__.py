"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<source>.cu` is compiled on first use by its own `nvcc`
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface under `istio_tpu_torch/_build/`, and loaded with
ctypes. Nothing here runs at import time: the CPU tests import every
module of the package on a machine with no nvcc and no card.

`launches` counts, per kernel, the calls of its wrapper that launched
the kernel on the card (a wrapper given CPU tensors runs its plain
version and counts nothing); `launches.grids` counts the `__global__`
launches those calls made (rule_match chains two, verdict_fold two with
quotas, four past 65,536 rows). Inside `launches.capture()` each call also records the
wrapper's inputs, so a check can replay the kernel and its plain
version on exactly what the main path gave it.

A probe build (`build(names, probe=True)`, `-DKERNEL_PROBE`) is a second
library of the same source whose kernels write timestamps at their stage
boundaries. Only measurement code loads it, inside `probing(name)`; the
served path never does.
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

KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold",
           "check_pack", "rule_stats", "list_banks", "field_eval",
           "quota_alloc", "route_select", "atom_eval", "seq_match",
           "mesh_fold")
# the C entry points of each source that has more than one (counted per
# wrapper call in `launches.entries`; mesh_fold's three entry points run
# inside one wrapper call and are counted in its grids)
ENTRY_POINTS = {"route_select": ("route_winner", "route_densify"),
                "field_eval": ("field_eval", "atom_eval"),
                "seq_match": ("chunk_map", "compose_maps"),
                "byte_pred": ("byte_pred", "byte_lits"),
                "dfa_scan": ("dfa_scan", "dfa_lits")}
# kernels built from another kernel's source: one interpreter with two
# entry points (csrc/field_eval.cu), and the sharded verdict fold's entry
# points beside the unsharded one, on one row-fold body
# (csrc/verdict_fold.cu)
SOURCE_OF = {"atom_eval": "field_eval", "mesh_fold": "verdict_fold"}

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class LaunchCounts(dict):
    """kernel name → wrapper calls that launched it since the last
    reset(); `grids`: kernel name → `__global__` launches of those calls;
    `entries`: entry point → calls, for the sources of ENTRY_POINTS."""

    def __init__(self) -> None:
        super().__init__({k: 0 for k in KERNELS})
        self.grids = {k: 0 for k in KERNELS}
        self.entries = {e: 0 for es in ENTRY_POINTS.values() for e in es}
        self.captured: list | None = None

    def reset(self) -> None:
        for k in KERNELS:
            self[k] = 0
            self.grids[k] = 0
        for e in self.entries:
            self.entries[e] = 0

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


def launched(name: str, grids: int, *inputs, entry: str | None = None
             ) -> None:
    """Called by a wrapper right after it launched kernel `name` as
    `grids` `__global__` launches (through C entry point `entry`, for a
    source of ENTRY_POINTS)."""
    launches[name] += 1
    launches.grids[name] += grids
    if entry is not None:
        launches.entries[entry] += 1
    if launches.captured is not None:
        launches.captured.append((name, inputs))


_lock = threading.Lock()
_libs: dict[tuple[str, bool], ctypes.CDLL] = {}
_funcs: dict[tuple[str, str, bool], ctypes._CFuncPtr] = {}
_probing: set[str] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def source_of(name: str) -> str:
    """The csrc/ source (without .cu) that kernel `name` is built from."""
    return SOURCE_OF.get(name, name)


def _lib_path(name: str, probe: bool = False) -> Path:
    name = source_of(name)
    # the source and every header of csrc/ it may include
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for inc in sorted(SRC_DIR.glob("*.cuh")):
        h.update(inc.read_bytes())
    digest = h.hexdigest()[:12]
    kind = "-probe" if probe else ""
    return BUILD_DIR / f"lib{name}{kind}-{digest}.so"


def build(names: Sequence[str] = KERNELS, probe: bool = False
          ) -> dict[str, dict]:
    """Compile the source of every named kernel that has no up-to-date
    library yet, one nvcc per source, all started together (`probe`:
    the probe builds, with -DKERNEL_PROBE). → {source: {"seconds",
    "log", "cached"}}; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in dict.fromkeys(source_of(n) for n in names):
        dst = _lib_path(name, probe)
        if dst.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *(["-DKERNEL_PROBE"] if probe else []),
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


def library(name: str, probe: bool = False) -> ctypes.CDLL:
    """The loaded library of kernel `name` (its probe build with
    `probe`), built first if needed."""
    name = source_of(name)
    with _lock:
        lib = _libs.get((name, probe))
        if lib is None:
            if not _lib_path(name, probe).exists():
                build([name], probe)
            lib = ctypes.CDLL(str(_lib_path(name, probe)))
            _libs[(name, probe)] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point `symbol` of kernel `name` (of its probe build inside
    `probing(name)`), typed: every pointer and the stream as c_void_p (a
    bare int would be cut to 32 bits), and an int return: the number of
    kernels launched, or -cudaError_t."""
    probe = source_of(name) in _probing
    key = (name, symbol, probe)
    fn = _funcs.get(key)
    if fn is None:
        fn = getattr(library(name, probe), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


@contextmanager
def probing(name: str):
    """Inside the block every wrapper of kernel `name`'s source launches
    from its probe build (`build(..., probe=True)`). → that library."""
    lib = library(name, probe=True)
    _probing.add(source_of(name))
    try:
        yield lib
    finally:
        _probing.discard(source_of(name))


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
