"""Builds the CUDA sources under ``chemprop_tpu_torch/csrc`` with ``nvcc`` into
plain-C shared libraries and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``; the hash covers
the source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is reused. :func:`build_all` starts one ``nvcc`` per
source at once. Nothing is built when a module is imported: the first launch
on a CUDA tensor builds what it needs.

``LAUNCHES`` counts kernel launches by wrapper name; each wrapper adds one
where it launches its kernel, and nowhere else. ``UNSERVED`` counts the
batches whose shape a kernel cannot take, where the caller saw that before any
launch and took other kernels."""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = (
    "message", "message_tiles", "fused_iter", "iter2", "message_bwd", "message_bwd_tiles",
    "bwd_premul", "bwd_nodes", "iter_bwd", "segment", "gather", "grad_weight",
)

# C signatures of the exported functions: P a pointer (a tensor's data_ptr,
# None for null, or the stream), I an int; every function returns a C int
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "message": {"plain_message": [P, P, P, P, P, I, I, I, I, P]},
    "message_tiles": {
        "message_tiles": [P, P, P, P, P, P, I, I, I, I, I, P],
        "message_tiles_info": [I, I, I, P],
    },
    "fused_iter": {
        "fused_iter": [P, P, P, P, P, P, P, P, I, I, I, I, P],
        "fused_iter_info": [I, I, P],
    },
    "iter2": {
        "iter2": [P, P, P, P, P, P, P, P, P, I, I, I, I, P],
        "iter2_info": [I, I, P],
    },
    "message_bwd": {
        "bwd_message": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        "iter_bwd": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, P],
        "iter_bwd_splits": [I],
        "cross_rows": [P, P, P, P, P, P, I, I, P],
    },
    "message_bwd_tiles": {
        "bwd_message_tiles": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        "bwd_message_tiles_info": [I, I, I, I, P],
    },
    "bwd_premul": {
        "bwd_premul": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P],
        "bwd_premul_info": [I, I, P],
    },
    "bwd_nodes": {
        "bwd_nodes": [P, P, P, P, P, P, P, P, I, I, I, I, P],
        "bwd_nodes_info": [I, I, P],
    },
    "iter_bwd": {
        "iter_bwd_tiles": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        "iter_bwd_clusters": [I, I],
        "iter_bwd_info": [I, I, P],
    },
    "grad_weight": {"grad_weight": [P, P, P, P, I, I, I, P], "grad_weight_splits": [I, I, I]},
    "gather": {"row_gather": [P, P, P, I, I, I, P]},
    "segment": {
        "seg_sum": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
        "seg_sum_info": [I, I, I, I, I, I, I, P],
    },
}

LAUNCHES: collections.Counter = collections.Counter()
# batches a kernel could not serve, by wrapper name, where the caller then
# took other kernels for that batch (decided before any launch)
UNSERVED: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    key = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file
    return log


def build_all() -> dict[str, tuple[str, float]]:
    """Build every source in parallel (one ``nvcc`` each); returns each
    build's compiler log (register and shared-memory use from ``-Xptxas -v``)
    and its seconds, an empty log for a library that was already built."""

    def build(name):
        t0 = time.perf_counter()
        log = _finish(name, _start(name))
        return log, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        done = {name: pool.submit(build, name) for name in SOURCES}
    return {name: job.result() for name, job in done.items()}


def sass_contains(name: str, opcodes: tuple[str, ...]) -> dict[str, bool] | None:
    """Which of ``opcodes`` the machine code of ``csrc/<name>.cu``'s built
    library holds (``cuobjdump -sass``); None where the toolkit has no
    ``cuobjdump``."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_target(name))], capture_output=True,
                          text=True, check=True).stdout
    return {op: op in sass for op in opcodes}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def call(lib: ctypes.CDLL, fn: str, *args) -> None:
    """Call ``fn`` with tensors passed as device pointers, on the calling
    thread's current stream of the tensors' device (autograd runs a backward
    on a thread of its own, with the forward's device and stream made
    current), and raise if the launch reported an error. The tensors stay
    referenced by the caller until it returns, and PyTorch's allocator orders
    their reuse after the kernel on the same stream."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*cargs, stream)
    else:
        with torch.cuda.device(device):  # the launch itself goes to the current device
            err = getattr(lib, fn)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
