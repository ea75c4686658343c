"""Build and load the port's CUDA kernels: nvcc into `build/`, ctypes.

Each `csrc/<name>.cu` has a plain C interface and includes no PyTorch
header, so one nvcc call per source takes seconds. A source (a name in
`csrc/`, or a `Path` to a `.cu` elsewhere, as the probes under `tools/`
pass) is built at
first use into `<repo>/build/lib<name>-<hash>.so` (the hash covers the
source text and the flags, so an edited source never loads a stale
library) and opened with ctypes. `build()` compiles several sources in
parallel, one nvcc process each, all started together.

Every C entry point launches on the stream it is handed and returns
`cudaGetLastError()` right after the launch; `check` turns a non-zero
code into a RuntimeError. Nothing here catches a build or launch
failure.

`LAUNCHES` counts, per C entry point, the launches the wrappers really
made on the card (the plain versions on CPU tensors never count here),
so a run can show that its main path went through the kernels;
`BY_SHAPE` splits a wrapper's count by the call shape it names.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("wr_rows", "desc_ring", "flash_attention", "list_walk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {}     # C entry point -> launches on the card
BY_SHAPE: dict[str, dict] = {}    # C entry point -> {shape: launches}
LOGS: dict[str, str] = {}         # nvcc/ptxas output per built source

_LIBS: dict[str, ctypes.CDLL] = {}
_TYPED: dict[str, set] = {}       # entry points given their argtypes
_LOCK = threading.Lock()


def reset_launches():
    LAUNCHES.clear()
    BY_SHAPE.clear()


def count(fn: str, shape: str | None = None):
    LAUNCHES[fn] = LAUNCHES.get(fn, 0) + 1
    if shape is not None:
        by = BY_SHAPE.setdefault(fn, {})
        by[shape] = by.get(shape, 0) + 1


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def _paths(name: str | Path) -> tuple[Path, Path]:
    src = name if isinstance(name, Path) else CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def _start(name: str | Path):
    """Start nvcc for `name` unless its library is already built."""
    src, out = _paths(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def _finish(name: str | Path, job):
    proc, tmp, out = job
    so, se = proc.communicate()
    LOGS[name if isinstance(name, str) else name.stem] = so + se
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{so}{se}")
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none


def build(names=SOURCES):
    """Compile `names` in parallel (one nvcc each, started together)."""
    with _LOCK:
        jobs = [(name, _start(name)) for name in names]
        for name, job in jobs:
            if job is not None:
                _finish(name, job)


def load(name: str | Path, signatures: dict) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use.
    `signatures` maps each C function to its ctypes argtypes; every
    entry point returns an int CUDA error code. Several wrappers share
    one library, each naming the entry points it calls: every entry
    point gets its argtypes before any caller can reach it (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_paths(name)[1]))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
            _TYPED[name] = set()
        typed = _TYPED[name]
        for fn, argtypes in signatures.items():
            if fn not in typed:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                typed.add(fn)
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: "
                           f"{lib.kernel_error_string(rc).decode()}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
