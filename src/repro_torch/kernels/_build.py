"""Build, load and bind the hand-written CUDA kernels (`csrc/*.cu`).

At first use, ``nvcc`` compiles each source for ``sm_90a`` into an object
(one process per source, all started together) and links them into one
shared library with a plain C interface under
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the
repository root; `library` loads it with ``ctypes``.  Nothing here runs
when the module is imported, so the CPU tests can import every module.

`LAUNCHES` counts kernel launches, one per successful launch, bumped by
each wrapper (`kernels/bitmm.py`, `closure_update.py`,
`closure_delete.py`, the last two holding the dense and the tiled
variants, and `flash_attention.py`) right where it launches;
`kernels.ops` re-exports it.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bitmm.cu", "closure_update.cu", "closure_delete.cu",
           "closure_update_tiled.cu", "closure_delete_tiled.cu",
           "flash_attention.cu")
HEADERS = ("bitrow.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

LAUNCHES = {"bitmm": 0, "closure_update": 0, "closure_delete": 0,
            "closure_update_tiled": 0, "closure_delete_tiled": 0,
            "flash_attention": 0}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as void*, sizes as int;
# flash attention adds its scale as a float and its 12 strides as an array)
_SIGNATURES = {
    "repro_bitmm": [_VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "repro_closure_update": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "repro_closure_delete": [_VP, _VP, _VP, _VP, _INT, _INT, _VP],
    "repro_closure_update_tiled": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                                   _VP],
    "repro_closure_delete_tiled": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
    "repro_flash_attention": [_VP, _VP, _VP, _VP, *[_INT] * 8, ctypes.c_float,
                              ctypes.POINTER(ctypes.c_longlong), _VP],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME/bin)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build() -> Path:
    """Compile and link the kernels if this source hash has no library
    yet; returns the library's path.  Raises with nvcc's output on any
    failure."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src),
         "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs = []
    failed = []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "ptxas.log").write_text(log)
    os.replace(tmp, lib)  # atomic: a reader sees no library or a whole one
    for obj in objs:
        obj.unlink()
    return lib


def build_log() -> str:
    """nvcc's ``-Xptxas -v`` report (registers, shared memory, spills per
    kernel) of the build in use."""
    build()
    return (build_dir() / "ptxas.log").read_text()


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_operand(t: torch.Tensor, name: str, ndim: int,
                  device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous int32 CUDA tensor of ``ndim``
    dimensions (on ``device`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor for the kernel, "
                         f"got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must hold packed int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream with
    ``args`` (tensors pass their data pointers), raise if the launch
    failed, and count it under ``name``."""
    fn = getattr(library(), entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
