"""Build, load and bind the hand-written CUDA kernels (`csrc/*.cu`).

At first use, ``nvcc`` compiles each source for ``sm_90a`` into an object
(one process per source, all started together) and links them into one
shared library with a plain C interface under
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the
repository root; `library` loads it with ``ctypes``.  Nothing here runs
when the module is imported, so the CPU tests can import every module.

The launch path, shared by every wrapper and kept lean because B4 and B5
do a few us of device work a call: `check_operands` checks all of a
wrapper's operands in one pass, reading each attribute once; `launch`
calls the entry point's ctypes function, looked up once when the library
is loaded, on the raw pointer of the card's current stream
(``torch._C._cuda_getCurrentRawStream``, bound at the first launch since
the CPU build of torch lacks it), and enters a device guard only when
the operands' card is not the current one.  Wrappers allocate their
outputs with torch (B4, B5: ``torch.empty_like`` and ``new_empty``;
``chip_smoke.py`` phase 3 times them against other ways) and pass data
pointers and sizes; each entry point launches with ``<<<>>>`` and
returns ``cudaGetLastError``, and a non-zero return code raises.

`LAUNCHES` counts kernel launches, one per successful wrapper call (B1
and B3 launch twice a call, a count and the product, and count one),
bumped by each wrapper (`kernels/bitmm.py`, `closure_update.py`,
`closure_delete.py`, the last two holding the dense and the tiled
variants, `flash_attention.py` and `embbag.py`) right where it launches;
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
           "flash_attention.cu", "embbag.cu")
HEADERS = ("bitrow.cuh", "bitgemm.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

LAUNCHES = {"bitmm": 0, "closure_update": 0, "closure_delete": 0,
            "closure_update_tiled": 0, "closure_delete_tiled": 0,
            "flash_attention": 0, "embbag": 0}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as void*, sizes as int;
# flash attention adds its scale as a float and its 12 strides as an array;
# B1 and B3 take a work array, and have a "_paths" entry that takes it
# filled, for timing one path)
_SIGNATURES = {
    "repro_bitmm": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "repro_bitmm_paths": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "repro_bitgemm_dense_per_mille": [],
    "repro_closure_update": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "repro_closure_delete": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
    "repro_closure_delete_paths": [_VP, _VP, _VP, _VP, _VP, _INT, _INT,
                                   _VP],
    "repro_closure_update_tiled": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                                   _VP],
    "repro_closure_delete_tiled": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
    "repro_flash_attention": [_VP, _VP, _VP, _VP, *[_INT] * 8, ctypes.c_float,
                              ctypes.POINTER(ctypes.c_longlong), _VP],
    "repro_embbag": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
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
        _FUNCTIONS[name] = fn
    return lib


# the launch path's state, filled at the first launch (the CPU build of
# torch has no CUDA getters): C entry point -> its ctypes function, and
# torch's raw-stream and current-device getters
_FUNCTIONS: dict = {}
_CUDA: list = []

INT32 = (torch.int32,)


def check_operands(*operands):
    """Raise unless every ``(tensor, name, ndim, dtypes)`` of ``operands``
    is a contiguous CUDA tensor of one of ``dtypes`` with ``ndim``
    dimensions, all on the first one's card; returns that card's index
    and the operands' shapes.  Checks the operands in order and reads
    each attribute once."""
    index, shapes = None, []
    for t, name, ndim, dtypes in operands:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor for the kernel, "
                             f"got device {t.device}")
        at = t.get_device()
        if index is None:
            index, first = at, t
        elif at != index:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{first.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                            f"{t.dtype}")
        shape = t.shape
        if len(shape) != ndim:
            raise ValueError(f"{name} must have {ndim} dimensions, got "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shapes.append(shape)
    return index, shapes


def _bind_cuda() -> list:
    from torch._C import _cuda_getCurrentRawStream, _cuda_getDevice
    library()
    _CUDA[:] = [_cuda_getCurrentRawStream, _cuda_getDevice]
    return _CUDA


def launch(name: str, entry: str, index: int, *args) -> None:
    """Call C entry point ``entry`` with ``args`` (data pointers and
    sizes) on the current stream of card ``index``, raise if the launch
    failed, and count it under ``name``.  The device guard is entered only
    when ``index`` is not the current card."""
    stream_of, current = _CUDA or _bind_cuda()
    if index == current():
        rc = _FUNCTIONS[entry](*args, stream_of(index))
    else:
        with torch.cuda.device(index):
            rc = _FUNCTIONS[entry](*args, stream_of(index))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
