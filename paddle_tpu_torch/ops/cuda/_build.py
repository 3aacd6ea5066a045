"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles on first use into its own shared library
with a plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC`) and is loaded with `ctypes`.
No PyTorch header is included, so a build takes seconds. Libraries land
in `build/paddle_tpu_torch/` beside the package (listed in
`.gitignore`), named by a hash of their sources and flags: an edited
kernel rebuilds, an unchanged one loads from disk. `build()` starts one
`nvcc` per source, all at once, and waits for every one of them.

Pointers and the stream cross as `ctypes.c_void_p`, integers as
`ctypes.c_int`; a library may hold several C entries (`KERNELS`
maps each library to all of them). Every C entry returns
`cudaGetLastError()` after its launch; `check()` turns a non-zero code
into a `RuntimeError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

__all__ = ["KERNELS", "BUILD_DIR", "CSRC", "build", "load", "check",
           "dtype_code", "stream_ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/paddle_tpu_torch (the package sits at <repo>/paddle_tpu_torch)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel library -> {C entry: its argument types} (restype is c_int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the flash entries take a pointer to their Params struct, the dtype,
# the device and the stream
_FLASH = [_P, _I, _I, _P]
KERNELS = {
    "layer_norm": {
        "ptt_layer_norm_fwd": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
        "ptt_layer_norm_bwd": [_P] * 7 + [_I, _I, _I, _F, _I, _I, _P],
    },
    "ragged_paged_attention": {
        "ptt_ragged_paged_attention": [_P] * 7 + [_I] * 10 + [_P],
    },
    "flash_attention": {
        "ptt_flash_fwd": _FLASH,
        "ptt_flash_dq": _FLASH,
        "ptt_flash_dkv": _FLASH,
    },
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# name -> loaded library (a process loads each library once)
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile every named kernel library whose hashed target is
    missing, one `nvcc` process per source, all started together.
    Returns {name: compiler output} (the `-Xptxas -v` register and
    shared-memory report; empty for a library that was already built).
    Raises RuntimeError naming the source if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed: List[str] = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, with every C entry that
    `KERNELS[name]` lists bound, building it first if its hashed target
    is missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    target = _target(name)
    if not target.exists():
        build([name])
    lib = ctypes.CDLL(str(target))
    for entry, argtypes in KERNELS[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib.ptt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"no CUDA kernel for dtype {dtype}; "
                        f"supported: {sorted(map(str, _DTYPE_CODES))}")


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
