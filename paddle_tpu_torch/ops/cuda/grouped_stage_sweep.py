"""Time K10's ring stage count on the card: the library as built against
variants with another `kRingStages` (csrc/paged_walk.cuh), in turns on
the same inputs.

    python -m paddle_tpu_torch.ops.cuda.grouped_stage_sweep

Each variant is the source with the `kRingStages` line changed, compiled
beside the library into the build directory (all `nvcc` processes
started together). K10a and K10b then run on each library in turn
(built, variants, variants reversed, built) on
`launch_check.grouped_batch`'s bf16 serving batch (16 rows of up to 32
queries, 12 heads of 64, pages of 16, seven rows sharing 16 pages),
behind a GPU sleep (`flash_tile_sweep.device_ms`), and every output is
held against K6's bit for bit. Prints the card's name and power limit
and each library's times (ms per call) in every turn. Needs CUDA and
nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import torch

from . import _build
from . import paged_attention as tpa
from .flash_tile_sweep import device_ms
from .launch_check import grouped_batch, ragged

_LIB = "grouped_paged_attention"
_BASE = "constexpr int kRingStages = 2;"
STAGES = (1, 3, 4)


def build_variants() -> dict:
    """{stages: path of its library}, compiled in parallel."""
    header = (_build.CSRC / "paged_walk.cuh").read_text()
    if _BASE not in header:
        raise RuntimeError("grouped_stage_sweep: `kRingStages` changed; "
                           "update _BASE")
    procs = {}
    for s in STAGES:
        d = _build.BUILD_DIR / "stage_sweep" / str(s)
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / "paged_walk.cuh").write_text(header.replace(
            _BASE, f"constexpr int kRingStages = {s};"))
        (d / f"{_LIB}.cu").write_text((_build.CSRC / f"{_LIB}.cu")
                                      .read_text())
        procs[s] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{_LIB}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    paths = {}
    for s, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"grouped_stage_sweep: {s} stages failed:\n"
                               f"{log}")
        paths[s] = path
    return paths


def _load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in _build.KERNELS[_LIB].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("grouped_stage_sweep: needs CUDA", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build([_LIB, "ragged_paged_attention"])
    libs = {2: _build.load(_LIB)}
    libs.update({s: _load(p) for s, p in build_variants().items()})
    print(f"builds: {time.perf_counter() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    ops, grp = grouped_batch(dev, torch.bfloat16, 12, 12, 64)
    args = tpa._grouped_check(*ops, *grp)
    want = ragged(ops, {})
    order = (2, *STAGES, *reversed(STAGES), 2)
    times = {}
    try:
        for s in order:
            _build._LIBS[_LIB] = libs[s]
            part = tpa.grouped_phase1(*args)
            got = tpa.grouped_phase2(*args, part)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K10 at {s} stages differs from K6")
            rec = times.setdefault(s, {"K10a": [], "K10b": []})
            rec["K10a"].append(round(device_ms(
                lambda: tpa.grouped_phase1(*args)), 4))
            rec["K10b"].append(round(device_ms(
                lambda: tpa.grouped_phase2(*args, part)), 4))
    finally:
        _build._LIBS[_LIB] = libs[2]
    print("K10 bf16 [16, 32, 12, 64] grouped batch, ms per call in turns "
          f"(stages: times): {times}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
