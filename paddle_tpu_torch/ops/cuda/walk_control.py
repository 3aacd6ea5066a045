"""Hold K6 as built from other checkouts against K6 as built here: its
machine code, its outputs in every lane and its time on the card, in
turns on the same inputs.

    python -m paddle_tpu_torch.ops.cuda.walk_control OTHER [OTHER ...]

OTHER is the root of another checkout of this repo (for example the
parent commit, unpacked with `git archive`). Each checkout's
`csrc/ragged_paged_attention.cu` is compiled with this build's flags
into the build directory, and so is this checkout's (all `nvcc`
processes started together). For K6's serving instantiation — the
walk's (`ring_walk_kernel` in bf16 at DV 2, PJ 1, D 64, page size 16,
phase 2, unmasked; a checkout from before the ring names it
`row_walk_kernel`) — it prints, per library, ptxas's register and spill
report and the SASS (`cuobjdump -sass`) held against this build's,
instruction by instruction with addresses, encodings and the kernel's
name left out. Then K6 runs on `launch_check.grouped_batch`'s serving
batch (16 rows of up to 32 queries, 12 heads of 64, pages of 16) in f32
and bf16, in its fp, fp8 and q8 (K7) lanes, without a mask and with an
additive and a bool user mask: every other library's output must equal
this build's bit for bit, and 20 reruns here must repeat it. Each lane
is timed on the bf16 batch on each library in turn (this, the others,
the others reversed, this), behind a GPU sleep
(`flash_tile_sweep.device_ms`). Prints the card's name and power limit.
Needs CUDA, nvcc and cuobjdump.
"""
from __future__ import annotations

import ctypes
import difflib
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from .flash_tile_sweep import device_ms
from .launch_check import grouped_batch, lane_batch, ragged

_LIB = "ragged_paged_attention"
# K6's serving instantiation, mangled: the walk's (T bf16, DV 2, PJ 1,
# D 64, page size 16, phase 2, unmasked), or before the ring the row
# walk's (T bf16, DV 2, PJ 1, every bool template flag false)
_K6 = re.compile(r"ring_walk_kernelI13__nv_bfloat16Li2ELi1ELi64ELi16ELb0ELb0E"
                 r"|row_walk_kernelI13__nv_bfloat16Li2ELi1E(Lb0E)+E")
# the lanes and masks K6 is compared in: (lane, mask kind or None)
CASES = [(lane, mask) for lane in ("fp", "fp8", "q8")
         for mask in (None, "additive", "bool")]
REPEATS = 20


def build_others(roots) -> dict:
    """{root: (library path, compiler log)}, compiled in parallel."""
    procs = {}
    for i, root in enumerate(roots):
        src = Path(root) / "paddle_tpu_torch/ops/cuda/csrc" / f"{_LIB}.cu"
        out = _build.BUILD_DIR / "walk_control" / str(i) / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[root] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for root, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"walk_control: {root} failed:\n{log}")
        built[root] = (out, log)
    return built


def k6_sass(lib_path) -> list:
    """K6's serving instantiation's instructions in `lib_path`."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, on = [], False
    for line in text.splitlines():
        if "Function :" in line:
            on = bool(_K6.search(line))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if on and m:
            out.append(m.group(1))
    return out


def k6_ptxas(log: str) -> list:
    """ptxas's lines for K6's serving instantiation in a build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and _K6.search(line):
            return [x.strip() for x in lines[i + 1:i + 4]]
    return []


def _load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    entry = "ptt_ragged_paged_attention"
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = _build.KERNELS[_LIB][entry], ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def k6_cases(dev, dtype) -> dict:
    """{(lane, mask kind): (ops, scales, mask)} on the serving batch."""
    base, _ = grouped_batch(dev, dtype, 12, 12, 64)
    q, k = base[0], base[1]
    b, lq, h = q.shape[:3]
    lmax = base[3].shape[1] * k.shape[1]
    g = torch.Generator(device=dev).manual_seed(1)
    masks = {None: None,
             "additive": torch.randn(b, h, lq, lmax, generator=g,
                                     device=dev),
             "bool": torch.rand(b, 1, 1, lmax, generator=g, device=dev)
             < 0.7}
    masks["bool"][..., 0] = True
    out = {}
    for lane, kind in CASES:
        ops, scales = lane_batch(base, lane)
        out[lane, kind] = ops, scales, masks[kind]
    return out


def compare(libs: dict, dev, time_it: bool = True) -> dict:
    """Run K6 from each loaded library of `libs` ({name: CDLL}, "this"
    first) on every case of `k6_cases` in f32 and bf16; raise if another
    library's output differs from this build's or a rerun here differs.
    Returns {case: {name: [ms, ...]}} of the bf16 cases' times in turns
    (empty without `time_it`)."""
    names = [n for n in libs if n != "this"]
    times = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for (lane, kind), (ops, scales, mask) in k6_cases(
                    dev, dtype).items():
                tag = f"{lane} lane, mask {kind}, {dtype}"
                _build._LIBS[_LIB] = libs["this"]
                want = ragged(ops, scales, mask)
                for _ in range(REPEATS):
                    if not torch.equal(ragged(ops, scales, mask), want):
                        raise AssertionError(f"K6 {tag}: a rerun differs")
                for name in names:
                    _build._LIBS[_LIB] = libs[name]
                    if not torch.equal(ragged(ops, scales, mask), want):
                        raise AssertionError(
                            f"K6 {tag}: {name} differs from this build")
                if not time_it or dtype != torch.bfloat16:
                    continue
                for name in ("this", *names, *reversed(names), "this"):
                    _build._LIBS[_LIB] = libs[name]
                    times.setdefault(f"{lane}/{kind}", {}).setdefault(
                        name, []).append(round(device_ms(
                            lambda: ragged(ops, scales, mask)), 4))
    finally:
        _build._LIBS[_LIB] = libs["this"]
    return times


def main(argv=None) -> int:
    roots = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available() or not roots:
        print("walk_control: needs CUDA and at least one other checkout",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    here = str(Path(__file__).resolve().parents[3])   # this checkout
    built = build_others([here, *roots])
    libs = {"this": built[here], **{r: built[r] for r in roots}}
    base = k6_sass(libs["this"][0])
    for name, (path, log) in libs.items():
        sass = k6_sass(path)
        diff = [d for d in difflib.unified_diff(base, sass, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        print(f"{name}: K6 {len(sass)} instructions, {len(diff)} lines "
              f"differ from this build's; ptxas {k6_ptxas(log)}")
        for d in diff[:40]:
            print("   ", d)
    dev = torch.device("cuda", 0)
    loaded = {name: _load(path) for name, (path, _) in libs.items()}
    times = compare(loaded, dev)
    print(f"K6 equals every other build's bit for bit in {len(CASES)} "
          f"lane/mask cases, f32 and bf16, {REPEATS} reruns each")
    print(f"K6 bf16 [16, 32, 12, 64] grouped batch, ms per call in turns "
          f"(lane/mask: library: times): {times}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
