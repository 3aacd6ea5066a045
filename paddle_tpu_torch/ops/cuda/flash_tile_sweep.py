"""Time K4's tile choices on the card: the library as built against
variants of `struct Dq` in `csrc/flash_attention.cu`, in turns on the
same inputs.

    python -m paddle_tpu_torch.ops.cuda.flash_tile_sweep

Each variant is the source with one `Dq` line replaced, compiled beside
the library into the build directory (all `nvcc` processes started
together); the wrapper then runs on each library in turn (built,
variants, variants reversed, built) and every output is held against
`flash_dq_reference` with the tensor-core allowance. The variants:

- `d256_bm128`: head dim 256 in 128-row blocks (two consumer
  warpgroups), which leaves room for one K/V stage beside Q and dO;
- `d128_bn128`: head dim 128 with 128-key tiles and two stages.

Prints the card's name and power limit and K4's device time per call
(ms, behind a GPU sleep so the host's enqueue is not timed) at
[2, 1024, 4, 256], [16, 1024, 6, 128] and [16, 1024, 12, 64], bf16,
causal. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import torch

from . import _build
from . import flash_attention as tfa

_BASE = """struct Dq {
  static constexpr int NWG = D > 128 ? 1 : 2;
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr int STAGES = D > 128 ? 2 : 4;"""
VARIANTS = {
    "d256_bm128": _BASE.replace("D > 128 ? 1 : 2", "2").replace(
        "D > 128 ? 2 : 4", "D > 128 ? 1 : 4"),
    "d128_bn128": _BASE.replace("D == 64 ? 128 : 64", "D == 256 ? 64 : 128")
    .replace("D > 128 ? 2 : 4", "D == 64 ? 4 : 2"),
}
SHAPES = ((2, 1024, 4, 256), (16, 1024, 6, 128), (16, 1024, 12, 64))


def build_variants() -> dict:
    """{variant: path of its library}, compiled in parallel."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if _BASE not in src:
        raise RuntimeError("flash_tile_sweep: `struct Dq` changed; update "
                           "_BASE")
    procs = {}
    for name, text in VARIANTS.items():
        d = _build.BUILD_DIR / "tile_sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / "flash_attention.cu").write_text(src.replace(_BASE, text))
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"flash_tile_sweep: {name} failed:\n{log}")
        paths[name] = path
    return paths


def _load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in _build.KERNELS["flash_attention"].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call behind a GPU sleep that outlasts the
    enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tile_sweep: needs CUDA", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build(["flash_attention"])
    libs = {"built": _build.load("flash_attention")}
    libs.update({n: _load(p) for n, p in build_variants().items()})
    print(f"builds: {time.perf_counter() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    order = ("built", *VARIANTS, *reversed(VARIANTS), "built")
    try:
        for b, l, h, d in SHAPES:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v, do = (torch.randn(b, l, h, d, generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            _build._LIBS["flash_attention"] = libs["built"]
            o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
            args = (q, k, v, lse, tfa._row_dot(o, do), do)
            want = tfa.flash_dq_reference(*args, causal=True).float()
            # the rounding allowance plus two bf16 ulps (at most 2^-7 |x|
            # each) and the f32 term of chip_smoke.py's rule
            allowed = (tfa.dq_rounding_allowance(*args, causal=True)
                       + 2.0 ** -6 * want.abs() + 1e-5 * want.abs().max())
            times = {}
            for name in order:
                _build._LIBS["flash_attention"] = libs[name]
                got = tfa.flash_attention_dq(*args, causal=True).float()
                if not bool(((got - want).abs() <= allowed).all()):
                    raise AssertionError(f"K4 {name} [{b}, {l}, {h}, {d}] "
                                         "disagrees with its plain version")
                times.setdefault(name, []).append(round(device_ms(
                    lambda: tfa.flash_attention_dq(*args, causal=True)), 4))
            print(f"K4 bf16 [{b}, {l}, {h}, {d}] causal, ms per call in "
                  f"turns: {times}")
    finally:
        _build._LIBS["flash_attention"] = libs["built"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
