"""Time K11's cluster and block sizes on the card: the library as built
against variants of `csrc/lora_paged.cu`, in turns on the same inputs.

    python -m paddle_tpu_torch.ops.cuda.lora_sweep

Each variant is the source with one constant replaced, compiled beside
the library into the build directory (all `nvcc` processes started
together); the wrapper then runs on each library in turn (built,
variants, variants reversed, built) on `launch_check.lora_batch`'s
serving shapes (bf16 x [16, 32, 768], 9 adapter pages of rank 8), and
every output is held to K11's rule against `lora_delta_paged_reference`
(2 bf16 ulps + 1e-5 x max|ref| + one bf16 ulp of t through B and the
scale). The variants:

- `cluster4`, `cluster2`, `cluster1`: at most 4, 2 or 1 blocks a cluster
  (the built library takes 8), so t's partials cross fewer blocks and
  each block sums a wider slice of IN and writes a wider tile of OUT;
- `threads128`, `threads512`: 128 or 512 threads a block (the built
  library takes 256);
- `stop_start`, `stop_loads`, `stop_t`, `stop_combine`: the kernel
  returns at its start, after its first tiles land, after t's partial
  (of its first group of ranks: all of them at rank 8), after the
  cluster's partials are pushed and added (the output is then not K11's
  and is not checked): the time of each step, by difference.

Prints the card's name and power limit and K11's device time per call
(ms, behind a GPU sleep so the host's enqueue is not timed). Needs CUDA
and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import _build
from . import paged_attention as tpa
from .flash_tile_sweep import device_ms
from .launch_check import lora_batch

_CLUSTER = "constexpr int kMaxCluster = 8;"
_THREADS = "constexpr int kThreads = 256;"
# where the kernel stops in the `stop_*` variants, and what it leaves in
# out so that nothing before is dead code
_C = "  const int c = static_cast<int>(cluster.block_rank());"
_T = "  // ---- t's partial over this block's slice of IN, gr ranks at a time:"
_P = ("    // ---- this group's partials pushed to every block of the "
      "cluster ----")
_D = "  // ---- d = t . B, the scale, out: the tile of OUT in pieces ----"
_KEEP = ("  if (threadIdx.x == 0)\n    reinterpret_cast<float*>(a.out)"
         "[blockIdx.z * 8 + c] = {};\n  return;\n")
VARIANTS = {
    "cluster4": (_CLUSTER, _CLUSTER.replace("8", "4")),
    "cluster2": (_CLUSTER, _CLUSTER.replace("8", "2")),
    "cluster1": (_CLUSTER, _CLUSTER.replace("8", "1")),
    "threads128": (_THREADS, _THREADS.replace("256", "128")),
    "threads512": (_THREADS, _THREADS.replace("256", "512")),
    "stop_start": (_C, "  return;\n" + _C),
    "stop_loads": (_T, "  cp_wait<0>();\n  __syncthreads();\n" +
                   _KEEP.format("reinterpret_cast<float*>(smem)[0]") + _T),
    "stop_t": (_P, _KEEP.format("acc[0][0]") + _P),
    "stop_combine": (_D, _KEEP.format(
        "reinterpret_cast<float*>(smem + p.t_off)[0]") + _D),
}


def build_variants() -> dict:
    """{variant: path of its library}, compiled in parallel."""
    src = (_build.CSRC / "lora_paged.cu").read_text()
    procs = {}
    for name, (old, new) in VARIANTS.items():
        if old not in src:
            raise RuntimeError(f"lora_sweep: `{old}` is gone; update "
                               "VARIANTS")
        d = _build.BUILD_DIR / "lora_sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / "lora_paged.cu").write_text(src.replace(old, new))
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "lora_paged.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"lora_sweep: {name} failed:\n{log}")
        paths[name] = path
    return paths


def _load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in _build.KERNELS["lora_paged"].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def within_rule(out, x, A, B, apage, ascale) -> bool:
    """K11's bf16 rule (chip_smoke.py `check_lora_paged`)."""
    want = tpa.lora_delta_paged_reference(x, A, B, apage, ascale).float()
    ap = apage.long()
    t = torch.bmm(x.float(), A[ap].float()).to(torch.bfloat16).float()

    def ulp(v):
        _, e = torch.frexp(v.abs())
        return torch.where(v == 0, torch.zeros_like(v),
                           torch.ldexp(torch.ones_like(v), e - 8))

    flip = torch.bmm(ulp(t), B[ap].float().abs()) * \
        ascale.to(torch.bfloat16).float()[:, None, None]
    allowed = 2 * ulp(want) + 1e-5 * want.abs().max() + flip
    return bool(((out.float() - want).abs() <= allowed).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("lora_sweep: needs CUDA", file=sys.stderr)
        return 1
    _build.build(["lora_paged"])
    libs = {"built": _build.load("lora_paged")}
    libs.update({n: _load(p) for n, p in build_variants().items()})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    args = lora_batch(torch.device("cuda", 0), torch.bfloat16)
    order = ("built", *VARIANTS, *reversed(VARIANTS), "built")
    times = {}
    try:
        for name in order:
            _build._LIBS["lora_paged"] = libs[name]
            out = tpa.lora_delta_paged(*args)
            torch.cuda.synchronize()
            if not name.startswith("stop_") and not within_rule(out, *args):
                raise AssertionError(f"K11 of {name} breaks its rule")
            times.setdefault(name, []).append(round(device_ms(
                lambda: tpa.lora_delta_paged(*args), iters=20), 4))
    finally:
        _build._LIBS["lora_paged"] = libs["built"]
    x, A, B, apage, _ = args
    Ag, Bg = A[apage.long()], B[apage.long()]
    lib_ms = device_ms(lambda: torch.bmm(torch.bmm(x, Ag), Bg), iters=20)
    print(f"K11 bf16 [16, 32, 768] rank 8, ms per call in turns: {times}; "
          f"two torch.bmm over the gathered pages {lib_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
