"""Hold K2 (LayerNorm backward) and K8 (the paged KV write) as built here
against the same kernels as built from other checkouts, in turns on the
same inputs and the same card.

    python -m paddle_tpu_torch.ops.cuda.ln_scatter_turns OTHER [OTHER ...]

OTHER is the root of another checkout of this repo (for example the
parent commit, unpacked with `git archive`). Each checkout's
`csrc/layer_norm.cu` and `csrc/paged_scatter.cu` are compiled with this
build's flags into the build directory, and so are this checkout's (all
`nvcc` processes started together). A checkout whose libraries have this
build's C entries is called through the wrappers; one from before K2's
cluster plan and K8's paired entry through those entries' earlier
signatures (K2 with its own grid of min(rows / 8, 2 x SMs) blocks and
f32 partials [2, grid, cols]; K8 one write a call). Then, on each build
in turn (this, the others, the others reversed, this), behind a GPU
sleep (`flash_tile_sweep.device_ms`):

- K2 at [16384, 768] and [512, 768] in bf16 and at [16384, 768] in f32:
  dx must equal this build's bit for bit (its per-row arithmetic is
  unchanged); dw and db are reported as equal or not (their order of
  summation changed);
- K8 at the serving step's write (`launch_check.grouped_batch`'s bf16
  q [16, 32, 12, 64] as K, a second draw as V, its positions and
  tables) into e4m3 and bf16 pools: each build's pools must equal this
  build's bytes outside the trash page 0; K and V written one call each,
  and here also in one paired launch.

Prints the card's name and power limit, this build's ptxas report for
K2's and K8's serving instantiations and the ms per call of each case
on each build. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import layer_norm as tln
from . import paged_attention as tpa
from .flash_tile_sweep import device_ms
from .launch_check import grouped_batch

_LIBS = ("layer_norm", "paged_scatter")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entries' signatures before K2's cluster plan and K8's paired entry
_EARLIER = {"ptt_layer_norm_bwd": [_P] * 7 + [_I, _I, _I, _F, _I, _I, _P],
            "ptt_paged_scatter_float": [_P] * 4 + [_I] * 10 + [_P],
            "ptt_paged_scatter_e4m3": [_P] * 4 + [_I] * 9 + [_P]}
# the serving instantiations, mangled: K2 in bf16 at 3 vectors a lane
# (768 columns), K8 bf16 into e4m3 and into bf16 (16 and 8 elements a
# chunk); before the redesign `ln_bwd_kernel<bf16, 3>` and the warp-a-row
# `scatter_e4m3_kernel<bf16>` / `scatter_cast_kernel<bf16, bf16>`
SERVING = {"K2": re.compile(r"ln_bwd_kernelI13__nv_bfloat16Li3E"),
           "K8 e4m3": re.compile(r"scatter_tile_kernelI13__nv_bfloat16hLi16E"
                                 r"|scatter_e4m3_kernelI13__nv_bfloat16E"),
           "K8 bf16": re.compile(r"scatter_tile_kernelI13__nv_bfloat16S\w+"
                                 r"Li8E|scatter_cast_kernelI13__nv_bfloat16S")}


def build_all(roots) -> dict:
    """{(root, library): (path, compiler log)}, compiled in parallel."""
    procs = {}
    for i, root in enumerate(roots):
        for lib in _LIBS:
            src = Path(root) / "paddle_tpu_torch/ops/cuda/csrc" / f"{lib}.cu"
            out = _build.BUILD_DIR / "ln_scatter" / str(i) / f"lib{lib}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            procs[root, lib] = (out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ln_scatter_turns: {key} failed:\n{log}")
        built[key] = (out, log)
    return built


def ptxas_report(log: str, pattern) -> str:
    """ptxas's registers and spill line for the entry `pattern` names."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and pattern.search(line):
            return " / ".join(x.strip() for x in lines[i + 1:i + 4])
    return "not found"


# a mark of this build's C entries in a checkout's source: K2's plan
# entry, K8's paired entry (V's operands)
_MARKS = {"layer_norm": "ptt_layer_norm_bwd_plan", "paged_scatter": "v_upd"}


def _current(root, lib) -> bool:
    src = Path(root) / "paddle_tpu_torch/ops/cuda/csrc" / f"{lib}.cu"
    return _MARKS[lib] in src.read_text()


def _load(path, lib, current):
    """The library at `path`, its entries bound by this build's
    signatures (`current`) or by the earlier ones."""
    so = ctypes.CDLL(str(path))
    table = _build.KERNELS[lib] if current else {
        k: v for k, v in _EARLIER.items() if hasattr(so, k)}
    for entry, argtypes in table.items():
        fn = getattr(so, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    so.ptt_error_string.argtypes = [ctypes.c_int]
    so.ptt_error_string.restype = ctypes.c_char_p
    return so, current


def _k2_earlier(so, dy, x, w):
    """K2 through the earlier entry: its own grid and partials."""
    rows, cols = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    groups = max(1, min(-(-rows // 8), 2 * sms))
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
    part = torch.empty((2, groups, cols), dtype=torch.float32,
                       device=x.device)
    err = so.ptt_layer_norm_bwd(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), part.data_ptr(), rows, cols, groups,
        1e-5, _build.dtype_code(x.dtype), x.device.index,
        _build.stream_ptr(x.device))
    _build.check(so, err, "earlier K2")
    return dx, dw, db


def _k8_earlier(so, pool, upd, pos, table):
    """One K8 write through the earlier entries."""
    geo = tpa._scatter_geometry(pool, upd, table)
    head = (upd.data_ptr(), pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), *geo, _build.dtype_code(upd.dtype))
    tail = (pool.device.index, _build.stream_ptr(pool.device))
    if pool.dtype == tpa.FP8_DTYPE:
        err = so.ptt_paged_scatter_e4m3(*head, *tail)
    else:
        err = so.ptt_paged_scatter_float(*head, _build.dtype_code(pool.dtype),
                                         *tail)
    _build.check(so, err, "earlier K8")
    return pool


def main(argv=None) -> int:
    roots = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available() or not roots:
        print("ln_scatter_turns: needs CUDA and another checkout",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    here = str(Path(__file__).resolve().parents[3])   # this checkout
    built = build_all([here, *roots])
    for name, pat in SERVING.items():
        lib = "layer_norm" if name == "K2" else "paged_scatter"
        print(f"this build, {name} serving instantiation: "
              f"{ptxas_report(built[here, lib][1], pat)}")
    names = {here: "this", **{r: r for r in roots}}
    loaded = {(names[root], lib): _load(path, lib, _current(root, lib))
              for (root, lib), (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    ln_cases = {}
    for rows, dtype in ((16384, torch.bfloat16), (512, torch.bfloat16),
                        (16384, torch.float32)):
        mk = lambda *s: torch.randn(*s, generator=g, device=dev)
        ln_cases[f"K2 [{rows}, 768] {str(dtype)[6:]}"] = (
            mk(rows, 768).to(dtype), (mk(rows, 768) * 2 + 1).to(dtype),
            mk(768).to(dtype))
    base, _ = grouped_batch(dev, torch.bfloat16, 12, 12, 64)
    v_base, _ = grouped_batch(dev, torch.bfloat16, 12, 12, 64, seed=1)
    k_upd, v_upd, table, pos = base[0], v_base[0], base[3], base[4]
    shape = (base[1].shape[0], base[1].shape[1], 12, 64)
    pools = {"e4m3": lambda: torch.zeros(shape, dtype=torch.uint8,
                                         device=dev).view(tpa.FP8_DTYPE),
             "bf16": lambda: torch.zeros(shape, dtype=torch.bfloat16,
                                         device=dev)}
    order = ("this", *roots, *reversed(roots), "this")
    saved = {lib: _build._LIBS.get(lib) for lib in _LIBS}
    times, same, ref = {}, {}, {}

    def record(case, name, out, fn, must_equal):
        bits = [t.view(torch.uint8) if t.dtype == tpa.FP8_DTYPE else t
                for t in out]
        ref.setdefault(case, bits)
        eq = [torch.equal(a, b) for a, b in zip(bits, ref[case])]
        if must_equal and not all(eq[i] for i in must_equal):
            raise AssertionError(f"{case}: {name} differs from this build")
        same[name, case] = eq
        times.setdefault(case, {}).setdefault(name, []).append(
            round(device_ms(fn, iters=20), 4))

    try:
        for name in order:
            (ln_so, ln_new), (sc_so, sc_new) = (loaded[name, lib]
                                                for lib in _LIBS)
            _build._LIBS["layer_norm"], _build._LIBS["paged_scatter"] = \
                ln_so, sc_so
            for case, (dy, x, w) in ln_cases.items():
                fn = ((lambda: tln.layer_norm_bwd(dy, x, w, 1e-5)) if ln_new
                      else (lambda: _k2_earlier(ln_so, dy, x, w)))
                out = fn()
                torch.cuda.synchronize()
                record(case, name, out, fn, must_equal=(0,))
            for lane, mk in pools.items():
                kp, vp = mk(), mk()
                if sc_new:
                    fn = lambda: (tpa.paged_scatter_kernel(kp, k_upd, pos,
                                                           table),
                                  tpa.paged_scatter_kernel(vp, v_upd, pos,
                                                           table))
                else:
                    fn = lambda: (_k8_earlier(sc_so, kp, k_upd, pos, table),
                                  _k8_earlier(sc_so, vp, v_upd, pos, table))
                out = [t[1:] for t in fn()]
                torch.cuda.synchronize()
                record(f"K8 K, V one call each -> {lane}", name, out, fn,
                       must_equal=(0, 1))
                if sc_new:
                    kq, vq = mk(), mk()
                    fn = lambda: tpa.paged_scatter_kernel_pair(
                        kq, vq, k_upd, v_upd, pos, table)
                    out = [t[1:] for t in fn()]
                    torch.cuda.synchronize()
                    record(f"K8 K, V one call each -> {lane}", name + " pair",
                           out, fn, must_equal=(0, 1))
    finally:
        for lib, so in saved.items():
            if so is None:
                _build._LIBS.pop(lib, None)
            else:
                _build._LIBS[lib] = so
    for case, by_lib in times.items():
        print(f"{case}: ms per call in turns {by_lib}; outputs equal to "
              f"this build's: {dict((n, same[n, case]) for n in by_lib)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
