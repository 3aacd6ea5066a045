"""Hold K1 and K2 (LayerNorm forward and backward), K8 (the paged KV
write) and K8-q8 (the int8 paged KV write) as built here against the
same kernels as built from other checkouts, in turns on the same inputs
and the same card.

    python -m paddle_tpu_torch.ops.cuda.ln_scatter_turns OTHER [OTHER ...]

OTHER is the root of another checkout of this repo (for example the
parent commit, unpacked with `git archive`). Each checkout's
`csrc/layer_norm.cu` and `csrc/paged_scatter.cu` are compiled with this
build's flags into the build directory, and so are this checkout's (all
`nvcc` processes started together). A checkout whose libraries have this
build's C entries is called through the wrappers; one from before the
weight dtype joined K1's and K2's entries (and K1's plan entry) through
those entries' earlier signatures (`_EARLIER`), and one without K8-q8's
paired entry writes K and V one call each (K8-q8's single write is
called through its entry, whose signature every build shares). Then, on
each build in turn (this, the others, the others reversed, this), behind
a GPU sleep (`flash_tile_sweep.device_ms`):

- K1 at [512, 768] (the serving step), [16, 768] (the legacy decode
  step) and [16384, 768] (the training step) in bf16: y must equal this
  build's bit for bit;
- K2 at [16384, 768] and [512, 768] in bf16 and at [16384, 768] in f32:
  dx, dw and db must equal this build's bit for bit;
- on builds with the wide lanes (those with this build's entries), K1
  and K2 at GPT-3 13B's width in bf16, [64, 5120] and [2048, 5120]: y
  must equal this build's bit for bit (K2's wide lane may sum in another
  order in another build: the equality of dx, dw and db is reported);
- K8 at the serving step's write (`launch_check.grouped_batch`'s bf16
  q [16, 32, 12, 64] as K, a second draw as V, its positions and
  tables) into e4m3 and bf16 pools, and K8-q8 into int8 code and f32
  scale pools: each build's pools must equal this build's bytes outside
  the trash page 0; K and V written one call each, and here also in one
  paired launch.

Prints the card's name and power limit, this build's ptxas report for
the serving instantiations of K1, K2, K8 and K8-q8, the ms per call of
each case on each build, and of a launch that does nothing (the floor
of every case). Needs CUDA and nvcc.
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
# K1's and K2's entries before they took the weight dtype
_EARLIER = {"ptt_layer_norm_fwd": [_P] * 4 + [_I, _I, _F, _I, _I, _P],
            "ptt_layer_norm_bwd": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
            "ptt_layer_norm_bwd_plan": [_I] * 4 + [_P]}
# the serving instantiations, mangled: K1 and K2 in bf16 at 3 vectors a
# lane (768 columns; K1 at 4 before its exact counts), K8 bf16 into e4m3
# and into bf16 (16 and 8 elements a chunk), K8-q8 bf16 at 8 elements a
# vector, one a lane (before the redesign the warp-a-row
# `scatter_q8_kernel<bf16>`)
SERVING = {"K1": re.compile(r"ln_fwd_kernelI13__nv_bfloat16(S\w+_)?Li3E"
                           r"|ln_fwd_kernelI13__nv_bfloat16Li4E"),
           "K2": re.compile(r"ln_bwd_kernelI13__nv_bfloat16(S\w+_)?Li3E"),
           "K8 e4m3": re.compile(r"scatter_tile_kernelI13__nv_bfloat16hLi16E"),
           "K8 bf16": re.compile(r"scatter_tile_kernelI13__nv_bfloat16S\w+"
                                 r"Li8E"),
           "K8-q8": re.compile(r"scatter_q8_kernelI13__nv_bfloat16"
                               r"(Li8ELi1E)?EEv")}


# a mark of this build's C entries in a checkout's source: K1's plan
# entry (with the weight dtype), K8-q8's paired entry
_MARKS = {"layer_norm": "ptt_layer_norm_fwd_plan",
          "paged_scatter": "ptt_paged_scatter_q8_pair"}


def _load(root, path, lib):
    """(the library at `path`, built from `root`, whether it has this
    build's entries): its entries bound by this build's signatures
    (where it has them, or where an entry kept its signature) or by the
    earlier ones."""
    current = _MARKS[lib] in _build.checkout_source(root, lib).read_text()
    return (_build.load_path(path, lib, None if current else _EARLIER),
            current)


def _where(t):
    return _build.dtype_code(t.dtype), t.device.index, _build.stream_ptr(
        t.device)


def _k1_earlier(so, x, w, b):
    """K1 through the earlier entry (x, w and b of one dtype)."""
    y = torch.empty_like(x)
    err = so.ptt_layer_norm_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                y.data_ptr(), x.shape[0], x.shape[1], 1e-5,
                                *_where(x))
    _build.check(so, err, "earlier K1")
    return (y,)


def _k2_earlier(so, dy, x, w, tickets):
    """K2 through the earlier entries: its plan (six ints), then the
    launch with its grid and partials."""
    rows, cols = x.shape
    plan = (ctypes.c_int * 6)()
    code, dev, _ = _where(x)
    _build.check(so, so.ptt_layer_norm_bwd_plan(rows, cols, code, dev, plan),
                 "earlier K2 plan")
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
    part = torch.empty(plan[5], dtype=torch.float32, device=x.device)
    err = so.ptt_layer_norm_bwd(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        rows, cols, plan[0], 1e-5, *_where(x))
    _build.check(so, err, "earlier K2")
    return dx, dw, db


def _q8_one(so, codes, scales, upd, pos, table):
    """One K8-q8 write through the single-write entry (its signature is
    the same in every build)."""
    err = so.ptt_paged_scatter_q8(
        upd.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        table.data_ptr(), pos.data_ptr(),
        *tpa._scatter_geometry(codes, upd, table), float(tpa.Q8_EPS),
        float(tpa.Q8_RECIP), *_where(upd))
    _build.check(so, err, "K8-q8")
    return codes, scales


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
    built = _build.build_checkouts([here, *roots], _LIBS, "ln_scatter")
    for name, pat in SERVING.items():
        lib = "layer_norm" if name in ("K1", "K2") else "paged_scatter"
        print(f"this build, {name} serving instantiation: "
              f"{_build.ptxas_report(built[here, lib][1], pat)}")
    names = {here: "this", **{r: r for r in roots}}
    loaded = {(names[root], lib): _load(root, path, lib)
              for (root, lib), (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)
    k1_cases = {f"K1 [{rows}, 768] bf16": tuple(
        t.to(torch.bfloat16) for t in (mk(rows, 768) * 2 + 1, mk(768),
                                       mk(768)))
        for rows in (512, 16, 16384)}
    k2_cases = {}
    for rows, dtype in ((16384, torch.bfloat16), (512, torch.bfloat16),
                        (16384, torch.float32)):
        k2_cases[f"K2 [{rows}, 768] {str(dtype)[6:]}"] = (
            mk(rows, 768).to(dtype), (mk(rows, 768) * 2 + 1).to(dtype),
            mk(768).to(dtype))
    wide_cases = {f"K1/K2 [{rows}, 5120] bf16": tuple(
        t.to(torch.bfloat16) for t in (mk(rows, 5120) * 2 + 1, mk(5120),
                                       mk(5120), mk(rows, 5120)))
        for rows in (64, 2048)}
    tickets = torch.zeros(8, dtype=torch.int32, device=dev)
    base, _ = grouped_batch(dev, torch.bfloat16, 12, 12, 64)
    v_base, _ = grouped_batch(dev, torch.bfloat16, 12, 12, 64, seed=1)
    k_upd, v_upd, table, pos = base[0], v_base[0], base[3], base[4]
    shape = (base[1].shape[0], base[1].shape[1], 12, 64)
    pools = {"e4m3": lambda: torch.zeros(shape, dtype=torch.uint8,
                                         device=dev).view(tpa.FP8_DTYPE),
             "bf16": lambda: torch.zeros(shape, dtype=torch.bfloat16,
                                         device=dev)}
    q8_pools = lambda: (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:3], device=dev))
    order = _build.turn_order(roots)
    saved = {lib: _build._LIBS.get(lib) for lib in _LIBS}
    times, same, ref = {}, {}, {}

    def record(case, name, out, fn, must_equal):
        bits = [t.view(torch.uint8) if t.dtype == tpa.FP8_DTYPE else t
                for t in out]
        ref.setdefault(case, bits)
        eq = [torch.equal(a, b) for a, b in zip(bits, ref[case])]
        if not all(eq[i] for i in must_equal):
            raise AssertionError(f"{case}: {name} differs from this build")
        same[name, case] = eq
        times.setdefault(case, {}).setdefault(name, []).append(
            round(device_ms(fn, iters=20), 5))

    def run(case, name, fn, cut, must_equal):
        out = [t[1:] if cut else t for t in fn()]
        torch.cuda.synchronize()
        record(case, name, out, fn, must_equal)

    try:
        for name in order:
            (ln_so, ln_new), (sc_so, sc_new) = (loaded[name, lib]
                                                for lib in _LIBS)
            _build._LIBS["layer_norm"], _build._LIBS["paged_scatter"] = \
                ln_so, sc_so
            tln._PLANS.clear()   # each build's own launches
            tln._BWD_PLANS.clear()
            for case, (x, w, b) in k1_cases.items():
                fn = ((lambda: (tln.layer_norm(x, w, b, 1e-5),)) if ln_new
                      else (lambda: _k1_earlier(ln_so, x, w, b)))
                run(case, name, fn, False, (0,))
            for case, (dy, x, w) in k2_cases.items():
                fn = ((lambda: tln.layer_norm_bwd(dy, x, w, 1e-5)) if ln_new
                      else (lambda: _k2_earlier(ln_so, dy, x, w, tickets)))
                run(case, name, fn, False, (0, 1, 2))
            if ln_new:
                for case, (x, w, b, dy) in wide_cases.items():
                    run(case.replace("K1/K2", "K1"), name,
                        lambda: (tln.layer_norm(x, w, b, 1e-5),), False,
                        (0,))
                    run(case.replace("K1/K2", "K2"), name,
                        lambda: tln.layer_norm_bwd(dy, x, w, 1e-5), False,
                        ())
            for lane, new in pools.items():
                kp, vp = new(), new()
                fn = lambda: (tpa.paged_scatter_kernel(kp, k_upd, pos, table),
                              tpa.paged_scatter_kernel(vp, v_upd, pos, table))
                case = f"K8 K, V -> {lane}"
                run(case, name, fn, True, (0, 1))
                if sc_new:
                    kq, vq = new(), new()
                    fn = lambda: tpa.paged_scatter_kernel_pair(
                        kq, vq, k_upd, v_upd, pos, table)
                    run(case, name + " pair", fn, True, (0, 1))
            (kc, ks), (vc, vs) = q8_pools(), q8_pools()
            fn = lambda: (*_q8_one(sc_so, kc, ks, k_upd, pos, table),
                          *_q8_one(sc_so, vc, vs, v_upd, pos, table))
            case = "K8-q8 K, V -> int8 + scales"
            run(case, name, fn, True, (0, 1, 2, 3))
            if sc_new:
                (kc2, ks2), (vc2, vs2) = q8_pools(), q8_pools()
                fn = lambda: (lambda o: (o[0], o[2], o[1], o[3]))(
                    tpa.paged_scatter_q8_pair(kc2, vc2, ks2, vs2, k_upd,
                                              v_upd, pos, table))
                run(case, name + " pair", fn, True, (0, 1, 2, 3))
            fn = lambda: _q8_one(sc_so, kc, ks, k_upd, pos, table)
            run("K8-q8 K alone -> int8 + scales", name, fn, True, (0, 1))
    finally:
        for lib, so in saved.items():
            if so is None:
                _build._LIBS.pop(lib, None)
            else:
                _build._LIBS[lib] = so
    for case, by_lib in times.items():
        print(f"{case}: ms per call in turns {by_lib}; outputs equal to "
              f"this build's: {dict((n, same[n, case]) for n in by_lib)}")
    # the floor under every case: a launch that does nothing, timed alike
    floor = [round(device_ms(lambda: torch.cuda._sleep(0), iters=20), 5)
             for _ in range(2)]
    print(f"a launch that does nothing (torch.cuda._sleep(0)): ms per call "
          f"{floor}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
