"""Time K9 and K11 as built here against K9 and K11 as built from other
checkouts, in turns on the same inputs and the same card.

    python -m paddle_tpu_torch.ops.cuda.decode_lora_turns [OTHER ...]

OTHER is the root of another checkout of this repo (for example the
parent commit, unpacked with `git archive`). Each checkout's
`csrc/paged_decode_attention.cu` (K9) and `csrc/lora_paged.cu` (K11) are
compiled with this build's flags into the build directory, and so are
this checkout's (all `nvcc` processes started together). Then, on each
library in turn (this, the others, the others reversed, this), behind a
GPU sleep (`flash_tile_sweep.device_ms`): K9 on `launch_check.
decode_batch`'s legacy decode step (bf16, 16 rows, 12 heads of 64, pages
of 16, pos 65-763) in its fp lane, its fp8 lane (e4m3 pools) and with a
random additive mask, and K11 on `launch_check.lora_batch`'s serving
shapes (bf16 x [16, 32, 768], 9 adapter pages of rank 8). Every K9
output without a mask must equal K6's at q_len 1 bit for bit; the masked
and K11 outputs are reported as equal to this build's or not (K11 sums t
in another order than before). Prints the card's name and power limit,
this build's ptxas report for K9's and K11's serving instantiations,
and the ms per call of each. Needs CUDA and nvcc.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import paged_attention as tpa
from .flash_tile_sweep import device_ms
from .launch_check import decode, decode_batch, lane_batch, lora_batch, ragged

# library -> the C entry the wrappers call (the same in every checkout)
_ENTRIES = {"paged_decode_attention": "ptt_paged_decode_attention",
            "lora_paged": "ptt_lora_delta_paged"}
# the serving instantiations, mangled: K9's bf16 head-dim-64 page-16
# kernel without a mask and with one (the walk's phase-2 instantiations,
# or before the walk was shared `decode_ring_kernel`), K11's bf16 kernel
SERVING = {"K9": re.compile(r"(ring_walk_kernel|decode_ring_kernel)I13__nv_"
                            r"bfloat16Li2ELi1ELi64ELi16E(Lb0ELb0E|Lb0EEv)"),
           "K9 masked": re.compile(r"(ring_walk_kernel|decode_ring_kernel)I13"
                                   r"__nv_bfloat16Li2ELi1ELi64ELi16E"
                                   r"(Lb0ELb1E|Lb1EEv)"),
           "K11": re.compile(r"lora_paged_kernelI13__nv_bfloat16Lb1E")}


def main(argv=None) -> int:
    roots = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("decode_lora_turns: needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    here = str(Path(__file__).resolve().parents[3])   # this checkout
    built = _build.build_checkouts([here, *roots], _ENTRIES, "turns")
    for name, pat in SERVING.items():
        lib = "lora_paged" if name == "K11" else "paged_decode_attention"
        print(f"this build, {name} serving instantiation: "
              f"{_build.ptxas_report(built[here, lib][1], pat)}")
    names = {here: "this", **{r: r for r in roots}}
    loaded = {(names[root], lib): _build.load_path(path, lib)
              for (root, lib), (path, _) in built.items()}
    dev = torch.device("cuda", 0)
    base = decode_batch(dev, torch.bfloat16, 12, 12, 64)
    fp8, _ = lane_batch(base, "fp8")
    lmax = base[3].shape[1] * base[1].shape[1]
    mask = torch.randn(base[0].shape[0], 12, 1, lmax, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    lora = lora_batch(dev, torch.bfloat16)
    cases = {"K9 bf16": lambda: decode(base),
             "K9-fp8": lambda: decode(fp8),
             "K9 bf16 masked": lambda: decode(base, mask),
             "K11 bf16 rank 8": lambda: tpa.lora_delta_paged(*lora)}
    k6 = {"K9 bf16": ragged(base, {}), "K9-fp8": ragged(fp8, {})}
    saved = {lib: _build._LIBS.get(lib) for lib in _ENTRIES}
    order = _build.turn_order(roots)
    times, same = {}, {}
    try:
        ref = {}
        for name in order:
            for lib in _ENTRIES:
                _build._LIBS[lib] = loaded[name, lib]
            for case, fn in cases.items():
                out = fn()
                torch.cuda.synchronize()
                if case in k6 and not torch.equal(out, k6[case]):
                    raise AssertionError(f"{case} of {name} differs from K6")
                ref.setdefault(case, out)
                same[name, case] = torch.equal(out, ref[case])
                times.setdefault(case, {}).setdefault(name, []).append(
                    round(device_ms(fn, iters=20), 4))
    finally:
        for lib, so in saved.items():
            if so is None:
                _build._LIBS.pop(lib, None)
            else:
                _build._LIBS[lib] = so
    for case, by_lib in times.items():
        print(f"{case}: ms per call in turns {by_lib}; equal to this "
              f"build's: {dict((n, same[n, case]) for n in by_lib)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
