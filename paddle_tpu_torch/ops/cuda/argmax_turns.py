"""Hold K12 (the greedy argmax) as built here against K12 as built from
other checkouts, in turns on the same inputs and the same card, and time
this build's launch at every cluster size.

    python -m paddle_tpu_torch.ops.cuda.argmax_turns [OTHER ...]

OTHER is the root of another checkout of this repo (for example the
parent commit, unpacked with `git archive`). Each checkout's
`csrc/greedy_argmax.cu` is compiled with this build's flags, and so is
this checkout's (`_build.build_checkouts`). A checkout whose entry takes
the launch (blocks a row and threads a block) is called with
`_argmax_plan`'s; one from before (a block of 1024 threads a row)
through its earlier signature (`_EARLIER`). Then, at ARGMAX_SHAPES in
f32 (a megakernel step's 16 slots, one row, 16 slots x a verify width of
8, Llama 3's vocabulary, 256 rows), on each build in turn
(`_build.turn_order`; three rounds) behind a GPU sleep
(`flash_tile_sweep.device_ms`): every build's answer must equal
`torch.argmax`. Prints the card's name and power limit, this build's
ptxas report, the ms per call of each build in each turn and their
means, a launch that does nothing (`torch.cuda._sleep(0)`, the floor of
every case), and this build's kernel at 1, 2, 4 and 8 blocks a row and
256, 512 and 1024 threads a block at each shape (`*` marks the plan's
launch). Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import paged_attention as tpa
from .flash_tile_sweep import device_ms

ARGMAX_SHAPES = ((16, 50304), (1, 50304), (128, 50304), (16, 128256),
                 (256, 50304))
_P, _I = ctypes.c_void_p, ctypes.c_int
# K12's entry before it took the launch
_EARLIER = {"ptt_greedy_argmax": [_P, _P, _I, _I, _I, _P]}
ROUNDS = 3


def _launcher(so, current: bool):
    """A function (x, out, plan=None) launching K12 from library `so`:
    with `plan` (blocks a row, threads) or `_argmax_plan`'s launch where
    the entry takes one (`current`), else through the earlier
    signature."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(x, out, plan=None):
        b, v = x.shape
        dev, stream = x.device.index, _build.stream_ptr(x.device)
        if current:
            s, threads = plan or tpa._argmax_plan(b, v, sms)
            err = so.ptt_greedy_argmax(x.data_ptr(), out.data_ptr(), b, v,
                                       s, threads, dev, stream)
        else:
            err = so.ptt_greedy_argmax(x.data_ptr(), out.data_ptr(), b, v,
                                       dev, stream)
        _build.check(so, err, "K12")
    return launch


def main(argv=None) -> int:
    others = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("argmax_turns: needs CUDA", file=sys.stderr)
        return 1
    here = str(Path(__file__).resolve().parents[3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    built = _build.build_checkouts([here, *others], ["greedy_argmax"],
                                   "argmax_turns")
    for line in built[here, "greedy_argmax"][1].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas (this build): {line.strip()}")
    launchers = {}
    for (root, lib), (path, _) in built.items():
        current = "int S" in _build.checkout_source(root, lib).read_text()
        so = _build.load_path(path, lib, None if current else _EARLIER)
        launchers["this" if root == here else root] = _launcher(so, current)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"a launch that does nothing (torch.cuda._sleep(0)): "
          f"{device_ms(lambda: torch.cuda._sleep(0), iters=20):.5f} ms")
    for b, v in ARGMAX_SHAPES:
        x = torch.randn(b, v, generator=g, device=dev)
        want = torch.argmax(x, dim=-1)
        out = torch.empty(b, dtype=torch.int32, device=dev)
        times = {name: [] for name in launchers}
        for _ in range(ROUNDS):
            for name in _build.turn_order(others):
                launch = launchers[name]
                launch(x, out)
                torch.cuda.synchronize()
                if not torch.equal(out.long(), want):
                    raise AssertionError(f"{name} disagrees with "
                                         f"torch.argmax at [{b}, {v}]")
                times[name].append(device_ms(lambda: launch(x, out),
                                             iters=20))
        for name, ms in times.items():
            print(f"[{b}, {v}] {name}: "
                  f"{', '.join(f'{t:.5f}' for t in ms)} ms; mean "
                  f"{sum(ms) / len(ms):.5f}")
        # this build's kernel at every cluster size and block size
        plan = tpa._argmax_plan(b, v, sms)
        launch = launchers["this"]
        row = []
        for s in (1, 2, 4, 8):
            for threads in (256, 512, 1024):
                launch(x, out, (s, threads))
                torch.cuda.synchronize()
                if not torch.equal(out.long(), want):
                    raise AssertionError(f"S {s}, {threads} threads")
                ms = device_ms(lambda: launch(x, out, (s, threads)),
                               iters=20)
                mark = "*" if (s, threads) == plan else ""
                row.append(f"S{s}/{threads}{mark} {ms:.5f}")
        print(f"[{b}, {v}] this build by launch: {', '.join(row)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
