"""Launch the serving step's kernels once each and check them: the
program to run under `compute-sanitizer`.

    python -m paddle_tpu_torch.ops.cuda.launch_check [--quick]
    compute-sanitizer --tool memcheck python -m paddle_tpu_torch.ops.cuda.launch_check --quick
    (and --tool racecheck, --tool initcheck)

It builds the kernel libraries, then launches K1 on [512, 768] and K6
and K10 (both phases) on `grouped_batch`'s operands at the serving
geometry of `chip_smoke.py` phase 3 (16 rows of up to 32 queries, 12
heads of 64, pools of 993 pages of 16, seven rows sharing 16 pages),
in bf16 and f32, and at rep 4, D 128 in bf16 (`--quick`: the bf16
rep-1 batch only); synchronises; and checks
that K10's output equals K6's bit for bit, that K1 matches its plain
version, and that every output is finite. Exits 0 when all hold.
`grouped_batch` also builds the grouped batches of `chip_smoke.py`
phase 2 and of the card tests.
"""
from __future__ import annotations

import sys
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["grouped_batch", "main"]


def grouped_batch(dev, dtype, h: int, hkv: int, d: int, seed: int = 0,
                  rows: int = 16, lq: int = 32, ps: int = 16, mp: int = 62,
                  groups: Sequence[Tuple[int, int, int]] = ((1, 7, 16),)):
    """A serving-step-shaped batch whose rows share prefix pages:
    q [rows, lq, h, d], pools of rows * mp + 1 pages of `ps`, page tables
    in shuffled page order. Each (first, members, shared) of `groups`
    makes rows first .. first + members - 1 point their first `shared`
    table entries at the same pages, with pos past the shared span (a
    prefix match never exceeds the prompt). Row 0 is idle on the trash
    page; the other rows take q_len in {1, 5, 17, lq}. Returns
    ((q, k_pool, v_pool, page_table, pos, q_len), (group_id,
    group_leader, group_cnt)), the groups from `shared_prefix_groups`."""
    from ...serving.prefix import shared_prefix_groups

    rs = np.random.RandomState(seed)
    n_pages = rows * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(rows, mp)
    table[0] = 0
    q_len = rs.choice([1, 1, 1, 5, 17, lq], size=rows).astype(np.int32)
    q_len[0] = 0
    lo = np.zeros(rows, np.int64)
    for first, members, shared in groups:
        sel = slice(first, first + members)
        table[sel, :shared] = table[first, :shared]
        lo[sel] = shared * ps
    pos = np.array([rs.randint(lo[r], mp * ps - q_len[r] + 1)
                    for r in range(rows)], np.int32)
    pos[0] = 0
    grp = shared_prefix_groups(table, q_len)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        dev, dtype)
    ops = (mk(rows, lq, h, d), mk(n_pages, ps, hkv, d),
           mk(n_pages, ps, hkv, d),
           *(torch.from_numpy(a).to(dev) for a in (table, pos, q_len)))
    return ops, tuple(torch.from_numpy(a).to(dev) for a in grp)


def main(argv=None) -> int:
    quick = "--quick" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("launch_check: CUDA is not available", file=sys.stderr)
        return 1
    from . import _build
    from . import layer_norm as tln
    from . import paged_attention as tpa

    dev = torch.device("cuda", 0)
    _build.build()
    ok = True
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(512, 768, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(768, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(768, generator=g, device=dev).to(torch.bfloat16)
    y = tln.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    err = (y.float() - tln.layer_norm_reference(x, w, b, 1e-5).float()
           ).abs().max().item()
    print(f"K1 [512, 768] bf16: max_abs_err {err:.3e}")
    ok &= err < 0.1
    cases = ((torch.bfloat16, 12, 12, 64), (torch.float32, 12, 12, 64),
             (torch.bfloat16, 16, 4, 128))
    for dtype, h, hkv, d in cases[:1] if quick else cases:
        ops, grp = grouped_batch(dev, dtype, h, hkv, d)
        o6 = tpa.ragged_paged_attention(*ops)
        o10 = tpa.ragged_paged_attention_grouped(*ops, *grp)
        torch.cuda.synchronize()
        same = torch.equal(o6, o10)
        finite = bool(torch.isfinite(o10.float()).all())
        print(f"K6 / K10 H={h} H_kv={hkv} D={d} {dtype}: group sizes "
              f"{np.bincount(grp[0].cpu().numpy()).max()}, shared pages "
              f"{int(grp[2].max())}; K10 == K6 bit for bit: {same}; "
              f"finite: {finite}")
        ok &= same and finite
    print("launch_check:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
