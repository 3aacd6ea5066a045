"""Launch the serving step's kernels once each and check them: the
program to run under `compute-sanitizer`.

    python -m paddle_tpu_torch.ops.cuda.launch_check [--quick]
    compute-sanitizer --tool memcheck python -m paddle_tpu_torch.ops.cuda.launch_check --quick
    (and --tool racecheck, --tool initcheck)

It builds the kernel libraries, then launches K1 on [512, 768]; K6
and K10 (both phases) in each pool lane — fp, fp8 (e4m3 pools) and q8
(K7 and K10's q8 lane, int8 pools with scales) — on `grouped_batch`'s
operands at the serving geometry of `chip_smoke.py` phase 3 (16 rows of
up to 32 queries, 12 heads of 64, pools of 993 pages of 16, seven rows
sharing 16 pages), in bf16 and f32, and at rep 4, D 128 in bf16
(`--quick`: the bf16 rep-1 batch only); K9 in its fp and fp8 lanes on
`decode_batch`'s legacy decode step (16 rows at q_len 1, two of them
trash rows), without and with an additive mask; and K8 and K8-q8
writing 512 K/V rows into those pools; synchronises; and checks that
K10's output equals K6's bit for bit in every lane, that K9's unmasked
output equals K6's at q_len 1 bit for bit, that K9's masked output
matches its plain version, that K8 and K8-q8 equal their plain versions
outside the trash page, that K1 matches its plain version, and that
every output is finite. Exits 0 when all hold. `grouped_batch`,
`decode_batch` and `lane_batch` also build the batches of
`chip_smoke.py` phase 2 and of the card tests.
"""
from __future__ import annotations

import sys
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["grouped_batch", "decode_batch", "lora_batch", "lane_batch",
           "ragged",
           "ragged_reference", "grouped", "decode", "FLASH_SERVING_CASES",
           "flash_serving_batch", "main"]

# K3's inputs on the serving paths at GPT-124M's width (12 heads of 64):
# case -> (batch, Lq, Lk, pos), pos a scalar cursor or None for per-row
# positions. The legacy step's batch-1 prefill chunks over the gathered
# view of 992 keys; the gather arm's unified step (16 rows of 32 queries,
# per-row window); generate()'s prefill and its decode steps over the
# dense cache of prompt 128 + 32 new tokens
FLASH_SERVING_CASES = {
    "legacy prefill Lq 8": (1, 8, 992, 500),
    "legacy prefill Lq 16": (1, 16, 992, 500),
    "legacy prefill Lq 32": (1, 32, 992, 500),
    "gather arm step": (16, 32, 992, None),
    "generate prefill": (8, 128, 160, 0),
    "generate decode": (8, 1, 160, 140),
}


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


def decode_batch(dev, dtype, h: int, hkv: int, d: int, seed: int = 0,
                 rows: int = 16, ps: int = 16, mp: int = 62,
                 trash: int = 0):
    """The legacy decode step's batch: q [rows, 1, h, d], pools of
    rows * mp + 1 pages of `ps` with page tables in shuffled page order,
    pos spread over 65-763 (phase 3's decode rows) and q_len 1 (for K6
    at q_len 1). The last `trash` rows are idle rows of that step: an
    all-trash table and a frozen pos near the end of the window. Returns
    (q, k_pool, v_pool, page_table, pos, q_len)."""
    rs = np.random.RandomState(seed)
    n_pages = rows * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(rows, mp)
    pos = rs.randint(65, 764, size=rows).astype(np.int32)
    if trash:
        table[rows - trash:] = 0
        pos[rows - trash:] = mp * ps - 3
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        dev, dtype)
    return (mk(rows, 1, h, d), mk(n_pages, ps, hkv, d),
            mk(n_pages, ps, hkv, d),
            *(torch.from_numpy(a).to(dev) for a in (
                table, pos, np.ones(rows, np.int32))))


def lora_batch(dev, dtype, seed: int = 3, b: int = 16, w: int = 32,
               cin: int = 768, cout: int = 768, r: int = 8, pages: int = 9):
    """K11's operands at the serving step's LoRA shapes by default (x
    [16, 32, 768], adapter pools of 9 pages at rank 8): x [b, w, cin],
    a_pool [pages, cin, r] and b_pool [pages, r, cout] (amplitude 0.05,
    page 0 the zero page) in `dtype`, apage int32 [b] (rows on pages
    0-8, then 1, 2, 3, 0, 4, 5, 6, ...), ascale f32 [b] (row 3 at scale
    0). Returns (x, a_pool, b_pool, apage, ascale)."""
    rs = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dev)
    a_pool, b_pool = mk(pages, cin, r) * 0.05, mk(pages, r, cout) * 0.05
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    order = [0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 0, 4, 5, 6]
    apage = torch.tensor([order[i % 16] % pages for i in range(b)],
                         dtype=torch.int32, device=dev)
    ascale = torch.from_numpy(rs.rand(b).astype(np.float32)).to(dev)
    ascale[min(3, b - 1)] = 0.0
    x = mk(b, w, cin)
    return (x.to(dtype), a_pool.to(dtype), b_pool.to(dtype), apage, ascale)


def flash_serving_batch(dev, dtype, case: str, seed: int = 0,
                        h: int = 12, d: int = 64):
    """K3's inputs for `case` of FLASH_SERVING_CASES: q [b, Lq, h, d],
    k and v [b, Lk, h, d], and the bool window mask the decode cache
    builds (`window_causal_mask`: [1, 1, Lq, Lk] for a scalar cursor,
    [b, 1, Lq, Lk] for per-row positions drawn so every window fits)."""
    from ...nlp.generation import window_causal_mask

    b, lq, lk, pos = FLASH_SERVING_CASES[case]
    rs = np.random.RandomState(seed)
    mk = lambda n: torch.from_numpy(rs.randn(b, n, h, d).astype(
        np.float32)).to(dev, dtype)
    q, k, v = mk(lq), mk(lk), mk(lk)
    if pos is None:
        pos = torch.from_numpy(rs.randint(0, lk - lq + 1, size=b).astype(
            np.int32)).to(dev)
    return q, k, v, window_causal_mask(pos, lq, lk, dev)


def decode(ops, mask=None):
    """K9 on a `decode_batch` (its q_len unused): the fp lane, or the fp8
    lane over e4m3 pools."""
    from . import paged_attention as tpa

    q, k, v, table, pos, _ = ops
    return tpa.paged_decode_attention(q, k, v, table, pos, mask)


def lane_batch(ops, lane: str):
    """A batch `ops` = (q, k_pool, v_pool, page_table, pos, q_len) with
    float pools, in pool lane `lane`: "fp" as is, "fp8" with the pools
    clipped to +-448 and converted to e4m3, "q8" with the pools quantized
    by `quantize_kv_rowwise`. Returns (ops, scales): scales holds the
    `k_scale`/`v_scale` keyword arguments (empty outside q8)."""
    from . import paged_attention as tpa

    q, k, v, table, pos, q_len = ops
    if lane == "fp":
        return ops, {}
    if lane == "fp8":
        k, v = (t.float().clamp(-tpa.FP8_MAX, tpa.FP8_MAX).to(tpa.FP8_DTYPE)
                for t in (k, v))
        return (q, k, v, table, pos, q_len), {}
    (k, ks), (v, vs) = (tpa.quantize_kv_rowwise(t) for t in (k, v))
    return (q, k, v, table, pos, q_len), {"k_scale": ks, "v_scale": vs}


def ragged(ops, scales, mask=None):
    """K6 in the batch's lane: K6, its fp8 lane or K7, with a user mask
    when given (the mask lane)."""
    from . import paged_attention as tpa

    if not scales:
        return tpa.ragged_paged_attention(*ops, mask=mask)
    q, k, v, table, pos, q_len = ops
    return tpa.ragged_paged_attention_q8(q, k, v, scales["k_scale"],
                                         scales["v_scale"], table, pos,
                                         q_len, mask=mask)


def ragged_reference(ops, scales, mask=None):
    """The plain version of `ragged` in the batch's lane (`mask`: the
    additive f32 [B, H, lq, lmax] form)."""
    from . import paged_attention as tpa

    if not scales:
        return tpa.ragged_attention_reference(*ops, mask=mask)
    q, k, v, table, pos, q_len = ops
    return tpa.ragged_attention_reference_q8(q, k, v, scales["k_scale"],
                                             scales["v_scale"], table, pos,
                                             q_len, mask=mask)


def grouped(ops, grp, scales):
    """K10 (both phases) in the batch's lane."""
    from . import paged_attention as tpa

    if not scales:
        return tpa.ragged_paged_attention_grouped(*ops, *grp)
    q, k, v, table, pos, q_len = ops
    return tpa.ragged_paged_attention_grouped_q8(
        q, k, v, scales["k_scale"], scales["v_scale"], table, pos, q_len,
        *grp)


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
        base, grp = grouped_batch(dev, dtype, h, hkv, d)
        for lane in ("fp", "fp8", "q8"):
            ops, scales = lane_batch(base, lane)
            o6 = ragged(ops, scales)
            o10 = grouped(ops, grp, scales)
            torch.cuda.synchronize()
            same = torch.equal(o6, o10)
            finite = bool(torch.isfinite(o10.float()).all())
            print(f"{lane} lane, K6 / K10 H={h} H_kv={hkv} D={d} {dtype}: "
                  f"group sizes {np.bincount(grp[0].cpu().numpy()).max()}, "
                  f"shared pages {int(grp[2].max())}; K10 == K6 bit for "
                  f"bit: {same}; finite: {finite}")
            ok &= same and finite
        # the writes: the batch's K/V rows into its pools, at its
        # positions (past a row's window into the trash page)
        q, k, v, table, pos, q_len = base
        upd = k[1:1 + q.shape[0] * q.shape[1] // k.shape[1]].reshape(
            q.shape[0], q.shape[1], hkv, d)
        fp8 = torch.zeros(k.shape, dtype=torch.uint8,
                          device=dev).view(tpa.FP8_DTYPE)
        codes = torch.zeros(k.shape, dtype=torch.int8, device=dev)
        sc = torch.zeros(k.shape[:3], device=dev)
        tpa.paged_scatter(fp8, upd, pos, table)
        tpa.paged_scatter_q8(codes, sc, upd, pos, table)
        torch.cuda.synchronize()
        want8 = tpa.paged_scatter_reference(
            torch.zeros_like(fp8.view(torch.uint8)).view(tpa.FP8_DTYPE), upd,
            pos, table)
        wantc, wants = tpa.paged_scatter_q8_reference(
            torch.zeros_like(codes), torch.zeros_like(sc), upd, pos, table)
        same = (torch.equal(fp8.view(torch.uint8)[1:],
                            want8.view(torch.uint8)[1:])
                and torch.equal(codes[1:], wantc[1:])
                and torch.equal(sc[1:], wants[1:]))
        print(f"K8 / K8-q8 [{tuple(upd.shape)}] {dtype}: equal to the plain "
              f"versions outside page 0: {same}")
        ok &= same
        base = decode_batch(dev, dtype, h, hkv, d, trash=2)
        lmax = base[3].shape[1] * base[1].shape[1]
        mask = torch.randn(base[0].shape[0], h, 1, lmax, generator=g,
                           device=dev)
        for lane in ("fp", "fp8"):
            ops, _ = lane_batch(base, lane)
            o9, o9m, o6 = decode(ops), decode(ops, mask), ragged(ops, {})
            torch.cuda.synchronize()
            same = torch.equal(o9, o6)
            err = (o9m.float() - tpa.paged_attention_reference(
                *ops[:5], tpa._mask_to_additive(mask, *mask.shape[:2], lmax)
            ).float()).abs().max().item()
            finite = bool(torch.isfinite(o9.float()).all()
                          and torch.isfinite(o9m.float()).all())
            print(f"{lane} lane, K9 H={h} H_kv={hkv} D={d} {dtype}: K9 == "
                  f"K6 at q_len 1 bit for bit: {same}; masked vs plain "
                  f"max_abs_err {err:.3e}; finite: {finite}")
            ok &= same and finite and err < 0.05
    print("launch_check:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
