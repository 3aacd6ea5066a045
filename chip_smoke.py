#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (or any
sm_90a card), CUDA's `nvcc` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. build every kernel library from `paddle_tpu_torch/ops/cuda/csrc/`
   (layer_norm.cu: K1, K2; ragged_paged_attention.cu: K6;
   flash_attention.cu: K3, K4, K5; one nvcc per source, all at once)
   and print the build time and the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at
   the shapes each path gives it, in bf16 and f32 — K1 at the serving
   and the training step's, K6 at the serving step's, K2-K5 at the
   training step's; f32 outputs to 1e-5 x (1 + max|ref|), bf16 outputs
   element by element to 2 ulps — and time the kernel, the plain version
   and one PyTorch library call computing the same function
   (`F.layer_norm`, `native_layer_norm_backward`, SDPA and its
   backward), beside the bound from `bound()`;
3. serve GPT-124M at full width (bench.py's configuration: vocab 50304,
   hidden 768, 12 layers, 12 heads, 1024 positions) in bf16 with random
   weights from a seed: 24 requests of 32-700 prompt tokens, a third of
   them behind one shared 256-token system prompt, 64 greedy tokens
   each. Checks that every request finishes, that the step launched K6
   12 and K1 25 times per step, and that the held logits of one
   recorded step match a rerun of that step through the plain versions
   (on the CPU, in f32). Prints tokens/s, the step time and the TTFT;
4. train GPT-124M in bf16 as bench.py does (B 16 x L 1024, AdamW lr 1e-4,
   weight decay 0.01, dropout 0, ids and labels from
   `np.random.RandomState(0)`): 2 warm-up steps and 5 timed steps
   through `jit.compile_train_step`. Checks that the loss is finite and
   starts near ln(50304), that each step launched K1 25, K2 25, K3 12,
   K4 12 and K5 12 times, and a held step on a [2, 1024] batch: the
   kernel path's f32 loss and every parameter's gradient against the
   plain path's on the card, and the bf16 kernel loss against the f32
   plain loss. Prints tokens/s, the step time, the MFU by bench.py's
   formula against 989 TFLOP/s, and the device's busy share of a
   profiled step.

The second-to-last line is a JSON object with one record per kernel:
`launches` counts the launches on the path (`path`, serving or
training) whose shapes the record was measured at, and
`launches_by_path` those on each path. The last line is
`{"ok": true, "device": {...}}`. Without CUDA the script prints no
result and exits 1.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor
# core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEED = 0
GPT124M = dict(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
               num_attention_heads=12, max_position_embeddings=1024)
ENGINE = dict(num_slots=16, page_size=16, chunk_len=32, max_len=992)
N_REQUESTS, NEW_TOKENS, SHARED_PREFIX = 24, 64, 256
RECORD_STEP = 6          # the step whose held logits are re-run plain
# kernel vs plain version on the card; both compute in f32 from the same
# inputs. An f32 output: max error <= F32_TOL x (1 + max|ref|) (summation
# order). A bf16 output, element by element: <= BF16_ULPS ulps of the
# reference element plus F32_TOL x max|ref| (both round f32 values that
# differ by their summation order, so mostly 0 or 1 ulp apart)
F32_TOL, BF16_ULPS = 1e-5, 2
# held logits, bf16 path on the card vs the f32 plain rerun on the CPU:
# bf16 activations through 12 layers against f32 (logits have std ~0.5;
# the first H100 run measured 0.026)
HELD_LOGITS_TOL = 0.1
# phase 4: bench.py's train step
TRAIN = dict(batch=16, seq=1024, lr=1e-4, weight_decay=0.01, warmup=2,
             steps=5, held_batch=2)
# held train step on the card, kernel path vs plain path, both f32: the
# loss to 1e-5 relative and each gradient to 2e-5 of its largest
# element (summation order only: the kernels sum on the CUDA cores, the
# plain path through cuBLAS; the H100 runs measured 2.3e-6); the bf16
# kernel loss against the f32 plain loss to 0.05 (bf16 weights and
# activations through 12 layers)
HELD_LOSS_RTOL, HELD_GRAD_TOL, HELD_BF16_LOSS_TOL = 1e-5, 2e-5, 0.05


def log(msg: str):
    print(msg, flush=True)


class DeviceTimer:
    """Device time per call of a function, in ms. After a warm-up the
    calls are enqueued behind a GPU sleep that outlasts their host-side
    launch cost, so two CUDA events bracket back-to-back device work
    only. Inputs stay in L2 where they fit, as in the serving step, where
    the producer of each input has just written it."""

    def __init__(self, sleep_ms: float = 50.0):
        # the first launch pays for loading the sleep kernel: keep it out
        # of the calibration, which then sizes the sleep to ~sleep_ms
        self._events(lambda: torch.cuda._sleep(1000))
        cycles = 10 ** 7
        for _ in range(3):
            self.cycles = cycles
            self.sleep_ms = self._events(lambda: torch.cuda._sleep(cycles))
            cycles = int(cycles * sleep_ms / self.sleep_ms)

    @staticmethod
    def _events(body) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def __call__(self, fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(self.cycles)
        host = []

        def calls():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host.append((time.perf_counter() - t0) * 1e3)

        ms = self._events(calls)
        if host[0] >= 0.8 * self.sleep_ms:
            raise AssertionError(f"enqueue took {host[0]:.1f} ms, longer "
                                 f"than the {self.sleep_ms:.1f} ms sleep")
        return ms / iters


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (0 at 0)."""
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def check_close(name, got, want, mask=None):
    """Kernel output `got` against its plain version `want` by the rule
    of F32_TOL / BF16_ULPS above; returns the max abs error."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    diff = (got - want).abs()
    err = diff.max().item()
    ref_max = want.abs().max().item()
    if dtype == torch.bfloat16:
        allowed = BF16_ULPS * bf16_ulp(want) + F32_TOL * ref_max
        rule = f"{BF16_ULPS} bf16 ulps + {F32_TOL} x max|ref| per element"
    else:
        allowed = torch.full_like(want, F32_TOL * (1.0 + ref_max))
        rule = f"{F32_TOL} x (1 + max|ref|)"
    worst = (diff / allowed).max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= allowed).all())
    log(f"  {name}: max_abs_err={err:.3e}, worst err/allowed {worst:.3f} "
        f"({rule}, max|ref| {ref_max:.3e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# -- phase 2: kernels against their plain versions ------------------------
def check_layer_norm(dev, tln, time_ms):
    """K1 at the training step's shape [B * L, 768] and the serving
    step's [slots * chunk, 768], f32 and bf16, each timed in bf16. The
    record's times are the serving step's (K1's first path); the
    training step's are under `training_shape`."""
    cols = GPT124M["hidden_size"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs, times = {}, {}
    for path, rows in (("training", TRAIN["batch"] * TRAIN["seq"]),
                       ("serving", ENGINE["num_slots"] * ENGINE["chunk_len"])):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, cols, generator=g, device=dev) * 2 + 1
                 ).to(dtype)
            w = torch.randn(cols, generator=g, device=dev).to(dtype)
            b = torch.randn(cols, generator=g, device=dev).to(dtype)
            y = tln.layer_norm(x, w, b, 1e-5)
            torch.cuda.synchronize()
            errs[path, dtype] = check_close(
                f"K1 layer_norm [{rows}, {cols}] {dtype}", y,
                tln.layer_norm_reference(x, w, b, 1e-5))
        ms = time_ms(lambda: tln.layer_norm(x, w, b, 1e-5))
        plain_ms = time_ms(lambda: tln.layer_norm_reference(x, w, b, 1e-5))
        lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (cols,), w, b, 1e-5))
        n_bytes = 2 * rows * cols * x.element_size() + \
            2 * cols * w.element_size()
        bound_ms, bound_by = bound(n_bytes, 8 * rows * cols, F32_FLOPS)
        log(f"  K1 bf16 [{rows}, {cols}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        times[path] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib_ms,
                           max_abs_err=errs[path, torch.bfloat16])
    return dict(name="K1 layer_norm_fwd", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                replaces="paddle_tpu/ops/pallas/layer_norm.py:60",
                path="serving", **times["serving"],
                training_shape=times["training"])


def check_layer_norm_bwd(dev, tln, time_ms):
    rows, cols = TRAIN["batch"] * TRAIN["seq"], GPT124M["hidden_size"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        mk = lambda *s: torch.randn(*s, generator=g, device=dev)
        x, dy = (mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype)
        w = mk(cols).to(dtype)
        got = tln.layer_norm_bwd(dy, x, w, 1e-5)
        torch.cuda.synchronize()
        want = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
        errs[dtype] = max(
            check_close(f"K2 layer_norm_bwd {n} [{rows}, {cols}] {dtype}",
                        a, b)
            for n, a, b in zip(("dx", "dw", "db"), got, want))
    ms = time_ms(lambda: tln.layer_norm_bwd(dy, x, w, 1e-5))
    plain_ms = time_ms(lambda: tln.layer_norm_bwd_reference(dy, x, w, 1e-5))
    b = torch.zeros_like(w)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [cols], w, b, 1e-5)
    lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [cols], mean, rstd, w, b, [True, True, True]))
    item = x.element_size()
    # dy, x in and dx out once, w in and dw, db out once
    n_bytes = 3 * rows * cols * item + 3 * cols * item
    bound_ms, bound_by = bound(n_bytes, 16 * rows * cols, F32_FLOPS)
    log(f"  K2 bf16 [{rows}, {cols}]: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, native_layer_norm_backward {lib_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return dict(name="K2 layer_norm_bwd", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                replaces="paddle_tpu/ops/pallas/layer_norm.py:68",
                path="training", max_abs_err=errs[torch.bfloat16], ms=ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def check_flash_attention(dev, tfa, time_ms):
    """K3, K4 and K5 at the training step's shapes, causal: each against
    its plain version in f32 and bf16, then timed in bf16."""
    b, l = TRAIN["batch"], TRAIN["seq"]
    h = GPT124M["num_attention_heads"]
    d = GPT124M["hidden_size"] // h
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, l, h, d, generator=g, device=dev
                                   ).to(dtype) for _ in range(4))
        tag = f"[{b}, {l}, {h}, {d}] causal {dtype}"
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=True)
        e3 = check_close(f"K3 flash fwd o {tag}", o, o_ref)
        check_close(f"K3 flash fwd lse {tag}", lse, lse_ref)
        del o_ref, lse_ref
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).reshape(
            b * h, l).contiguous()
        args = (q, k, v, lse, di, do)
        dq = tfa.flash_attention_dq(*args, causal=True)
        torch.cuda.synchronize()
        e4 = check_close(f"K4 flash dq {tag}", dq,
                         tfa.flash_dq_reference(*args, causal=True))
        dk, dv = tfa.flash_attention_dkv(*args, causal=True)
        torch.cuda.synchronize()
        dk_ref, dv_ref = tfa.flash_dkv_reference(*args, causal=True)
        e5 = max(check_close(f"K5 flash dk {tag}", dk, dk_ref),
                 check_close(f"K5 flash dv {tag}", dv, dv_ref))
        del dk_ref, dv_ref
        errs[dtype] = (e3, e4, e5)
        torch.cuda.empty_cache()
    # timing in bf16; the library yardstick is SDPA on [B, H, L, D]
    fwd = lambda: tfa.flash_attention_fwd(q, k, v, causal=True)
    dq_k = lambda: tfa.flash_attention_dq(*args, causal=True)
    dkv_k = lambda: tfa.flash_attention_dkv(*args, causal=True)
    ms = [time_ms(f, iters=5) for f in (fwd, dq_k, dkv_k)]
    plain_ms = [time_ms(f, iters=3) for f in (
        lambda: tfa.flash_attention_reference(q, k, v, causal=True),
        lambda: tfa.flash_dq_reference(*args, causal=True),
        lambda: tfa.flash_dkv_reference(*args, causal=True))]
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=5)
    qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
    out = sdpa(qt, kt, vt, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=5)
    item = q.element_size()
    act = b * l * h * d * item                    # one [B, L, H, D] tensor
    rows = b * h * l * 4                          # one f32 [BH, L] vector
    pairs = b * h * l * (l + 1) // 2              # causal (query, key) pairs
    bounds = [bound(4 * act + rows, 4 * d * pairs, BF16_FLOPS),
              bound(5 * act + 2 * rows, 6 * d * pairs, BF16_FLOPS),
              bound(6 * act + 2 * rows, 8 * d * pairs, BF16_FLOPS)]
    names = ("K3 flash_attention_fwd", "K4 flash_attention_dq",
             "K5 flash_attention_dkv")
    lines = (495, 570, 605)
    lib = (lib_fwd, lib_bwd, lib_bwd)
    recs = []
    for i, name in enumerate(names):
        bound_ms, bound_by = bounds[i]
        log(f"  {name.split()[0]} bf16 [{b}, {l}, {h}, {d}] causal: kernel "
            f"{ms[i]:.4f} ms, plain {plain_ms[i]:.4f} ms, "
            f"{'SDPA' if i == 0 else 'SDPA backward (dq, dk, dv)'} "
            f"{lib[i]:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        recs.append(dict(
            name=name, route="cuda", path="training",
            source="paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{lines[i]}",
            max_abs_err=errs[torch.bfloat16][i], ms=ms[i],
            plain_ms=plain_ms[i], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib[i],
            library_call=("F.scaled_dot_product_attention(is_causal=True)"
                          if i == 0 else "its backward: dq, dk, dv")))
    return recs


def ragged_batch(dev, dtype, h, hkv, seed):
    """A serving-step-shaped mixed batch: q [16, 32, h, 64], pools of
    993 pages of 16, page tables in shuffled page order; rows idle
    (q_len 0), decoding (1), partial and full-chunk prefill, with pos
    near 0, at page ends and deep in the window."""
    rs = np.random.RandomState(seed)
    b, lq, d = ENGINE["num_slots"], ENGINE["chunk_len"], 64
    ps = ENGINE["page_size"]
    mp = -(-ENGINE["max_len"] // ps)
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    q_len = np.array([0, 1, 1, 1, 1, 1, 1, 1, 1, 5, 17, 32, 32, 32, 0, 1],
                     np.int32)
    pos = np.array([0, 0, 15, 16, 31, 300, 640, 900, 959, 0, 15, 0, 256,
                    700, 0, 47], np.int32)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        dev, dtype)
    return (mk(b, lq, h, d), mk(n_pages, ps, hkv, d), mk(n_pages, ps, hkv, d),
            *(torch.from_numpy(a).to(dev) for a in (table, pos, q_len)))


def check_paged_attention(dev, tpa, time_ms):
    errs = {}
    for dtype, (h, hkv) in ((torch.float32, (12, 12)),
                            (torch.bfloat16, (12, 6)),
                            (torch.bfloat16, (12, 12))):
        args = ragged_batch(dev, dtype, h, hkv, SEED)
        out = tpa.ragged_paged_attention(*args)
        torch.cuda.synchronize()
        ref = tpa.ragged_attention_reference(*args)
        q_len = args[5]
        live = (torch.arange(out.shape[1], device=dev)[None, :]
                < q_len[:, None])
        if not torch.isfinite(out.float()).all():
            raise AssertionError("K6 wrote a non-finite dead query")
        errs[dtype] = check_close(
            f"K6 ragged_paged_attention H={h} H_kv={hkv} {dtype}", out, ref,
            mask=live)
    q, k, v, table, pos, q_len = args            # bf16, GPT-124M heads
    ms = time_ms(lambda: tpa.ragged_paged_attention(*args))
    plain_ms = time_ms(lambda: tpa.ragged_attention_reference(*args))
    # library yardstick: SDPA over the gathered dense view, ragged mask
    b, lq, h, d = q.shape
    ps, mp = k.shape[1], table.shape[1]
    kd = k[table.long()].reshape(b, mp * ps, h, d).transpose(1, 2)
    vd = v[table.long()].reshape(b, mp * ps, h, d).transpose(1, 2)
    qd = q.transpose(1, 2)
    i = torch.arange(lq, device=dev)[:, None]
    j = torch.arange(mp * ps, device=dev)[None, :]
    mask = (j <= pos[:, None, None] + i)[:, None]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    # what this batch needs: live queries, every row's live K/V pages
    ql, ps_ = q_len.cpu().numpy(), pos.cpu().numpy()
    item = q.element_size()
    pages = sum(min(mp, (int(p) + int(n) - 1) // ps + 1)
                for p, n in zip(ps_, ql) if n > 0)
    n_bytes = (2 * int(ql.sum()) * h * d * item        # q in, out
               + 2 * pages * ps * k.shape[2] * d * item
               + table.numel() * 4 + 2 * b * 4)
    keys = sum(int(p) * int(n) + int(n) * (int(n) + 1) // 2
               for p, n in zip(ps_, ql))
    bound_ms, bound_by = bound(n_bytes, 4 * keys * h * d, BF16_FLOPS)
    log(f"  K6 bf16 [16, 32, 12, 64]: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA (gathered, masked) {lib_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return dict(name="K6 ragged_paged_attention", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/"
                       "ragged_paged_attention.cu",
                replaces="paddle_tpu/ops/pallas/paged_attention.py:375",
                path="serving", max_abs_err=errs[torch.bfloat16], ms=ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


# -- phase 3: serve GPT-124M -------------------------------------------------
def make_traffic():
    """24 prompts of 32-700 tokens. A third of them — the first and the
    last seven — are one shared 256-token system prompt, a shared 4-token
    separator, then their own text. The first has the shortest prompt of
    the first 16 admitted (the others have 300-700), so it finishes first
    and the last seven, still queued, attach its cached prompt pages and
    copy-on-write the page holding the separator."""
    rs = np.random.RandomState(SEED)
    vocab = GPT124M["vocab_size"]
    system = rs.randint(0, vocab, size=SHARED_PREFIX)
    sep = rs.randint(0, vocab, size=4)
    n_shared = N_REQUESTS // 3
    prompts = []
    for n in range(N_REQUESTS):
        if n == 0 or n > N_REQUESTS - n_shared:
            tail = rs.randint(0, vocab, size=8 if n == 0
                              else int(rs.randint(8, 300)))
            prompts.append(np.concatenate([system, sep, tail]))
        else:
            lo, hi = (300, 701) if n < ENGINE["num_slots"] else (32, 101)
            prompts.append(rs.randint(0, vocab, size=int(rs.randint(lo, hi))))
    return [p.astype(np.int64) for p in prompts]


def serve(dev, tln, tpa):
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                          unified_forward)

    class RecordingEngine(ServingEngine):
        """Keeps the inputs and held logits of step RECORD_STEP."""
        recorded = None

        def _forward(self, *args):
            if self.metrics.unified_steps != RECORD_STEP:
                return super()._forward(*args)
            snap = lambda t: t.to("cpu", copy=True)
            before = ([snap(a) for a in args],
                      [(snap(k), snap(v)) for k, v in self._pools],
                      snap(self._last_logits))
            out = super()._forward(*args)
            self.recorded = before + (out.cpu(),)
            return out

    model = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                           dtype=torch.bfloat16, seed=SEED).eval()
    eng = RecordingEngine(model, device=dev, seed=SEED, **ENGINE)
    prompts = make_traffic()
    t0 = time.perf_counter()
    tln.reset_launches()
    tpa.reset_launches()
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS))
            for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": tln.LAUNCHES, "K6": tpa.LAUNCHES}
    steps = eng.metrics.unified_steps
    snap = eng.metrics.snapshot()
    log(f"  served {len(reqs)} requests in {steps} steps, {wall:.3f} s: "
        f"{snap['tokens_generated']} tokens, {snap['tokens_per_s']:.1f} "
        f"tokens/s; step p50 {snap['step_s']['p50'] * 1e3:.3f} ms, p90 "
        f"{snap['step_s']['p90'] * 1e3:.3f} ms; TTFT p50 "
        f"{snap['ttft_s']['p50'] * 1e3:.1f} ms, p90 "
        f"{snap['ttft_s']['p90'] * 1e3:.1f} ms")
    pc = eng.prefix_cache.stats()
    log(f"  prefix cache: {pc['hits']} hits of {pc['lookups']}, "
        f"{pc['cached_tokens']} cached tokens, {pc['cow_copies']} COW copies")
    n_layers = GPT124M["num_hidden_layers"]
    want = {"K1": (2 * n_layers + 1) * steps, "K6": n_layers * steps}
    log(f"  launches: K1 {launches['K1']} ({2 * n_layers + 1} x {steps}), "
        f"K6 {launches['K6']} ({n_layers} x {steps})")
    if any(r.finish_reason != "length" or len(r.output_tokens) != NEW_TOKENS
           for r in reqs):
        raise AssertionError("a request did not finish with its 64 tokens")
    if any(not 0 <= t < GPT124M["vocab_size"]
           for r in reqs for t in r.output_tokens):
        raise AssertionError("a token id outside the vocabulary")
    if launches != want or steps == 0:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if pc["hits"] < 1 or pc["cow_copies"] < 1:
        raise AssertionError("the traffic did not exercise attach and COW")
    eng.pool.assert_quiesced()

    # rerun the recorded step through the plain versions (CPU, f32)
    if eng.recorded is None:
        raise AssertionError(f"step {RECORD_STEP} never ran")
    (toks, pos, table, q_len, is_decode), pools, last, held = eng.recorded
    plain_model = copy.deepcopy(model).float().cpu()
    pools = [(k.float(), v.float()) for k, v in pools]
    with torch.no_grad():
        plain = unified_forward(plain_model, pools, toks, pos, table, q_len,
                                is_decode, last)
    live = q_len > 0
    err = (held[live] - plain[live]).abs().max().item()
    agree = (held[live].argmax(-1) == plain[live].argmax(-1)).float().mean()
    log(f"  step {RECORD_STEP} ({int(q_len.sum())} tokens, "
        f"{int(live.sum())} live rows): held logits vs plain f32 rerun "
        f"max_abs_err={err:.4f} (tolerance {HELD_LOGITS_TOL}), argmax "
        f"agreement {agree.item():.3f}")
    if not torch.isfinite(held).all() or err > HELD_LOGITS_TOL:
        raise AssertionError("held logits disagree with the plain rerun")
    return launches, {"tokens_per_s": snap["tokens_per_s"],
                      "step_ms_p50": snap["step_s"]["p50"] * 1e3,
                      "ttft_ms_p50": snap["ttft_s"]["p50"] * 1e3,
                      "steps": steps, "wall_s": wall,
                      "profile": profile_steps(eng, prompts[:16])}


def profile_steps(eng, prompts) -> dict:
    """Where a serving step's time goes: run `prompts` (16 new tokens
    each) under torch.profiler and report the device's busy share of the
    wall time and the kernels that took the most device time. Profiling
    slows the host, so these numbers are not the tokens/s above."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import SamplingParams
    steps0 = eng.metrics.unified_steps
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=16))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.pool.assert_quiesced()
    return dict(steps=eng.metrics.unified_steps - steps0,
                **device_busy(prof, wall_us))


def device_busy(prof, wall_us: float) -> dict:
    """The device's busy time and share of `wall_us` in a profile, and
    the kernels that took the most device time. Device-side events,
    less the GPU mirrors of the engine's own record_function ranges
    (serving::...), which are spans, not work."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("serving::")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us if busy_us else None,
           "top_kernels": [[e.key[:70], e.count,
                            e.self_device_time_total / 1e3] for e in top]}
    log(f"  profiled: device busy {out['device_busy_ms']:.2f} of "
        f"{out['wall_ms']:.2f} ms wall")
    for name, count, ms in out["top_kernels"]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {name}")
    return out


# -- phase 4: train GPT-124M -------------------------------------------------
def launch_counts(tln, tfa) -> dict:
    return {"K1": tln.LAUNCHES, "K2": tln.BWD_LAUNCHES,
            "K3": tfa.LAUNCHES["fwd"], "K4": tfa.LAUNCHES["dq"],
            "K5": tfa.LAUNCHES["dkv"]}


def reset_counts(tln, tfa, tpa):
    tln.reset_launches()
    tfa.reset_launches()
    tpa.reset_launches()


def train(dev, tln, tfa, tpa):
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**GPT124M, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    opt = optimizer.AdamW(learning_rate=TRAIN["lr"],
                          parameters=model.named_parameters(),
                          weight_decay=TRAIN["weight_decay"])
    step = jit.compile_train_step(
        lambda ids, labels: model(ids, labels=labels), model, opt)
    rs = np.random.RandomState(0)
    shape = (TRAIN["batch"], TRAIN["seq"])
    ids, labels = (torch.from_numpy(rs.randint(0, cfg.vocab_size, shape)
                                    ).to(dev) for _ in range(2))
    t0 = time.perf_counter()
    first = [step(ids, labels).item() for _ in range(TRAIN["warmup"])]
    log(f"  warm-up: losses {first}, {time.perf_counter() - t0:.2f} s")
    lnv = math.log(cfg.vocab_size)
    if not all(map(math.isfinite, first)) or abs(first[0] - lnv) > 0.5:
        raise AssertionError(f"first loss {first[0]} is not near ln V = "
                             f"{lnv:.3f}")
    torch.cuda.synchronize()
    reset_counts(tln, tfa, tpa)
    t0 = time.perf_counter()
    for _ in range(TRAIN["steps"]):
        loss = step(ids, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(tln, tfa)
    final = loss.item()
    n_layers = cfg.num_hidden_layers
    per_step = {"K1": 2 * n_layers + 1, "K2": 2 * n_layers + 1,
                "K3": n_layers, "K4": n_layers, "K5": n_layers}
    want = {k: n * TRAIN["steps"] for k, n in per_step.items()}
    log(f"  launches over {TRAIN['steps']} steps: {launches} "
        f"(per step {per_step})")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if not math.isfinite(final):
        raise AssertionError(f"loss {final} is not finite")
    tokens = TRAIN["batch"] * TRAIN["seq"] * TRAIN["steps"]
    n_params = sum(p.numel() for p in model.parameters())
    flops_per_token = 6 * n_params + 12 * n_layers * cfg.hidden_size * \
        TRAIN["seq"]
    tok_s = tokens / wall
    mfu = tok_s * flops_per_token / BF16_FLOPS
    log(f"  trained {TRAIN['steps']} steps of [{TRAIN['batch']}, "
        f"{TRAIN['seq']}] in {wall:.3f} s: {wall / TRAIN['steps'] * 1e3:.2f}"
        f" ms/step, {tok_s:.1f} tokens/s, MFU {mfu:.4f} (bench.py's "
        f"formula, {n_params / 1e6:.1f}M params, vs 989 TFLOP/s); loss "
        f"{first[0]:.4f} -> {final:.4f}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    busy = device_busy(prof, prof_us)
    state = {k: v.float() for k, v in model.state_dict().items()}
    del model, opt, step, loss
    torch.cuda.empty_cache()
    held = held_step(dev, cfg, state, ids[:TRAIN["held_batch"]],
                     labels[:TRAIN["held_batch"]], tln, tfa)
    return launches, {"tokens_per_s": tok_s, "step_ms": wall * 1e3 /
                      TRAIN["steps"], "mfu": mfu, "n_params": n_params,
                      "loss_first": first[0], "loss_last": final,
                      "profile": busy, "held": held}


class plain_path:
    """Within it, the model's LayerNorm and attention run through the
    plain versions on the card, differentiated by torch's autograd, and
    no kernel launches: the reference of the held step."""

    def __enter__(self):
        from paddle_tpu_torch.nn.functional import attention, norm
        from paddle_tpu_torch.ops.cuda import flash_attention as tfa
        from paddle_tpu_torch.ops.cuda import layer_norm as tln

        class PlainLayerNorm:
            apply = staticmethod(tln.layer_norm_reference)

        self.saved = [(norm, "LayerNormFunction", norm.LayerNormFunction),
                      (attention, "flash_attention_blhd",
                       attention.flash_attention_blhd)]
        norm.LayerNormFunction = PlainLayerNorm
        attention.flash_attention_blhd = \
            lambda *a, **kw: tfa.flash_attention_reference(*a, **kw)[0]
        return self

    def __exit__(self, *exc):
        for mod, name, value in self.saved:
            setattr(mod, name, value)
        return False


def held_step(dev, cfg, state, ids, labels, tln, tfa) -> dict:
    """Loss and gradients of one [2, 1024] step in f32, through the
    kernels and through the plain versions, on the card; and the bf16
    kernel loss against the f32 plain loss."""
    from paddle_tpu_torch.nlp import GPTForCausalLM

    def loss_and_grads(model):
        loss = model(ids, labels=labels)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=SEED)
    model.load_state_dict(state)
    loss_k, grads_k = loss_and_grads(model)
    before = launch_counts(tln, tfa)
    with plain_path():
        loss_p, grads_p = loss_and_grads(model)
    if launch_counts(tln, tfa) != before:
        raise AssertionError("the plain path launched a kernel")
    worst = max(((grads_k[n] - g).abs().max().item() /
                 max(g.abs().max().item(), 1e-30), n)
                for n, g in grads_p.items())
    with torch.no_grad():
        loss_b = model.to(torch.bfloat16)(ids, labels=labels).item()
    out = {"loss_kernel_f32": loss_k, "loss_plain_f32": loss_p,
           "loss_kernel_bf16": loss_b, "grad_worst_rel": worst[0],
           "grad_worst_param": worst[1]}
    log(f"  held step [{ids.shape[0]}, {ids.shape[1]}]: f32 loss kernel "
        f"{loss_k:.6f} vs plain {loss_p:.6f} (rtol {HELD_LOSS_RTOL}); "
        f"worst gradient error {worst[0]:.3e} of its max in {worst[1]} "
        f"(tolerance {HELD_GRAD_TOL}); bf16 kernel loss {loss_b:.4f} vs "
        f"f32 plain (tolerance {HELD_BF16_LOSS_TOL})")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <=
            HELD_LOSS_RTOL * abs(loss_p)):
        raise AssertionError("held f32 loss: kernel path != plain path")
    if not worst[0] <= HELD_GRAD_TOL:
        raise AssertionError(f"held gradient of {worst[1]} disagrees")
    if not abs(loss_b - loss_p) <= HELD_BF16_LOSS_TOL:
        raise AssertionError("held bf16 loss disagrees with the f32 plain")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.ops.cuda import layer_norm as tln
    from paddle_tpu_torch.ops.cuda import paged_attention as tpa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(build_logs)}; card: {smi}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 2 kernels vs plain versions:")
    timer = DeviceTimer()
    kernels = {"K1": check_layer_norm(dev, tln, timer),
               "K2": check_layer_norm_bwd(dev, tln, timer)}
    kernels.update(zip(("K3", "K4", "K5"),
                       check_flash_attention(dev, tfa, timer)))
    kernels["K6"] = check_paged_attention(dev, tpa, timer)
    torch.cuda.empty_cache()

    log("phase 3 serve GPT-124M (bf16, random weights):")
    served, serving = serve(dev, tln, tpa)
    log(f"  serving: {json.dumps(serving)}")
    torch.cuda.empty_cache()

    log("phase 4 train GPT-124M (bf16, random weights, bench.py's step):")
    trained, training = train(dev, tln, tfa, tpa)
    log(f"  training: {json.dumps(training)}")
    # each kernel's launches on each path, counted from 0 just before the
    # path ran; `launches` is those of the path whose shapes the record
    # was measured at
    for name, rec in kernels.items():
        rec["launches_by_path"] = {"serving": served.get(name, 0),
                                   "training": trained.get(name, 0)}
        rec["launches"] = rec["launches_by_path"][rec["path"]]

    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
