#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (or any
sm_90a card), CUDA's `nvcc` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. build every kernel of the serving path from `paddle_tpu_torch/ops/
   cuda/csrc/` (one nvcc per source, all at once) and print the build
   time and the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at
   the shapes the serving step gives it, and time the kernel, the plain
   version and one PyTorch library call computing the same function;
3. serve GPT-124M at full width (bench.py's configuration: vocab 50304,
   hidden 768, 12 layers, 12 heads, 1024 positions) in bf16 with random
   weights from a seed: 24 requests of 32-700 prompt tokens, a third of
   them behind one shared 256-token system prompt, 64 greedy tokens
   each. Checks that every request finishes, that the step launched K6
   12 and K1 25 times per step, and that the held logits of one
   recorded step match a rerun of that step through the plain versions
   (on the CPU, in f32). Prints tokens/s, the step time and the TTFT.

The second-to-last line is a JSON object with one record per kernel;
the last line is `{"ok": true, "device": {...}}`. Without CUDA the
script prints no result and exits 1.
"""
from __future__ import annotations

import copy
import json
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
# kernel vs plain version on the card (bf16: the output's rounding;
# f32: summation order)
TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
# held logits, bf16 path on the card vs the f32 plain rerun on the CPU:
# bf16 activations through 12 layers against f32 (logits have std ~0.5;
# the first H100 run measured 0.026)
HELD_LOGITS_TOL = 0.1


def log(msg: str):
    print(msg, flush=True)


class DeviceTimer:
    """Device time per call of a function, in ms. After a warm-up the
    calls are enqueued behind a GPU sleep that outlasts their host-side
    launch cost, so two CUDA events bracket back-to-back device work
    only. Inputs stay in L2 where they fit, as in the serving step, where
    the producer of each input has just written it."""

    def __init__(self, sleep_ms: float = 50.0):
        cycles = 10 ** 7
        for _ in range(2):             # size the sleep to ~sleep_ms
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


def check_close(name, got, want, tol, mask=None):
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= tol * (
        1.0 + want.abs().max().item())
    log(f"  {name}: max_abs_err={err:.3e} (tolerance {tol} x (1 + max|ref|))"
        f" {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# -- phase 2: kernels against their plain versions ------------------------
def check_layer_norm(dev, tln, time_ms):
    rows, cols = ENGINE["num_slots"] * ENGINE["chunk_len"], 768
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(rows, cols, generator=g, device=dev) * 2 + 1
             ).to(dtype)
        w = torch.randn(cols, generator=g, device=dev).to(dtype)
        b = torch.randn(cols, generator=g, device=dev).to(dtype)
        y = tln.layer_norm(x, w, b, 1e-5)
        torch.cuda.synchronize()
        errs[dtype] = check_close(f"K1 layer_norm [{rows}, {cols}] {dtype}",
                                  y, tln.layer_norm_reference(x, w, b, 1e-5),
                                  TOL[dtype])
    ms = time_ms(lambda: tln.layer_norm(x, w, b, 1e-5))
    plain_ms = time_ms(lambda: tln.layer_norm_reference(x, w, b, 1e-5))
    lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
        x, (cols,), w, b, 1e-5))
    n_bytes = 2 * rows * cols * x.element_size() + 2 * cols * w.element_size()
    bound_ms, bound_by = bound(n_bytes, 8 * rows * cols, F32_FLOPS)
    log(f"  K1 bf16 [{rows}, {cols}]: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return dict(name="K1 layer_norm_fwd", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                replaces="paddle_tpu/ops/pallas/layer_norm.py:60",
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


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
            TOL[dtype], mask=live)
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
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
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
    # device-side events, less the GPU mirrors of the engine's own
    # record_function ranges (serving::...), which are spans, not work
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("serving::")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"steps": eng.metrics.unified_steps - steps0,
           "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us if busy_us else None,
           "top_kernels": [[e.key[:70], e.count,
                            e.self_device_time_total / 1e3] for e in top]}
    log(f"  profiled {out['steps']} steps: device busy "
        f"{out['device_busy_ms']:.2f} of {out['wall_ms']:.2f} ms wall")
    for name, count, ms in out["top_kernels"]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {name}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.cuda import _build
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
    kernels = [check_layer_norm(dev, tln, timer),
               check_paged_attention(dev, tpa, timer)]

    log("phase 3 serve GPT-124M (bf16, random weights):")
    launches, serving = serve(dev, tln, tpa)
    kernels[0]["launches"] = launches["K1"]
    kernels[1]["launches"] = launches["K6"]
    log(f"  serving: {json.dumps(serving)}")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
