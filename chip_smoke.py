#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (or any
sm_90a card), CUDA's `nvcc` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. build every kernel library from `paddle_tpu_torch/ops/cuda/csrc/`
   (layer_norm.cu: K1, K2; ragged_paged_attention.cu: K6 and its fp8
   lane, K7, each with its user-mask lane; grouped_paged_attention.cu:
   K10a, K10b in the fp, fp8 and q8 lanes; paged_scatter.cu: K8 in its
   float and fp8 lanes, K8-q8; paged_decode_attention.cu: K9 and its fp8
   lane; flash_attention.cu: K3, K4, K5 at head dims 64, 128 and 256;
   lora_paged.cu: K11; greedy_argmax.cu: K12; one nvcc per source, all
   at once) and print the build time, the card's name and power limit,
   each library's register and spill report, each tensor-core flash
   kernel's registers and spill stores, every K1 and K2 instantiation's
   (into their records: the count, the most registers, the spilling
   ones), and those of the walk (K6/K7,
   K9 and K10 are one kernel, `ring_walk_kernel`, built into each of
   their libraries) and K11 (the serving step's bf16 head-dim-64
   instantiation of each K10 phase and of K6 and K9 without and with a
   mask, K11 in each dtype, and the largest register count and the
   spilling ones among all; K6's, K9's and K11's go into their records);
2. hold each kernel against its plain PyTorch version on the card, at
   the shapes each path gives it, in bf16 and f32 — K1 at the serving,
   the legacy decode and the training step's (20 reruns bit for bit,
   its launch recorded), K6, K7 and K10 at the serving step's, K2-K5 at
   the training step's; f32 outputs to 1e-5 x (1 + max|ref|), bf16 outputs
   element by element to 2 ulps — and time the kernel, the plain version
   and one PyTorch library call computing the same function
   (`F.layer_norm`, `native_layer_norm_backward`, SDPA and its
   backward), beside the bound from `bound()`. The attention walks run
   in each pool lane: fp; fp8 (e4m3 pools: K6's fp8 lane, K10's); q8
   (int8 pools with f32 scales: K7, K10's q8 lane), on the same pools
   in the kernel and in the plain version. K10 runs on batches built
   like phase 3's grouped steps (16 rows, seven sharing 16 pages, in
   f32, bf16 and f16; and again at rep 4, D 128 and at Llama-7B's 32
   heads of 128, rep 1): its phase-1 partials
   against the plain partials, its output against the plain output, and
   its output against K6's (K7's) in the same lane on the same operands,
   bit for bit, and 20 reruns of both phases bit for bit; K10a, K10b and
   K6 are timed on the same operands and K10's launch (`grouped_plan`:
   feeder, shared memory, grid) recorded. F10: K6, K7 and K10 again at
   rep 32 / head dim 128 and 71 heads of 64 over one kv head (16 rows of
   up to 32 queries: an item's rows split over blocks, `split` in the
   plans), K10 = K6 (K7) bit for bit, against the plain versions, timed;
   K9 there and at rep 128 / head dim 256 equal to K6 at q_len 1. K2 at
   [16384, 768] in bf16, f32 and f16 and at [512, 768] in bf16, 20
   reruns bit for bit, each timed beside its bound. F11: K1 and K2 at
   GPT-3's widths (2560 and 4096 in f32, 5120 in bf16 at 64 rows and at
   phase 7's 2048: the wide lanes) and at 65536 columns, and with f32
   weights under bf16 activations, against their plain versions, dx, dw
   and db 20 reruns bit for bit, timed beside their bounds, their plain
   versions and the library's calls; the functional LayerNorm at width 100 in
   bf16 launches nothing and equals the port of the JAX jnp branch on
   the CPU. K8 and K8-q8
   write the serving step's [16, 32, 12, 64] K rows, and Llama-7B's
   [16, 32, 32, 128] (and each again at 300x
   the scale, past +-448) and must equal their plain versions bit for
   bit outside the trash page; both write K and V in one launch too, in
   every lane (equal to two single launches; K8-q8's pair over 20
   reruns), K8's pair timed beside two `index_copy_` calls, K8-q8's
   beside its bound. K9 runs in its fp and fp8 lanes on the
   legacy decode step's batch (16 rows, q [16, 1, 12, 64], pools
   [993, 16, 12, 64], pos over 65-763; again at rep 4, D 128 and at
   Llama-7B's 32 heads of 128) without a
   mask, with a random additive mask and with a bool mask that hides
   all but key 0, against its plain version, and without a mask against
   K6 at q_len 1 bit for bit; it is timed without and with the mask
   beside its plain version and SDPA over the gathered, masked view.
   K3 runs at every shape the serving paths give it: the legacy prefill
   chunks (Lq 8, 16, 32 over 992 keys, the window mask as its bias),
   the gather arm's step (q [16, 32, 12, 64], a per-row bias) and
   generate()'s prefill and decode step (the window as a kvec at Lq 1),
   and the legacy and generate() cases again at Llama-7B's 32 heads of
   128, against `_sdpa_ref` (f32) and its plain version (bf16, f16).
   K3-K5 again
   at head dim 256 ([2, 1024, 4, 256], phase 6's step) and at one row
   of phase 9's Llama step ([1, 2048, 32, 128], timed beside SDPA and
   bound; `llama_training` in their records). K3-K5 run in
   f32, bf16 and f16: in bf16 and f16 all three take the tensor-core
   design at every head dim (wgmma on TMA-fed tiles, K5 at head dim 256
   in its split lane; `tfa.kernel_design`, printed and recorded as
   `design`), held with one rounding of each P_eff and dS to the operand
   dtype carried through the second product on top of the ulp rule, and
   20 repeats of each in bf16 must be bit-identical (K3 at every serving
   shape too); f32 stays on the CUDA cores. The backward's sum (K4 + K5
   + the di row sum, a torch op) is timed beside SDPA's whole backward
   (`backward_sum` in K4's record). The user-mask
   lane of K6 and K7 on the ragged serving batches (rep 1 and 2, an
   additive and a bool mask) against the plain versions, timed with
   the mask's bytes in the bound. K11 at the serving step's LoRA shapes
   (x [16, 32, 768], 9 adapter pages of rank 8) in f32, bf16 and f16 (the
   16-bit rule allows one ulp of t carried through B), base-page rows
   exactly 0, 20 repeats bit-identical, and again at ranks 32 and 64
   (t summed a group of ranks at a time, d over R in k-steps of 16),
   timed beside two `torch.bmm`, and at phase 8's shapes (x [16, 32, 4096]
   into 4096 and 1024 columns, rank 8); its launch (`lora_plan`), K6's
   (`ragged_plan`) and K9's (`decode_plan`: the feeder) recorded; K12 (a
   row split over a cluster of up to 8 blocks) on f32 logits at [16|1|128,
   50304], [16, 50257], [16, 128256] and phase 10's verify logits [512,
   50304] and [512, 32000], and on a view whose rows start off
   a 16-byte boundary, with ties (one across a cluster slice border), NaNs
   in two slices, +-0, an all -inf row and an all-equal row, equal to
   torch.argmax bit for bit over 20 repeats and timed at each shape beside
   an empty launch; K8's float lane equal to index_copy_ bit for bit
   outside page 0;
3. serve GPT-124M at full width (bench.py's configuration: vocab 50304,
   hidden 768, 12 layers, 12 heads, 1024 positions) in bf16 with random
   weights from a seed: 24 requests of 32-700 prompt tokens, a third of
   them behind one shared 256-token system prompt, 64 greedy tokens
   each, four times — with the engine's defaults (grouped walk,
   preemption, host tier), with grouped=False, with grouped=False and
   with the defaults. Checks that every request finishes, that a step
   launched K1 25 times and K10a and K10b 12 times each (K6 not at all)
   with the defaults and K6 12 times with grouped=False, that groups of
   two or more rows formed, that the four runs' tokens are identical,
   and that the held logits of one recorded step of the first run match
   a rerun of that step through the plain versions (on the CPU, in
   f32). Prints tokens/s, the step time, the TTFT, the modeled page
   reads and the reads the grouped walk saved, and a profile of each
   arm (16 more requests on the warm engine, half of them behind the
   shared prompt). A fifth run takes the defaults with pages of 256
   keys (every walk folds a page in two pieces of 128): launches per
   step, a recorded step's held logits against a plain f32 rerun, the
   share of tokens equal to the page-16 run's printed. A sixth run
   takes the defaults at `token_budget=64`: every request finishes, no
   step packs more than 64 tokens, launches per step as the defaults',
   `debug_state()` read after 5 steps (residents and the budget in its
   config), and `prometheus_render` of its snapshot printed by its line
   count with the `engine_info` series (its `kv_dtype` label); then
   `abort_all()` on an engine loaded with the same traffic, stepped until
   a resident has emitted a token: every request retires "aborted"
   without another step, keeping its tokens, and the pool and the host
   tier end quiesced. Then the same
   traffic over int8 and fp8 KV pools,
   each with the defaults and with grouped=False: per step K1 25, the
   lane's write (K8-q8 or K8 12: K and V in one launch) and K10a,
   K10b 12 each (K7 or K6's fp8
   lane 12 with grouped=False); identical tokens in both arms of a
   dtype; a recorded step of each defaults run held against a plain f32
   rerun over the same quantized pools; a page costing exactly 68/128
   (int8) and 64/128 (fp8) of a bf16 page. Printed, not checked: the
   share of tokens equal to the bf16 run's, tokens/s and the device's
   busy share. Then two preemption runs, bf16 and int8: 16 slots over a
   pool of 16 x 40 + 1
   pages filled with priority-5 requests; once they decode, a priority-0
   burst that only preemption admits. Checks that requests were
   preempted and swapped to the host tier, that every request's tokens
   equal those of a run that never preempts, and that the pool is
   quiesced after `drain()`; prints the swap-in time. Then the legacy
   alternating step (`unified=False`) on the same traffic: in bf16
   twice (identical tokens; per decode step K1 25 and K9 12, per
   prefill chunk K1 25 and K3 12, K6 and K10 never; a recorded decode
   step's held logits against a plain f32 rerun over the same pools;
   a profile), over fp8 pools (K8 12 and K9-fp8 12 per decode step) and
   over int8 pools (K8-q8 12 and K7 12); the prefill buckets run stay in
   {32, 16, 8}; and the unified step's gather arm (`attn_impl="gather"`,
   K3 12 per step, no K6/K10; a recorded step's held logits against a
   plain f32 rerun). Printed, not checked: tokens/s, step
   p50/p90, TTFT, the buckets and the share of tokens equal to the
   unified defaults arm's. Then the decode megakernel and adapter arms:
   the megakernel on over bf16 and over int8 pools (tokens identical to
   the gate-off defaults arms'; per step K8's float lane 12 (K and V in
   one launch) or K8-q8 12, and K12 1, on top
   of the walk), the LORA adapters (4 of rank 4, tenants zipf over
   {base, 1..4}) with the megakernel off and on (a recorded step's held
   logits against a plain f32 rerun; K11 48 a step with the gate on),
   with 2 adapter pages (the pool must spill or evict and reload), in
   rank buckets (8, 32) with the megakernel on (a pool of rank 32, K11
   past one k-step of 16; a recorded step held against a plain rerun),
   and over int8 pools; exact launches per step in every arm. Each
   profile totals the walk's and K11's device time beside the device's
   busy time;
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
   profiled step;
5. `GPTForCausalLM.generate` on GPT-124M bf16 (a fresh model from the
   same seed): batch 8 x prompt 128, 32 new tokens, greedy twice and a
   seeded top-k 50 sampling run twice (each pair identical), beam search
   (4 beams) and the dense int8 cache, K1 25 and K3 12 launches per
   forward (the int8 run's K3 only in its calibration prefill and its
   prefill), beam search's tie order on the card against the CPU's, and
   the prefill's and the first decode step's logits against a plain f32
   rerun on the CPU (0.1). Prints tokens/s;
6. 2-layer GPTs (bf16) at head dim 256 (K3-K5 on the tensor cores) and at
   head dim 32 (the plain `_sdpa_ref` route, as the JAX package takes
   it): the legacy step and the gather arm serve 8 prompts, generate()
   decodes, one train step runs; the route is checked by the launches
   and the prefill logits against a plain f32 rerun (0.1);
7. one decoder layer at GPT-3 13B's width (hidden 5120, 40 heads of 128;
   bf16, cut in depth only): two train steps on [2, 1024] (K1 and K2 3
   each a step, in their wide lanes; K3-K5 once), then the held step on
   [1, 1024] in f32, kernel path against plain path;
8. Llama-7B (`LlamaConfig()`'s defaults, bf16, random weights from the
   seed, 32 layers of 32 heads of 128; its arms, its `generate()` and
   phases 10 and 11 run on a weight copy of its first 8 layers, a cut
   for time) serves phase 3's traffic in six
   arms: the defaults, grouped=False, int8 pools, the legacy step, the
   megakernel on, and the LORA adapters with the megakernel on. The
   defaults, int8, legacy (a decode step) and adapter arms each record
   a step whose held logits are held on the card against a plain f32
   rerun (0.5) and against the bf16 model's plain rerun (mean
   |difference| no farther from it than it lies from the f32 rerun),
   the f32 model through the kernels against the plain f32 rerun
   (0.01), and a planted fault (the plain bf16 rerun with every query's
   window one key short) is read against both and reported; exact
   launches per step (K10a and K10b one each a layer, K1 0; K8-q8 one a
   layer over int8; K8's float lane one a layer and K12 1 with the
   megakernel; K11 four a layer with adapters: Llama's four standalone
   deltas), the tokens of the
   defaults, grouped=False and megakernel arms identical, a profile of
   each arm. Then its `generate()` as phase 5 (greedy twice, beam, the
   int8 cache; K3 one a layer a forward) with the prefill, a decode step
   and the cache-free forward (K3) held as the steps are, against the
   plain f32 and bf16 forwards on the card.
   Then a GQA model at Meta-Llama-3-8B's widths (vocab 128256, 8 kv
   heads: rep 4; 4 of its 32 layers) serves the same traffic with the
   defaults, grouped=False and the megakernel (K12 over 128256 columns),
   tokens identical. Prints tokens/s and the device's busy share of each
   arm;
9. Llama trained at Llama-7B's widths (bf16, random weights from the
   seed, 4 of its 32 layers, 2048 positions, recompute) through
   `jit.compile_train_step` under AdamW with a warm-up/cosine schedule,
   weight decay 0.01 and `ClipGradByGlobalNorm(1.0)`: three steps on
   [2, 2048] (the lr each step reads is the scheduler's; K3 8, K4 4, K5
   4 a step, no K1 or K2; the first loss near ln V + h range^2 / 2), a
   profiled step, the training forward's memory against the same model
   without recompute (arm B: one step, K3-K5 4 each; recompute must
   free at least half of the reckoned saved activations), one
   accumulate_steps=2 step on [4, 2048] (arm C: K3 16, K4 8, K5 8; the
   loss the mean of the micro-batch losses), the held f32 step on
   [1, 2048] (kernel path against plain path, phase 7's rule) with a
   planted fault the rule must catch, and a GQA arm at Llama-3-8B's
   widths (2 layers, one recompute step on [1, 2048]: K3 4, K4 2, K5 2).
   Prints the memory reckoning (weights, gradients, moments, Adam's f32
   gradient copy, master weights), each arm's peak, step time,
   tokens/s, MFU and the device's busy share of the profiled step;
10. speculative serving (`ServingEngine(spec=...)`), `ngram:4` and
   `model:4` (the draft model at half the target's depth): GPT-124M at
   full width, a weight copy of its first 6 layers (a cut for time), on
   phase 3's traffic and on a templated one (16
   requests, a 2-token head and a 24-token block repeated 4 times, 64
   new tokens) in the defaults, int8, megakernel and adapter arms, and
   Llama-7B on phase 8's 8-layer copy (run inside phase 8) at the
   defaults.
   Each spec run against the spec-off run of its arm and traffic: a
   token may differ only where the spec-off run's top-two logit margin
   lies within 0.1 (GPT-124M) or 0.5 (Llama-7B), each such token
   logged; exact launches per target step (the walk and the write per
   layer as in phase 3, K12 twice under the megakernel: the sampling
   argmax and `spec_verify_accept`) and per draft micro-step (K1 2L + 1
   for GPT, K6 once a layer); acceptance above 0 on the templated
   traffic; the page pool and the draft pool quiesced after `drain()`.
   Prints tokens/s, step p50/p90, acceptance, tokens a decode row a
   step and the device's busy share of each spec arm.
11. the serving engine's host layers (obs, the SLO tracker and the cost
   census, on by default as in the JAX engine) and its fault paths, on
   GPT-124M (and Llama-7B's 8-layer copy inside phase 8). Obs on
   against off: phase 3's traffic in the defaults and megakernel arms,
   two alternating runs a side — tokens and every kernel's launches
   equal in all four, the device-to-host copies in 3 traced decode steps
   equal, the flight ring's records equal to the metrics snapshot
   (packed tokens, queue depth, residents); step p50 and tokens/s the
   median of a side. Poison quarantine in the defaults, legacy and
   `spec="ngram:4"` arms (and Llama-7B's defaults): 8 requests of phase
   3's traffic, one poisoned at admission and, in two more runs, after 5
   steps (mid-prefill) and after its fifth token — it ends "poisoned" with `PoisonedRequest` and a timeline
   ending in "poison", the innocents' tokens equal a run without it
   (at most two near ties an arm, phase 10's rule), launches = the
   arm's launches a step x the rounds that launched (probe rounds
   printed), one "poison_quarantine" incident holding the steps before
   it, the pool quiesced after `drain()`; a hook raising every round
   propagates and poisons nobody. The census: "model" and "lowered"
   (one counted forward of the step), each source the mode asked for,
   the "lowered" record equal to the same geometry counted on the CPU;
   FLOPs, bytes and their ratio to "model" printed. The driver
   (`serving.http.EngineDriver`): 8 streamed requests with a direct
   run's tokens, `kill_at_step(20)` retiring the residents as
   "replica_failure" with a "replica_death" incident and `ReplicaDead`
   after, `fail_add_request(3)` refusing the third admission only.
12. grammar-constrained decoding, the embeddings lane, session pins and
   the KV fabric on GPT-124M's first 6 layers (Llama-7B's parts on
   phase 8's 8-layer copy, inside phase 8). Phase 2 first holds K12 on
   grammar-biased logits ([16, 50304] and [512, 50304]: rows with one
   allowed token, three tied, EOS alone) to `torch.argmax` bit for bit.
   Grammar: phase 3's prompts, 48 tokens each, 16 rows constrained
   (6 choice, 5 regex, 5 JSON over `default_token_strings`), 8 free, in
   the defaults, megakernel and megakernel + `ngram:4` arms: each
   constrained output follows its automaton and validates (or ends by
   length); the free rows equal the gate-off run (near ties aside,
   phase 10's rule, teacher-forced margins); the gate on with nothing
   constrained equals the gate off in tokens and launches; launches
   exact (K12 once a step under the megakernel, twice with spec);
   counters, bias bytes a step, tokens/s and p50 with the gate on and
   off (3 alternating runs a side at the defaults). Embeddings: 8 embed
   requests beside 8 generating ones (GPT-124M bf16 and int8, Llama-7B
   bf16): every byte of the embed rows' pages kept by the epilogue, its
   launches exact (the walk and the write once a layer, K1 2L + 1), the
   generating rows equal a run without the embed rows (near ties
   aside), the f32 copy's embeddings within 0.01 of the plain epilogue
   and, over float pools, of the plain f32 backbone over the prompt;
   the epilogue's milliseconds. Sessions: a pinned turn 2 hits every
   full page of turn 1 under pressure that evicts them, and none past
   the TTL (TTFT printed). Fabric (bf16, int8, fp8; Llama-7B int8): B
   continues A's exported chain with A's own tokens from a full hit;
   frame bytes the header's accounting; a page-32 engine refuses it
   whole; A's snapshot restores warm; export and import milliseconds.
13. the HTTP front end on GPT-124M's first 6 layers (bf16),
   engines at their defaults behind `serve()` on 127.0.0.1, clients on
   `http.client` with socket timeouts, every server drained and every
   client thread joined. A: two replicas; 8 blocking JSON requests, 6
   SSE streams, 2 `response_format` requests (choice, json_object) and 2
   `/v1/embeddings` requests at once, each against the same request
   served alone in-process (tokens equal or near ties, phase 12's
   rule; embeddings equal bit for bit); launches exactly each
   replica's steps x a step's plus its embed epilogues x an epilogue's;
   /metrics parses, /healthz and /readyz 200; TTFT p50/p90 (SSE client,
   engine stamp, the same requests in-process all at once) and tokens/s.
   B: replica-0 killed (`FaultInjector.kill_at_step`) with at least 4
   of its 8 streams mid-decode, then hung under a 2 s watchdog with 2
   of 4: every stream ends with its 48 tokens, each moved one reports
   `usage.migrations`, tokens as in A; the hang condemned as
   ReplicaHung within the timeout and a scan. C: `Router(fabric=
   FabricConfig(roles=...))` behind a `ServingHTTPServer`, bf16 and int8
   pools: 4 prompts hand off (hand-offs 4, pages moved their full
   pages), tokens as in A, launches exact, each frame's bytes and
   export/import ms. D: under PADDLE_TPU_KV_FABRIC=on, a replica that
   served a prompt is removed and a new one added: it restores pages
   and serves the prompt with the warm replica's cached tokens. E: one
   replica of one slot and a queue of one with the rate limiter and the
   control plane on: 429 (limiter, Retry-After), 504 (deadline), 429
   (`deadline_infeasible`), 429 (queue), then `drain()`: /readyz 503
   at once and the resident finishes.

The second-to-last line is a JSON object with one record per kernel:
`launches` counts the launches on the path (`path`: serving, the
default engine's run; serving_ungrouped, the grouped=False run;
serving_page256, the defaults with pages of 256; the same over int8 or
fp8 pools, serving_int8[_ungrouped] and
serving_fp8[_ungrouped]; the legacy step, serving_legacy[_fp8|_int8];
the gather arm, serving_gather; the megakernel and adapter arms,
serving_[int8_]megakernel, serving_adapters[_megakernel[_2pages]],
serving_adapters_r32_megakernel and serving_int8_adapters_megakernel;
training; training_gpt3_width, phase 7's step; or generate) whose
shapes the record was measured at, and `launches_by_path` those on each
path, each counted from 0 just before its run: besides those, phase 5's
generate_beam and generate_int8, and phase 8's llama_serving[_ungrouped|
_int8|_legacy|_megakernel|_adapters_megakernel], llama_generate[_beam|
_int8] and llama3_gqa_serving[_ungrouped|_megakernel], and phase 9's
llama_training[_no_recompute|_accumulate] and llama3_gqa_training (a
step's launches each), and phase 10's spec_{phase3|templated}_{defaults|
int8|megakernel|adapters}_{ngram|model} and llama_spec_defaults_{ngram|
model}, and phase 11's obs_{defaults|megakernel} (the layers on),
quarantine[_legacy|_spec_ngram] and llama_quarantine (a run poisoned
after 5 steps, probe rounds included), and phase 12's
grammar_{defaults|megakernel|spec_ngram} (the constrained run),
embed_gpt[_int8] and llama_embed (the bf16 run with its epilogues), and
phase 13's http_mixed (arm A, both replicas) and http_handoff_{fp|int8}
(arm C, both replicas). The last line
is `{"ok": true, "device": {...}}`. Without CUDA
the script prints no result and exits 1.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import weakref

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
# phase 3's budget arm: at most 64 tokens packed a step (of the 16 x 32
# the step shape holds), `debug_state()` read after DEBUG_STEP steps
TOKEN_BUDGET, DEBUG_STEP = 64, 5
# phase 3's preemption run: a pool of 40 pages a slot, 16 priority-5
# requests of 560 prompt tokens (39 pages each with their 64 new tokens),
# then a burst of 4 priority-0 requests of the same size
PREEMPT_PAGES, PREEMPT_PROMPT, PREEMPT_BURST = 16 * 40 + 1, 560, 4
# kernel vs plain version on the card; both compute in f32 from the same
# inputs. An f32 output: max error <= F32_TOL x (1 + max|ref|) (summation
# order). A bf16 output, element by element: <= BF16_ULPS ulps of the
# reference element plus F32_TOL x max|ref| (both round f32 values that
# differ by their summation order, so mostly 0 or 1 ulp apart); an f16
# output: BF16_ULPS f16 ulps plus the f32 rule's F32_TOL x (1 + max|ref|)
# (f16 keeps three more bits, so an output that is what is left of a
# cancellation can carry more than two ulps of f32 noise). The
# tensor-core flash kernels (K3, K4, K5 in bf16 and f16) round P_eff and
# dS to the operand dtype before their second product, as the TPU kernel
# does: their check adds, per element, one such rounding carried through
# that product (`tfa.fwd_rounding_allowance`, `tfa.dq_rounding_allowance`,
# `tfa.dkv_rounding_allowance`)
F32_TOL, BF16_ULPS = 1e-5, 2
# the flash kernels' bit-repeat check: runs that must equal the first
FLASH_REPEATS = 20
# held logits, bf16 path on the card vs the f32 plain rerun on the CPU:
# bf16 activations through 12 layers against f32 (logits have std ~0.5;
# the first H100 run measured 0.026)
HELD_LOGITS_TOL = 0.1
# phase 8's, Llama-7B, whose untied head gives logits of std ~1.3 (0.02 x
# sqrt(4096), 2.3x GPT-124M's tied head's). bf16 against f32: 32 layers
# whose residual stream grows to std ~11 (each layer adds ~4 to its
# variance), 64 bf16 roundings of it and each sublayer's compounding
# through the later layers: a few % of the logits' std at the worst of a
# step's ~500k logits (the first H100 run measured 0.3307, against a
# first tolerance of 0.25). The same model in f32 through the kernels
# against the plain versions differs only in the kernels' summation
# order (F32_TOL relative per call), carried through 32 layers
LLAMA_HELD_LOGITS_TOL = 0.5
LLAMA_F32_HELD_TOL = 1e-2
# and held against the bf16 model's plain rerun on the card, by the mean
# over the live rows' logits: the kernel path's mean |difference| from it
# at most this many times the bf16 floor, the mean |difference| of that
# plain bf16 rerun from the plain f32 one (bf16 rounding alone). The two
# bf16 paths share every GEMM and rounding point and differ in the
# attention's summation order (and K3's P rounding), so they agree on
# most logits. Not the max: the logits are bf16, so one flipped rounding
# upstream moves a logit by an ulp of it (0.03 at 4-8), as far as bf16
# against f32 does
BF16_FLOOR_RATIO = 1.0
# held steps rerun on the card past this many parameters (`reference_on_card`)
CPU_RERUN_MAX_PARAMS = 1e9
# a served model's f32 copy on the CPU, made once for all its held reruns
_F32_CPU = weakref.WeakKeyDictionary()
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
# phase 5: GPTForCausalLM.generate
GENERATE = dict(batch=8, prompt=128, new=32)
GENERATE_BEAMS = 4
# phase 3's adapter arms: scripts/serving_bench.py --lora-ab's defaults
# (4 adapters of rank 4, numpy seed 0; tenants zipf over {base, 1..4},
# the first four requests one per adapter) at amplitude 0.05
LORA = dict(adapters=4, rank=4, amp=0.05)
# K11's ranks past one k-step of d, checked and timed in phase 2; and the
# rank buckets of phase 3's arm whose adapter pool has rank 32
LORA_LARGE_RANKS = (32, 64)
LORA_RANK32_BUCKETS = (8, 32)
# phase 6: 2-layer GPTs at head dims the flash kernels take (256) and do
# not take (32: the plain `_sdpa_ref` route), bf16
HEAD_DIM_GPTS = {
    256: dict(vocab_size=50304, hidden_size=1024, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=1024),
    32: dict(vocab_size=50304, hidden_size=768, num_hidden_layers=2,
             num_attention_heads=24, max_position_embeddings=1024)}
# K3-K5 at head dim 256 in phase 2: phase 6's train step, [B, L, H, D]
D256_FLASH = (2, 1024, 4, 256)
# K3's serving cases run again in phase 2 at Llama-7B's 32 heads of 128:
# phase 8's legacy prefill chunks and its generate() (the gather arm is
# GPT's only)
LLAMA_FLASH_CASES = ("legacy prefill Lq 8", "legacy prefill Lq 16",
                     "legacy prefill Lq 32", "generate prefill",
                     "generate decode")
# phase 8: Llama-7B, the `LlamaConfig()` defaults (BASELINE.md config
# #5: vocab 32000, hidden 4096, 32 layers of 32 heads, intermediate
# 11008), built at full depth; its six serving arms, `generate()`,
# phase 10's speculative arms and phase 11's quarantine arm run on a
# weight copy of its first LLAMA7B_ARM_LAYERS layers (cut so that the
# script keeps inside its time: phase 10's arms at 32 layers took 97 s);
# and a GQA arm at
# Meta-Llama-3-8B's published widths (its config.json: vocab 128256, 32
# heads over 8 kv heads, intermediate 14336, 8192 positions, eps 1e-5,
# theta 500000), cut to 4 of its 32 layers
LLAMA7B = dict()
LLAMA7B_ARM_LAYERS = 8
LLAMA3_GQA = dict(vocab_size=128256, hidden_size=4096, num_hidden_layers=4,
                  num_attention_heads=32, num_key_value_heads=8,
                  intermediate_size=14336, max_position_embeddings=8192,
                  rms_norm_eps=1e-5, rope_theta=500000.0)


_T0 = time.perf_counter()


def log(msg: str):
    """Print a line; a phase's heading carries the seconds since the
    script started."""
    if msg.startswith("phase "):
        msg = f"{msg} [at {time.perf_counter() - _T0:.1f} s]"
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


def ptxas_rows(text: str, symbol: str) -> list:
    """[(mangled name, registers, spill store bytes)] of each kernel
    whose mangled name contains `symbol`, in an `-Xptxas -v` log."""
    rows, cur, spill = [], None, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = m.group(1) if symbol in m.group(1) else None
            spill = None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if cur and m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if cur and m and spill is not None:
            rows.append((cur, int(m.group(1)), spill))
            cur = None
    return rows


# mangled element types -> names
DTYPE_NAMES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def template_args(mangled: str) -> list:
    """The template arguments of a mangled kernel name's argument list
    (the text after its `I`): type names, `f` for float, a substitution
    (`S1_`: a type named before) as that type, integers as digits."""
    args, names, i = [], [], 0
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group(0)
            name = mangled[i + len(n):i + len(n) + int(n)]
            names.append(name)
            args.append(DTYPE_NAMES.get(f"{n}{name}", name))
            i += len(n) + int(n)
        elif mangled[i] == "L":
            lit = re.match(r"L[a-z](\d+)E", mangled[i:])
            args.append(lit.group(1))
            i += len(lit.group(0))
        elif mangled[i] == "S":
            sub = re.match(r"S(\d*)_", mangled[i:])
            args.append(args[0] if args else "?")
            i += len(sub.group(0))
        else:
            args.append(DTYPE_NAMES.get(mangled[i], mangled[i]))
            i += 1
    return args


def ln_ptxas(text: str) -> list:
    """[(kernel, registers, spill store bytes)] of each instantiation in
    the `-Xptxas -v` log of layer_norm.cu (K1 and K2, their wide lanes
    and K2's column sums), named like `ln_fwd_kernel<bf16, f32, 3>` (x's
    dtype, the weights', then the vectors a lane)."""
    rows = []
    for name, regs, spill in ptxas_rows(text, "ln_"):
        kind = re.search(r"(ln_\w+?_kernel)I(\w+)", name)
        if kind:
            args = template_args(kind.group(2))
            rows.append((f"{kind.group(1)}<{', '.join(args)}>", regs, spill))
    return rows


def tensor_core_ptxas(text: str) -> list:
    """[(kernel, registers, spill store bytes)] of each tensor-core flash
    instantiation in the `-Xptxas -v` log of flash_attention.cu, named
    like `fa_dq_tc_kernel<bf16, 64>` (K3's with its warpgroup count)."""
    rows = []
    for name, regs, spill in ptxas_rows(text, "_tc_kernel"):
        kind = re.search(r"(fa_\w+?_tc_kernel)I(\w+?)Li(\d+)E(?:Li(\d)E)?",
                         name)
        dtype = "bf16" if "bfloat16" in kind.group(2) else "f16"
        args = [dtype, kind.group(3)] + ([kind.group(4)] if kind.group(4)
                                         else [])
        rows.append((f"{kind.group(1)}<{', '.join(args)}>", regs, spill))
    return rows


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The spacing of bf16 (or f16) values at |x| (0 at 0)."""
    _, e = torch.frexp(x.abs())
    bits = 8 if dtype == torch.bfloat16 else 11
    ulp = torch.ldexp(torch.ones_like(x), e - bits)
    if dtype == torch.float16:   # subnormals: a fixed spacing
        ulp = torch.clamp(ulp, min=2.0 ** -24)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def check_close(name, got, want, mask=None, extra=None, extra_rule=""):
    """Kernel output `got` against its plain version `want` by the rule
    of F32_TOL / BF16_ULPS above (plus, per element, `extra` where a
    kernel states a further allowance); returns the max abs error."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
        extra = None if extra is None else extra[mask]
    diff = (got - want).abs()
    err = diff.max().item()
    ref_max = want.abs().max().item()
    if dtype == torch.bfloat16:
        allowed = BF16_ULPS * bf16_ulp(want) + F32_TOL * ref_max
        rule = f"{BF16_ULPS} bf16 ulps + {F32_TOL} x max|ref| per element"
    elif dtype == torch.float16:
        allowed = BF16_ULPS * bf16_ulp(want, dtype) + F32_TOL * (1 + ref_max)
        rule = (f"{BF16_ULPS} f16 ulps + {F32_TOL} x (1 + max|ref|) per "
                "element")
    else:
        allowed = torch.full_like(want, F32_TOL * (1.0 + ref_max))
        rule = f"{F32_TOL} x (1 + max|ref|)"
    if extra is not None:
        allowed = allowed + extra
        rule = f"{rule} {extra_rule}"
    worst = (diff / allowed).max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= allowed).all())
    log(f"  {name}: max_abs_err={err:.3e}, worst err/allowed {worst:.3f} "
        f"({rule}, max|ref| {ref_max:.3e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# -- phase 2: kernels against their plain versions ------------------------
def check_layer_norm(dev, tln, time_ms):
    """K1 at the training step's shape [B * L, 768], the serving step's
    [slots * chunk, 768] and the legacy decode step's [slots, 768], f32
    and bf16, each timed in bf16 with its launch (`layer_norm_plan`)
    recorded, and 20 reruns bit for bit. The record's times are the
    serving step's (K1's first path); the others under `training_shape`
    and `decode_shape`."""
    cols = GPT124M["hidden_size"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs, times = {}, {}
    for path, rows in (("training", TRAIN["batch"] * TRAIN["seq"]),
                       ("serving", ENGINE["num_slots"] * ENGINE["chunk_len"]),
                       ("decode", ENGINE["num_slots"])):
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
        same_bits(f"K1 y [{rows}, {cols}] bf16",
                  lambda: (tln.layer_norm(x, w, b, 1e-5),))
        ms = time_ms(lambda: tln.layer_norm(x, w, b, 1e-5))
        plain_ms = time_ms(lambda: tln.layer_norm_reference(x, w, b, 1e-5))
        lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (cols,), w, b, 1e-5))
        n_bytes = 2 * rows * cols * x.element_size() + \
            2 * cols * w.element_size()
        bound_ms, bound_by = bound(n_bytes, 8 * rows * cols, F32_FLOPS)
        plan = tln.layer_norm_plan(rows, cols, x.dtype, dev)
        log(f"  K1 bf16 [{rows}, {cols}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}); launch {plan}")
        times[path] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib_ms,
                           max_abs_err=errs[path, torch.bfloat16],
                           launch=plan)
    return dict(name="K1 layer_norm_fwd", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                replaces="paddle_tpu/ops/pallas/layer_norm.py:60",
                path="serving", **times["serving"],
                training_shape=times["training"],
                decode_shape=times["decode"])


# F11's shapes in phase 2: (rows, cols, x's dtype, w's dtype): GPT-3
# 2.7B's and 6.7B's widths in f32 and 13B's in bf16 (Brown et al. 2020,
# Table 2.1; [2048, 5120] is phase 7's step), the widest row the kernels
# take, and f32 weights under bf16
# activations at GPT-124M's and GPT-3 13B's widths
LN_F11_SHAPES = ((64, 2560, torch.float32, torch.float32),
                 (64, 4096, torch.float32, torch.float32),
                 (64, 5120, torch.bfloat16, torch.bfloat16),
                 (2048, 5120, torch.bfloat16, torch.bfloat16),
                 (8, 65536, torch.bfloat16, torch.bfloat16),
                 (512, 768, torch.bfloat16, torch.float32),
                 (64, 5120, torch.bfloat16, torch.float32))
# the width F11's jnp branch is checked at: 200 bytes in bf16
LN_JNP_WIDTH = 100


def check_layer_norm_f11(dev, tln, time_ms):
    """F11: K1 and K2 at LN_F11_SHAPES against their plain versions (the
    rows past the register lanes take the wide lanes; w and b of another
    dtype than x are converted to f32 in the kernels), dx, dw and db 20
    reruns bit for bit, each timed beside its bound, its plain version
    and the library's call (`F.layer_norm`; `native_layer_norm_backward`
    given the saved statistics, as in `check_layer_norm_bwd`; null where
    the library refuses the dtypes) with its lane; and the functional
    LayerNorm at width LN_JNP_WIDTH in bf16, which the
    kernels do not take: no launch, the port of the JAX jnp branch on the
    card against the same function on the CPU. Returns ({shape: K1's
    record}, {shape: K2's record})."""
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.nn.functional.norm import _ln_jnp
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    fwd, bwd = {}, {}
    for rows, cols, dtype, wdtype in LN_F11_SHAPES:
        mk = lambda *s: torch.randn(*s, generator=g, device=dev)
        x, dy = (mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype)
        w, b = mk(cols).to(wdtype), mk(cols).to(wdtype)
        tag = (f"[{rows}, {cols}] {str(dtype)[6:]}"
               + (f", w {str(wdtype)[6:]}" if wdtype != dtype else ""))
        y = tln.layer_norm(x, w, b, 1e-5)
        got = tln.layer_norm_bwd(dy, x, w, 1e-5)
        torch.cuda.synchronize()
        err1 = check_close(f"K1 {tag}", y,
                           tln.layer_norm_reference(x, w, b, 1e-5))
        want = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
        err2 = max(check_close(f"K2 {n} {tag}", a, r)
                   for n, a, r in zip(("dx", "dw", "db"), got, want))
        if not (y.dtype == got[0].dtype == dtype
                and got[1].dtype == got[2].dtype == wdtype):
            raise AssertionError(f"LayerNorm {tag}: output dtypes")
        same_bits(f"K2 dx, dw, db {tag}",
                  lambda: tln.layer_norm_bwd(dy, x, w, 1e-5))
        ms1 = time_ms(lambda: tln.layer_norm(x, w, b, 1e-5))
        ms2 = time_ms(lambda: tln.layer_norm_bwd(dy, x, w, 1e-5))
        plain1 = time_ms(lambda: tln.layer_norm_reference(x, w, b, 1e-5))
        plain2 = time_ms(lambda: tln.layer_norm_bwd_reference(dy, x, w,
                                                               1e-5))
        lib1 = library_ms(time_ms, lambda: torch.nn.functional.layer_norm(
            x, (cols,), w, b, 1e-5))
        try:
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x, [cols], w, b, 1e-5)
            lib2 = library_ms(
                time_ms, lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [cols], mean, rstd, w, b, [True, True, True]))
        except RuntimeError:
            lib2 = None
        xs, ws = x.element_size(), w.element_size()
        b1 = bound(2 * rows * cols * xs + 2 * cols * ws, 8 * rows * cols,
                   F32_FLOPS)
        b2 = bound(3 * rows * cols * xs + 3 * cols * ws, 16 * rows * cols,
                   F32_FLOPS)
        p1 = tln.layer_norm_plan(rows, cols, dtype, dev, wdtype)
        p2 = tln.layer_norm_bwd_plan(rows, cols, dtype, dev, wdtype)
        lane = "wide" if p1["wide"] else "register"
        log(f"  F11 {tag} ({lane} lane): K1 {ms1:.4f} ms (plain "
            f"{plain1:.4f}, F.layer_norm {lib1}, bound {b1[0]:.5f}), K2 "
            f"{ms2:.4f} ms (plain {plain2:.4f}, native_layer_norm_backward "
            f"{lib2}, bound {b2[0]:.5f}); launches {p1}, {p2}")
        fwd[tag] = dict(ms=ms1, plain_ms=plain1, library_ms=lib1,
                        bound_ms=b1[0], bound_by=b1[1], max_abs_err=err1,
                        launch=p1)
        bwd[tag] = dict(ms=ms2, plain_ms=plain2, library_ms=lib2,
                        bound_ms=b2[0], bound_by=b2[1], max_abs_err=err2,
                        launch=p2)
    cols = LN_JNP_WIDTH
    x = (torch.randn(64, cols, generator=g, device=dev) * 2 + 1).to(
        torch.bfloat16).requires_grad_(True)
    w, b = (torch.randn(cols, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    before = (tln.LAUNCHES, tln.BWD_LAUNCHES)
    y = PF.layer_norm(x, cols, w, b)
    y.sum().backward()
    torch.cuda.synchronize()
    xc = x.detach().cpu().requires_grad_(True)
    want = _ln_jnp(xc, w.cpu(), b.cpu(), 1, 1e-5)
    want.sum().backward()
    if (tln.LAUNCHES, tln.BWD_LAUNCHES) != before:
        raise AssertionError(f"LayerNorm at width {cols}: a kernel launched")
    err = max(check_close(f"F11 jnp branch [64, {cols}] bf16 {n}", a, r)
              for n, a, r in (("y", y.cpu(), want), ("dx", x.grad.cpu(),
                                                     xc.grad)))
    fwd[f"jnp branch [64, {cols}] bf16"] = dict(max_abs_err=err,
                                                launches=0)
    return fwd, bwd


def library_ms(time_ms, fn):
    """time_ms(fn), or None where the library call refuses its inputs
    (a RuntimeError, such as a dtype pairing it does not take)."""
    try:
        fn()
    except RuntimeError:
        return None
    return time_ms(fn)


# K2's shapes in phase 2: (rows, dtype), the first the record's: the
# training step's [16384, 768] in bf16, f32 and f16, and the serving
# width's [512, 768]
LN_BWD_SHAPES = ((16384, torch.bfloat16), (512, torch.bfloat16),
                 (16384, torch.float32), (16384, torch.float16))


def check_layer_norm_bwd(dev, tln, time_ms):
    """K2 at LN_BWD_SHAPES (768 columns): dx, dw and db against the
    plain version, FLASH_REPEATS runs bit for bit (dw and db are summed
    in a fixed order across the card), each timed beside its bound and
    its launch (`layer_norm_bwd_plan`) recorded; at [16384, 768] bf16
    also the plain version and `native_layer_norm_backward`. The record's
    numbers are bf16 [16384, 768]'s, the others under `shapes`."""
    cols = GPT124M["hidden_size"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes = {}
    for rows, dtype in LN_BWD_SHAPES:
        mk = lambda *s: torch.randn(*s, generator=g, device=dev)
        x, dy = (mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype)
        w = mk(cols).to(dtype)
        tag = f"[{rows}, {cols}] {dtype}"
        got = tln.layer_norm_bwd(dy, x, w, 1e-5)
        torch.cuda.synchronize()
        want = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
        err = max(check_close(f"K2 layer_norm_bwd {n} {tag}", a, b)
                  for n, a, b in zip(("dx", "dw", "db"), got, want))
        same_bits(f"K2 dx, dw, db {tag}",
                  lambda: tln.layer_norm_bwd(dy, x, w, 1e-5))
        ms = time_ms(lambda: tln.layer_norm_bwd(dy, x, w, 1e-5))
        item = x.element_size()
        # dy, x in and dx out once, w in and dw, db out once
        n_bytes = 3 * rows * cols * item + 3 * cols * item
        bound_ms, bound_by = bound(n_bytes, 16 * rows * cols, F32_FLOPS)
        plan = tln.layer_norm_bwd_plan(rows, cols, dtype, dev)
        log(f"  K2 {tag}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}, {bound_ms / ms:.3f} of it); launch {plan}")
        shapes[f"{rows}x{cols} {str(dtype)[6:]}"] = dict(
            ms=ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
            launch=plan)
        if (rows, dtype) == LN_BWD_SHAPES[0]:
            main = x, dy, w
    x, dy, w = main
    rows = x.shape[0]
    plain_ms = time_ms(lambda: tln.layer_norm_bwd_reference(dy, x, w, 1e-5))
    b = torch.zeros_like(w)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [cols], w, b, 1e-5)
    lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [cols], mean, rstd, w, b, [True, True, True]))
    rec = shapes[f"{rows}x{cols} bfloat16"]
    log(f"  K2 bf16 [{rows}, {cols}]: kernel {rec['ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, native_layer_norm_backward {lib_ms:.4f} ms, "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return dict(name="K2 layer_norm_bwd", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu",
                replaces="paddle_tpu/ops/pallas/layer_norm.py:68",
                path="training", max_abs_err=rec["max_abs_err"],
                ms=rec["ms"], plain_ms=plain_ms, bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=lib_ms,
                launch=rec["launch"], shapes=shapes)


def same_bits(name, fn, n=FLASH_REPEATS):
    """Call fn() n times: every output must equal the first call's bit
    for bit."""
    first = fn()
    for i in range(1, n):
        again = fn()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{name}: run {i + 1} differs from run 1")
    torch.cuda.synchronize()
    log(f"  {name}: {n} runs bit-identical")


FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
ROUNDING_RULE = ("+ one rounding of each {} to the operand dtype, carried "
                 "through {}")


def check_flash_attention(dev, tfa, time_ms, shape=None):
    """K3, K4 and K5 at the training step's shapes (or `shape`, [B, L, H,
    D]), causal: each against its plain version in f32, bf16 and f16 (in
    bf16 and f16 with the tensor-core design's rounding allowance), each
    FLASH_REPEATS times in bf16 bit for bit, then timed in bf16, with
    the backward's sum (K4 + K5 + the di row sum) beside SDPA's whole
    backward."""
    b, l = TRAIN["batch"], TRAIN["seq"]
    h = GPT124M["num_attention_heads"]
    d = GPT124M["hidden_size"] // h
    if shape is not None:
        b, l, h, d = shape
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs, designs = {}, {}
    for dtype in FLASH_DTYPES:
        q, k, v, do = (torch.randn(b, l, h, d, generator=g, device=dev
                                   ).to(dtype) for _ in range(4))
        tag = f"[{b}, {l}, {h}, {d}] causal {dtype}"
        designs[str(dtype)[6:]] = design = tfa.kernel_design(dtype, d)
        log(f"  K3-K5 {tag}: K3 on the {design['fwd']}, K4 on the "
            f"{design['dq']}, K5 on the {design['dkv']}")
        rounds = dtype != torch.float32
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=True)
        e3 = check_close(
            f"K3 flash fwd o {tag}", o, o_ref,
            extra=tfa.fwd_rounding_allowance(q, k, v, causal=True)
            if rounds else None,
            extra_rule=ROUNDING_RULE.format("P_eff", "P_eff . V / l"))
        check_close(f"K3 flash fwd lse {tag}", lse, lse_ref)
        del o_ref, lse_ref
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).reshape(
            b * h, l).contiguous()
        args = (q, k, v, lse, di, do)
        dq = tfa.flash_attention_dq(*args, causal=True)
        torch.cuda.synchronize()
        e4 = check_close(f"K4 flash dq {tag}", dq,
                         tfa.flash_dq_reference(*args, causal=True),
                         extra=tfa.dq_rounding_allowance(*args, causal=True)
                         if rounds else None,
                         extra_rule=ROUNDING_RULE.format("dS", "dS . K"))
        dk, dv = tfa.flash_attention_dkv(*args, causal=True)
        torch.cuda.synchronize()
        dk_ref, dv_ref = tfa.flash_dkv_reference(*args, causal=True)
        ek, ev = (tfa.dkv_rounding_allowance(*args, causal=True)
                  if rounds else (None, None))
        e5 = max(check_close(f"K5 flash dk {tag}", dk, dk_ref, extra=ek,
                             extra_rule=ROUNDING_RULE.format("dS",
                                                             "dS^T . Q")),
                 check_close(f"K5 flash dv {tag}", dv, dv_ref, extra=ev,
                             extra_rule=ROUNDING_RULE.format(
                                 "P_eff", "P_eff^T . dO")))
        del dk_ref, dv_ref, ek, ev
        if dtype == torch.bfloat16:
            same_bits(f"K3 {tag}", lambda: tfa.flash_attention_fwd(
                q, k, v, causal=True))
            same_bits(f"K4 {tag}", lambda: (tfa.flash_attention_dq(
                *args, causal=True),))
            same_bits(f"K5 {tag}", lambda: tfa.flash_attention_dkv(
                *args, causal=True))
            timed = (q, k, v, o, do, args)
        errs[dtype] = (e3, e4, e5)
        torch.cuda.empty_cache()
    q, k, v, o, do, args = timed
    # timing in bf16; the library yardstick is SDPA on [B, H, L, D]
    fwd = lambda: tfa.flash_attention_fwd(q, k, v, causal=True)
    dq_k = lambda: tfa.flash_attention_dq(*args, causal=True)
    dkv_k = lambda: tfa.flash_attention_dkv(*args, causal=True)
    ms = [time_ms(f, iters=5) for f in (fwd, dq_k, dkv_k)]
    di_ms = time_ms(lambda: tfa._row_dot(o, do), iters=5)
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
            design={t: ds[("fwd", "dq", "dkv")[i]]
                    for t, ds in designs.items()},
            source="paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{lines[i]}",
            max_abs_err=errs[torch.bfloat16][i], ms=ms[i],
            plain_ms=plain_ms[i], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib[i],
            library_call=("F.scaled_dot_product_attention(is_causal=True)"
                          if i == 0 else "its backward: dq, dk, dv")))
    # SDPA's backward computes dq, dk and dv together: the fair match is
    # the port's whole backward, di = rowsum(o * dO) (a torch op) and K4, K5
    total = ms[1] + ms[2] + di_ms
    recs[1]["backward_sum"] = dict(K4=ms[1], K5=ms[2], di=di_ms, sum=total,
                                   sdpa_backward=lib_bwd)
    log(f"  backward bf16 [{b}, {l}, {h}, {d}] causal: K4 {ms[1]:.4f} + K5 "
        f"{ms[2]:.4f} + di row sum {di_ms:.4f} = {total:.4f} ms against "
        f"SDPA backward {lib_bwd:.4f} ms")
    return recs


def ragged_batch(dev, dtype, h, hkv, seed, d=64):
    """A serving-step-shaped mixed batch: q [16, 32, h, d], pools of
    993 pages of 16, page tables in shuffled page order; rows idle
    (q_len 0), decoding (1), partial and full-chunk prefill, with pos
    near 0, at page ends and deep in the window."""
    rs = np.random.RandomState(seed)
    b, lq = ENGINE["num_slots"], ENGINE["chunk_len"]
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


# the walk kernels' records by (kernel, pool lane): the kernels-line key,
# its name, and the serving path (phase 3 arm) whose launches it counts
WALKS = {
    ("K6", "fp"): ("K6", "K6 ragged_paged_attention", "serving_ungrouped"),
    ("K6", "fp8"): ("K6-fp8", "K6-fp8 ragged_paged_attention (e4m3 pools)",
                    "serving_fp8_ungrouped"),
    ("K6", "q8"): ("K7", "K7 ragged_paged_attention_q8",
                   "serving_int8_ungrouped"),
    ("K10a", "fp"): ("K10a", "K10a grouped_phase1", "serving"),
    ("K10b", "fp"): ("K10b", "K10b grouped_phase2", "serving"),
    ("K10a", "fp8"): ("K10a-fp8", "K10a-fp8 grouped_phase1 (e4m3 pools)",
                      "serving_fp8"),
    ("K10b", "fp8"): ("K10b-fp8", "K10b-fp8 grouped_phase2 (e4m3 pools)",
                      "serving_fp8"),
    ("K10a", "q8"): ("K10a-q8", "K10a-q8 grouped_phase1 (int8 pools)",
                     "serving_int8"),
    ("K10b", "q8"): ("K10b-q8", "K10b-q8 grouped_phase2 (int8 pools)",
                     "serving_int8"),
}
LANE_NAMES = {"fp": "fp lane", "fp8": "fp8 lane (e4m3 pools)",
              "q8": "q8 lane (int8 pools + f32 scales)"}


def check_paged_attention(dev, tpa, time_ms, lane="fp"):
    """K6 in pool lane `lane` (fp: K6; fp8: its e4m3 lane; q8: K7) on
    the serving batches of `ragged_batch` — f32 rep 1, bf16 rep 2 and
    rep 1 — against its plain version on the same pools (live queries);
    then the bf16 rep-1 batch is timed: the kernel, the plain version
    and SDPA over the gathered (dequantized) K/V."""
    from paddle_tpu_torch.ops.cuda.launch_check import (lane_batch, ragged,
                                                        ragged_reference)
    key, name, path = WALKS["K6", lane]
    errs = {}
    for dtype, (h, hkv) in ((torch.float32, (12, 12)),
                            (torch.bfloat16, (12, 6)),
                            (torch.bfloat16, (12, 12))):
        ops, scales = lane_batch(ragged_batch(dev, dtype, h, hkv, SEED), lane)
        out = ragged(ops, scales)
        torch.cuda.synchronize()
        ref = ragged_reference(ops, scales)
        q_len = ops[5]
        live = (torch.arange(out.shape[1], device=dev)[None, :]
                < q_len[:, None])
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{key} wrote a non-finite dead query")
        errs[dtype] = check_close(f"{key} H={h} H_kv={hkv} {dtype}", out,
                                  ref, mask=live)
    q, k, v, table, pos, q_len = ops             # bf16, GPT-124M heads
    ms = time_ms(lambda: ragged(ops, scales))
    plain_ms = time_ms(lambda: ragged_reference(ops, scales))
    lib_ms = time_ms(sdpa_yardstick(*ops, **scales))
    b, lq, h, d = q.shape
    ql, ps_ = q_len.cpu().numpy(), pos.cpu().numpy()
    item = q.element_size()
    flat, _, _ = tpa.count_page_block_reads(
        table.cpu().numpy(), ps_, ql, page_size=k.shape[1])
    # what this batch needs: live queries, every row's live K/V pages
    n_bytes = (2 * int(ql.sum()) * h * d * item        # q in, out
               + flat * k.shape[2] * page_block_bytes(k, scales)
               + table.numel() * 4 + 2 * b * 4)
    bound_ms, bound_by = bound(n_bytes, 4 * attended_keys(ps_, ql) * h * d,
                               BF16_FLOPS)
    plan = tpa.ragged_plan(q, k)
    log(f"  {key} bf16 [16, 32, 12, 64], {LANE_NAMES[lane]}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (gathered, "
        f"{'dequantized, ' if lane != 'fp' else ''}masked) {lib_ms:.4f} "
        f"ms, bound {bound_ms:.5f} ms ({bound_by}); ring {plan['stages']} "
        f"stages, {plan['tiles']} f32 tiles, {plan['smem']} bytes of shared "
        f"memory; grid {plan['grid']} blocks of {plan['threads']} threads, "
        f"{plan['rows']} rows a block, two a warp: {bool(plan['paired'])}; "
        f"pieces of {plan['piece']} keys, {plan['copy']}-byte copies")
    return dict(name=name, route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/"
                       "ragged_paged_attention.cu",
                replaces="paddle_tpu/ops/pallas/paged_attention.py:375",
                path=path, max_abs_err=errs[torch.bfloat16],
                ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                launch=plan)


def sdpa_yardstick(q, k, v, table, pos, q_len, k_scale=None, v_scale=None,
                   mask=None):
    """K6's, K7's and K10's library yardstick: SDPA over the gathered
    dense K/V view — dequantized to q's dtype for the 1-byte lanes —
    under the ragged causal mask, with an additive user `mask` [B, H, lq,
    lmax] added when given (one call; its gather and mask are made here,
    outside the timed call)."""
    from paddle_tpu_torch.ops.cuda.paged_attention import _pages_f32
    b, lq, h, d = q.shape
    ps, mp = k.shape[1], table.shape[1]
    rep = h // k.shape[2]
    dense = lambda pool, sc: _pages_f32(pool, sc, table.long()).to(
        q.dtype).reshape(b, mp * ps, -1, d).repeat_interleave(
        rep, dim=2).transpose(1, 2)
    kd, vd = dense(k, k_scale), dense(v, v_scale)
    qd = q.transpose(1, 2)
    i = torch.arange(lq, device=q.device)[:, None]
    j = torch.arange(mp * ps, device=q.device)[None, :]
    window = (j <= pos[:, None, None] + i)[:, None]
    if mask is not None:
        window = torch.where(window, mask, torch.full_like(mask, -1e30)).to(
            q.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=window)


def page_block_bytes(pool, scales=None) -> int:
    """Bytes of one page block of one kv head, K and V: the pool's
    elements, plus an f32 scale per key for an int8 pool."""
    scale = 4 if scales else 0
    return 2 * pool.shape[1] * (pool.shape[3] * pool.element_size() + scale)


def attended_keys(pos, q_len, span=None) -> int:
    """(query, key) pairs the live queries attend: query i of row b sees
    keys 0 .. pos[b] + i, or with `span` [B] only those below it."""
    n = 0
    for b, (p, ql) in enumerate(zip(pos, q_len)):
        seen = int(p) + 1 + np.arange(int(ql))
        n += int(np.minimum(seen, span[b]).sum() if span is not None
                 else seen.sum())
    return n


def shared_spans(table, pos, q_len, gid, gcnt, ps):
    """Per row, the key count of the shared span its group reads once
    (0 outside a sharing group), with the span of each group as
    `count_page_block_reads` counts it; and the spans' page-block reads
    per kv head."""
    live = q_len > 0
    row_pages = np.where(live, (pos + np.maximum(q_len, 1) - 1) // ps + 1, 0)
    keys = np.zeros(len(q_len), np.int64)
    reads = 0
    for g in np.unique(gid[live]):
        members = np.nonzero(live & (gid == g))[0]
        shared = min(int(gcnt[g]), int(row_pages[members].min()))
        if members.size >= 2 and shared > 0:
            keys[members] = shared * ps
            reads += shared
    return keys, reads


def wall_ms(fn, iters: int = 2) -> float:
    """Time per call of `fn` from events around `iters` calls after a
    warm-up, host gaps included: for a plain version whose enqueue
    outlasts DeviceTimer's sleep."""
    fn()
    torch.cuda.synchronize()
    return DeviceTimer._events(lambda: [fn() for _ in range(iters)]) / iters


def check_grouped_attention(dev, tpa, time_ms, lane="fp"):
    """K10 in pool lane `lane` on batches built like phase 3's grouped
    steps: 16 rows, seven of them sharing 16 pages, q_len 1-32
    (`launch_check.grouped_batch`), H = H_kv = 12, D 64 in f32, bf16 and
    f16, H 16, H_kv 4, D 128 and H = H_kv = 32, D 128 (Llama-7B's
    heads) in bf16, over the lane's pools. K10a's
    partials against the plain phase-1 partials (member rows of live
    queries), K10b's output against the plain output (live queries), and
    the output against K6's in the same lane (K7 for q8), bit for bit;
    on the bf16 H 12 batch 20 more runs of both phases must repeat the
    first one's partials and output bit for bit. Then K10a, K10b, both,
    K6, the plain version (with `wall_ms`) and SDPA are timed on the bf16
    H 12 batch, and the launch the library makes there (`tpa.grouped_plan`:
    ring stages, tiles, shared memory, grid) is recorded."""
    from paddle_tpu_torch.ops.cuda.launch_check import (grouped_batch,
                                                        grouped, lane_batch,
                                                        ragged)
    key_a, name_a, path = WALKS["K10a", lane]
    key_b, name_b, _ = WALKS["K10b", lane]
    key6 = WALKS["K6", lane][0]
    errs, part_errs, batches = {}, {}, {}
    for dtype, (h, hkv, d) in ((torch.float32, (12, 12, 64)),
                               (torch.bfloat16, (12, 12, 64)),
                               (torch.float16, (12, 12, 64)),
                               (torch.bfloat16, (16, 4, 128)),
                               (torch.bfloat16, (32, 32, 128))):
        ops, grp = grouped_batch(dev, dtype, h, hkv, d, SEED)
        ops, scales = lane_batch(ops, lane)
        batches[dtype, h] = ops, grp, scales
        tag = f"H={h} H_kv={hkv} D={d} {dtype}, {LANE_NAMES[lane]}"
        partials = tpa.grouped_phase1(*ops, *grp, **scales)
        out = tpa.grouped_phase2(*ops, *grp, partials, **scales)
        k6 = ragged(ops, scales)
        torch.cuda.synchronize()
        same = torch.equal(out, k6)
        log(f"  K10 {tag}: {int((grp[2] > 0).sum())} sharing group(s), "
            f"{int(grp[2].max())} shared pages; output equals {key6}'s bit "
            f"for bit: {same}")
        if not same:
            raise AssertionError(f"K10 {tag} differs from {key6}")
        if not torch.isfinite(out.float()).all():
            raise AssertionError("K10 wrote a non-finite dead query")
        ref, (m, l, acc, written) = tpa.grouped_attention_reference(
            *ops, *grp, return_partials=True, **scales)
        sel = written & (m > tpa.NEG_INF / 2)     # member rows, live queries
        if (dtype, h) == (torch.bfloat16, 12):
            for _ in range(FLASH_REPEATS):
                again = tpa.grouped_phase1(*ops, *grp, **scales)
                if not all(torch.equal(x[sel], y[sel])
                           for x, y in zip(again, partials)) or \
                        not torch.equal(tpa.grouped_phase2(
                            *ops, *grp, again, **scales), out):
                    raise AssertionError(f"K10 {tag}: a rerun differs")
            log(f"  K10 {tag}: {FLASH_REPEATS} reruns of both phases "
                "repeat the partials and the output bit for bit")
        part_errs[dtype, h] = max(
            check_close(f"{key_a} partial {n} {tag}", got[sel], want[sel])
            for n, got, want in zip(("m", "l", "acc"), partials, (m, l, acc)))
        live = (torch.arange(out.shape[1], device=dev)[None, :]
                < ops[5][:, None])
        errs[dtype, h] = check_close(f"{key_b} output {tag}", out, ref,
                                     mask=live)
        del ref, m, l, acc
        if h != 12:
            del batches[dtype, h]
    ops, grp, scales = batches[torch.bfloat16, 12]
    args = tpa._grouped_check(*ops, *grp, **scales)
    partials = tpa.grouped_phase1(*args, **scales)
    ms_a = time_ms(lambda: tpa.grouped_phase1(*args, **scales))
    ms_b = time_ms(lambda: tpa.grouped_phase2(*args, partials, **scales))
    ms_both = time_ms(lambda: grouped(ops, grp, scales))
    ms_k6 = time_ms(lambda: ragged(ops, scales))
    plain_ms = wall_ms(lambda: tpa.grouped_attention_reference(
        *ops, *grp, **scales))
    lib_ms = time_ms(sdpa_yardstick(*ops, **scales))
    q, k, v, table, pos, q_len = ops
    b, lq, h, d = q.shape
    hkv, ps = k.shape[2], k.shape[1]
    tab, p_, ql = (t.cpu().numpy() for t in (table, pos, q_len))
    gid, gcn = grp[0].cpu().numpy(), grp[2].cpu().numpy()
    flat, reads, sizes = tpa.count_page_block_reads(tab, p_, ql, gid, gcn,
                                                    page_size=ps)
    span_keys, span_reads = shared_spans(tab, p_, ql, gid, gcn, ps)
    item = q.element_size()
    member = span_keys > 0
    q_member = int(ql[member].sum()) * h * d * item
    q_live = int(ql.sum()) * h * d * item
    # partials of member rows: m, l and acc, written by K10a, read by K10b
    part_bytes = sum(int(q_len_b) for q_len_b in ql[member]) * h * \
        (d + 2) * 4
    keys_a = attended_keys(p_, ql, span_keys)
    keys_all = attended_keys(p_, ql)
    blk = hkv * page_block_bytes(k, scales)
    bound_a = bound(span_reads * blk + q_member + part_bytes,
                    4 * keys_a * h * d, BF16_FLOPS)
    bound_b = bound((reads - span_reads) * blk + 2 * q_live + part_bytes,
                    4 * (keys_all - keys_a) * h * d, BF16_FLOPS)
    plan = tpa.grouped_plan(q, k)
    log(f"  K10 bf16 [16, 32, 12, 64], {LANE_NAMES[lane]}, group sizes "
        f"{sizes}: page-block reads {reads} grouped vs {flat} per row (per "
        f"kv head); {key_a} {ms_a:.4f} ms (bound {bound_a[0]:.5f}, "
        f"{bound_a[1]}), {key_b} {ms_b:.4f} ms (bound {bound_b[0]:.5f}, "
        f"{bound_b[1]}), both {ms_both:.4f} ms vs {key6} {ms_k6:.4f} ms on "
        f"the same operands; plain (both phases) {plain_ms:.4f} ms, SDPA "
        f"(gathered, masked) {lib_ms:.4f} ms; ring {plan['stages']} stages, "
        f"{plan['tiles']} f32 tiles, {plan['smem']} bytes of shared memory; "
        f"grid {plan['grid']} blocks of {plan['threads']} threads, "
        f"{plan['rows']} rows a block, two a warp: {bool(plan['paired'])}")
    common = dict(route="cuda", path=path,
                  source="paddle_tpu_torch/ops/cuda/csrc/"
                         "grouped_paged_attention.cu",
                  plain_ms=plain_ms,
                  plain_timing="both phases, events around whole calls",
                  k10_ms=ms_both, k6_ms_same_operands=ms_k6,
                  page_block_reads={"grouped": reads, "per_row": flat},
                  launch=plan)
    return (dict(name=name_a,
                 replaces="paddle_tpu/ops/pallas/paged_attention.py:562",
                 max_abs_err=part_errs[torch.bfloat16, 12], ms=ms_a,
                 bound_ms=bound_a[0], bound_by=bound_a[1], library_ms=None,
                 max_abs_err_rep4=part_errs[torch.bfloat16, 16],
                 max_abs_err_llama7b_heads=part_errs[torch.bfloat16, 32],
                 **common),
            dict(name=name_b,
                 replaces="paddle_tpu/ops/pallas/paged_attention.py:663",
                 max_abs_err=errs[torch.bfloat16, 12], ms=ms_b,
                 bound_ms=bound_b[0], bound_by=bound_b[1], library_ms=lib_ms,
                 library_call="SDPA over the gathered, masked K/V: the "
                              "output of K10a and K10b together",
                 max_abs_err_rep4=errs[torch.bfloat16, 16],
                 max_abs_err_llama7b_heads=errs[torch.bfloat16, 32], **common))


# F10: (query heads over one kv head, head dim) whose 8 queries x rep rows
# pass a walk block's shared memory: rep 32 at head dim 128, and 71 heads
# of 64 (multi-query attention as Falcon-7B lays it out). K9 also at rep
# 128, head dim 256, where even one query's rows pass it
SPLIT_SHAPES = ((32, 128), (71, 64))
SPLIT_DECODE = SPLIT_SHAPES + ((128, 256),)


def check_split_walks(dev, tpa, time_ms) -> dict:
    """F10: K6, K7 and K10 (both phases) in every lane, bf16, on batches
    built like phase 3's grouped steps (16 rows of up to 32 queries, seven
    sharing 16 pages; `launch_check.grouped_batch`) at SPLIT_SHAPES:
    each plan must split an item's rows over blocks; K10's output must
    equal K6's (K7's) bit for bit, K10a's partials and K6's output match
    the plain versions (live queries); K6 and both K10 phases are timed.
    K9 in its fp and fp8 lanes on the legacy decode batch at
    SPLIT_DECODE: equal to K6 at q_len 1 bit for bit, within the rule of
    its plain version, timed. Returns {case: record}."""
    from paddle_tpu_torch.ops.cuda.launch_check import (
        decode, decode_batch, grouped_batch, lane_batch, ragged,
        ragged_reference)
    out = {}
    for h, d in SPLIT_SHAPES:
        base, grp = grouped_batch(dev, torch.bfloat16, h, 1, d, SEED)
        for lane in ("fp", "fp8", "q8"):
            ops, scales = lane_batch(base, lane)
            key6 = WALKS["K6", lane][0]
            tag = f"H={h} H_kv=1 D={d} bf16, {LANE_NAMES[lane]}"
            plan = tpa.ragged_plan(ops[0], ops[1])
            if plan["split"] < 2 or tpa.grouped_plan(ops[0], ops[1]) != plan:
                raise AssertionError(f"{tag}: the walks do not split "
                                     f"({plan})")
            args = tpa._grouped_check(*ops, *grp, **scales)
            part = tpa.grouped_phase1(*args, **scales)
            k10 = tpa.grouped_phase2(*args, part, **scales)
            k6 = ragged(ops, scales)
            torch.cuda.synchronize()
            if not torch.equal(k10, k6):
                raise AssertionError(f"K10 {tag} differs from {key6}")
            ref, (m, l, acc, written) = tpa.grouped_attention_reference(
                *ops, *grp, return_partials=True, **scales)
            sel = written & (m > tpa.NEG_INF / 2)
            part_err = max(
                check_close(f"K10a partial {n} {tag}", got[sel], want[sel])
                for n, got, want in zip(("m", "l", "acc"), part,
                                        (m, l, acc)))
            live = (torch.arange(k6.shape[1], device=dev)[None, :]
                    < ops[5][:, None])
            err = check_close(f"{key6} {tag}", k6,
                              ragged_reference(ops, scales), mask=live)
            del ref, m, l, acc
            rec = dict(split=plan["split"], rows=plan["rows"],
                       smem=plan["smem"], stages=plan["stages"],
                       max_abs_err=err, max_abs_err_partials=part_err,
                       k10_equals_k6=True,
                       ms=time_ms(lambda: ragged(ops, scales)),
                       k10a_ms=time_ms(lambda: tpa.grouped_phase1(
                           *args, **scales)),
                       k10b_ms=time_ms(lambda: tpa.grouped_phase2(
                           *args, part, **scales)))
            log(f"  F10 {tag}: rows split over {plan['split']} blocks of "
                f"<= {plan['rows']} rows ({plan['smem']} bytes, "
                f"{plan['stages']} ring stages); K10 = {key6} bit for bit; "
                f"{key6} {rec['ms']:.4f} ms, K10a {rec['k10a_ms']:.4f}, "
                f"K10b {rec['k10b_ms']:.4f}")
            out[f"{key6} H{h} D{d}"] = rec
    for h, d in SPLIT_DECODE:
        for lane in ("fp", "fp8"):
            ops, _ = lane_batch(decode_batch(dev, torch.bfloat16, h, 1, d,
                                             SEED), lane)
            key = "K9" if lane == "fp" else "K9-fp8"
            tag = f"H={h} H_kv=1 D={d} bf16, {LANE_NAMES[lane]}"
            plan = tpa.decode_plan(ops[0], ops[1])
            k9 = decode(ops)
            same = torch.equal(k9, ragged(ops, {}))
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"{key} {tag} differs from K6 at q_len 1")
            err = check_close(f"{key} {tag}", k9,
                              tpa.paged_attention_reference(*ops[:5]))
            rec = dict(split=plan["split"], rows=plan["rows"],
                       smem=plan["smem"], max_abs_err=err,
                       equals_k6_q_len_1=True,
                       ms=time_ms(lambda: decode(ops)))
            log(f"  F10 {key} {tag}: rows split over {plan['split']} "
                f"block(s); equals K6 at q_len 1 bit for bit; {rec['ms']:.4f}"
                " ms")
            out[f"{key} H{h} D{d}"] = rec
    return out


def ring_ptxas(text: str, kernel: str) -> list:
    """[(kernel, registers, spill store bytes)] of each instantiation of
    the walk (`ring_walk_kernel`) in the `-Xptxas -v` log of the library
    of `kernel` ("K6": ragged_paged_attention.cu, "K9":
    paged_decode_attention.cu, "K10": grouped_paged_attention.cu), named
    like `K10b<bf16, D 64, ps 16>` or `K6 masked<...>` (D and ps 0: the
    run-time instantiation of that DV, PJ)."""
    rows = []
    for name, regs, spill in ptxas_rows(text, "ring_walk_kernel"):
        k = re.search(r"ring_walk_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)ELb([01])ELb([01])E", name)
        dtype, dv, pj, d, ps, p1, masked = k.groups()
        shape = f"D {d}, ps {ps}" if d != "0" else f"DV {dv}, PJ {pj}"
        label = (("K10a" if p1 == "1" else "K10b") if kernel == "K10" else
                 kernel + (" masked" if masked == "1" else ""))
        rows.append((f"{label}<{DTYPE_NAMES.get(dtype, dtype)}, {shape}>",
                     regs, spill))
    return rows


def lora_ptxas(text: str) -> list:
    """[(kernel, registers, spill store bytes)] of each K11 instantiation
    in the `-Xptxas -v` log of lora_paged.cu, named like `K11<bf16, kU
    1, R16>` (kU: the warp tasks a thread carries, 4 where a group of t's
    ranks needs more than a warp's task; R16: ranks up to 16, the serving
    step's launch)."""
    return [(f"K11<{DTYPE_NAMES.get(m.group(1), m.group(1))}, kU "
             f"{m.group(2)}{', R16' if m.group(3) == '1' else ''}>", regs,
             spill)
            for name, regs, spill in ptxas_rows(text, "lora_paged_kernel")
            for m in [re.search(r"lora_paged_kernelI(\w+?)Lb[01]ELi(\d+)"
                                r"ELb([01])E", name)]]


def decode_bytes(q, k, table, pos, masked: bool) -> int:
    """What one K9 call needs to move: q in and out once, each row's live
    K/V pages (min(pos // ps, mp - 1) + 1 of them, every kv head), its
    table entries and pos, and, with a mask, the f32 mask entries of its
    live keys (every head)."""
    b, _, h, d = q.shape
    ps, hkv, mp = k.shape[1], k.shape[2], table.shape[1]
    pos_ = pos.cpu().numpy().astype(np.int64)
    pages = np.minimum(pos_ // ps, mp - 1) + 1
    n = (2 * b * h * d * q.element_size()
         + int(pages.sum()) * hkv * page_block_bytes(k)
         + int(pages.sum()) * 4 + b * 4)
    if masked:
        n += int(np.minimum(pos_ + 1, mp * ps).sum()) * h * 4
    return n


def check_paged_decode(dev, tpa, time_ms, lane="fp"):
    """K9 in pool lane `lane` (fp, or fp8 over e4m3 pools) on the legacy
    decode step's batch (`launch_check.decode_batch`: 16 rows, q
    [16, 1, 12, 64], pools [993, 16, 12, 64], table [16, 62], pos over
    65-763) in f32 and bf16, and again at rep 4, D 128 and at Llama-7B's
    32 heads of 128 (rep 1) in bf16: against
    its plain version without a mask, with a random additive f32 mask and
    with a bool mask that hides all but key 0; and without a mask against
    K6 (its fp8 lane) at q_len 1, bit for bit. Then the bf16 rep-1 batch
    is timed without and with the additive mask: the kernel, the plain
    version and SDPA over the gathered, masked view."""
    from paddle_tpu_torch.ops.cuda.launch_check import (decode, decode_batch,
                                                        lane_batch, ragged)
    key = "K9" if lane == "fp" else "K9-fp8"
    errs = {}
    for dtype, (h, hkv, d) in ((torch.float32, (12, 12, 64)),
                               (torch.bfloat16, (12, 12, 64)),
                               (torch.bfloat16, (16, 4, 128)),
                               (torch.bfloat16, (32, 32, 128))):
        ops, _ = lane_batch(decode_batch(dev, dtype, h, hkv, d, SEED), lane)
        q, k, v, table, pos, _ = ops
        b, lmax = q.shape[0], table.shape[1] * k.shape[1]
        g = torch.Generator(device=dev).manual_seed(SEED)
        hide = torch.zeros(b, 1, 1, lmax, dtype=torch.bool, device=dev)
        hide[..., 0] = True
        masks = {"no mask": None,
                 "additive mask": torch.randn(b, h, 1, lmax, generator=g,
                                              device=dev) * 2,
                 "bool mask (key 0 only)": hide}
        tag = f"H={h} H_kv={hkv} D={d} {dtype}, {LANE_NAMES[lane]}"
        for what, m in masks.items():
            out = decode(ops, m)
            torch.cuda.synchronize()
            add = None if m is None else tpa._mask_to_additive(m, b, h, lmax)
            err = check_close(f"{key} {what} {tag}", out,
                              tpa.paged_attention_reference(*ops[:5], add))
            errs[dtype, h, what] = err
        same = torch.equal(decode(ops), ragged(ops, {}))
        torch.cuda.synchronize()
        log(f"  {key} {tag}: equals K6{'-fp8' if lane != 'fp' else ''} at "
            f"q_len 1 bit for bit: {same}")
        if not same:
            raise AssertionError(f"{key} {tag} differs from K6 at q_len 1")
    ops, _ = lane_batch(decode_batch(dev, torch.bfloat16, 12, 12, 64, SEED),
                        lane)
    q, k, v, table, pos, _ = ops
    b, _, h, d = q.shape
    lmax = table.shape[1] * k.shape[1]
    mask = torch.randn(b, h, 1, lmax, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    ms = time_ms(lambda: decode(ops))
    masked_ms = time_ms(lambda: decode(ops, mask))
    plain_ms = time_ms(lambda: tpa.paged_attention_reference(*ops[:5]),
                       iters=5)
    lib_ms = time_ms(sdpa_yardstick(*ops))
    keys = attended_keys(pos.cpu().numpy(), np.ones(b, np.int64))
    bound_ms, bound_by = bound(decode_bytes(q, k, table, pos, False),
                               4 * keys * h * d, BF16_FLOPS)
    mbound_ms, mbound_by = bound(decode_bytes(q, k, table, pos, True),
                                 4 * keys * h * d + keys * h, BF16_FLOPS)
    plan = tpa.decode_plan(q, k)
    log(f"  {key} launch (with or without a mask): {plan}")
    log(f"  {key} bf16 [16, 1, 12, 64] over [993, 16, 12, 64], "
        f"{LANE_NAMES[lane]}: kernel {ms:.4f} ms (with the additive mask "
        f"{masked_ms:.4f} ms, bound {mbound_ms:.5f}), plain {plain_ms:.4f} "
        f"ms, SDPA (gathered, {'upconverted, ' if lane != 'fp' else ''}"
        f"masked) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(name=("K9 paged_decode_attention" if lane == "fp" else
                      "K9-fp8 paged_decode_attention (e4m3 pools)"),
                route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/"
                       "paged_decode_attention.cu",
                replaces="paddle_tpu/ops/pallas/paged_attention.py:243",
                path="serving_legacy" if lane == "fp" else
                     "serving_legacy_fp8",
                max_abs_err=errs[torch.bfloat16, 12, "no mask"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms,
                library_call="SDPA over the gathered, masked K/V",
                masked_ms=masked_ms, masked_bound_ms=mbound_ms,
                max_abs_err_masked=max(
                    e for (dt, hh, what), e in errs.items() if what !=
                    "no mask"),
                max_abs_err_rep4=errs[torch.bfloat16, 16, "no mask"],
                max_abs_err_llama7b_heads=errs[torch.bfloat16, 32, "no mask"],
                plan=plan)


def check_flash_serving(dev, tfa):
    """K3 at every shape the serving paths give it
    (`launch_check.FLASH_SERVING_CASES`): the legacy prefill chunks (Lq
    8, 16, 32 over the gathered 992 keys, the window as a broadcast
    [1, 1, Lq, 992] bias), the gather arm's unified step (q
    [16, 32, 12, 64], a per-row [16, 1, 32, 992] bias), generate()'s
    prefill ([8, 128] over 160, a broadcast bias) and its decode step (q
    [8, 1, 12, 64] over the dense [8, 160, 12, 64] cache, the window as
    an [8, 160] kvec); and the legacy and generate() cases again at
    Llama-7B's 32 heads of 128 (LLAMA_FLASH_CASES). Each through the
    model's SDPA, which must launch
    K3 once with the operand form named; f32 against the plain
    `_sdpa_ref` (the JAX package's form) by the f32 rule, bf16 against
    the plain `flash_attention_reference` on the same operand by the
    bf16 rule (`_sdpa_ref` rounds its probabilities to bf16), f16 by the
    same rule in f16 ulps, both with the tensor-core design's rounding
    allowance; bf16 FLASH_REPEATS times bit for bit. Returns each case's
    bf16 error (the Llama cases' keys end in ", 32 heads of 128")."""
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.nn.functional.attention import (
        _mask_to_kernel_operands, _sdpa_ref)
    from paddle_tpu_torch.ops.cuda.launch_check import (FLASH_SERVING_CASES,
                                                        flash_serving_batch)
    forms = {"gather arm step": ("bias", (16, 1, 32, 992)),
             "generate prefill": ("bias", (1, 1, 128, 160)),
             "generate decode": ("kvec", (8, 160))}
    errs = {}
    cases = [(case, 12, 64) for case in FLASH_SERVING_CASES] + [
        (case, 32, 128) for case in LLAMA_FLASH_CASES]
    for case, h, d in cases:
        b, lq, lk, _ = FLASH_SERVING_CASES[case]
        want_form = forms.get(case, ("bias", (1, 1, lq, lk)))
        name = case if h == 12 else f"{case}, {h} heads of {d}"
        for dtype in FLASH_DTYPES:
            q, k, v, mask = flash_serving_batch(dev, dtype, case, SEED, h=h,
                                                d=d)
            form, operand = _mask_to_kernel_operands(mask, b, h, lq, lk)
            if (form, tuple(operand.shape)) != want_form:
                raise AssertionError(f"K3 {case}: the mask took {form} "
                                     f"{tuple(operand.shape)}, not "
                                     f"{want_form}")
            before = tfa.LAUNCHES["fwd"]
            out = PF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  training=False)
            torch.cuda.synchronize()
            if tfa.LAUNCHES["fwd"] != before + 1:
                raise AssertionError(f"K3 {case}: the SDPA did not launch "
                                     "K3")
            tag = (f"K3 {case} [{b}, {lq}, {h}, {d}] over {lk} keys, "
                   f"{form} {tuple(operand.shape)}, {dtype}")
            if dtype == torch.float32:
                check_close(f"{tag} vs _sdpa_ref", out, _sdpa_ref(
                    q, k, v, mask, False, d ** -0.5, 0.0, None))
                continue
            err = check_close(
                f"{tag} vs flash_attention_reference", out,
                tfa.flash_attention_reference(q, k, v, **{form: operand})[0],
                extra=tfa.fwd_rounding_allowance(q, k, v, **{form: operand}),
                extra_rule=ROUNDING_RULE.format("P_eff", "P_eff . V / l"))
            if dtype == torch.bfloat16:
                errs[name] = err
                same_bits(f"K3 {name} {dtype}",
                          lambda: tfa.flash_attention_fwd(
                              q, k, v, **{form: operand}))
    return errs


def check_paged_scatter(dev, tpa, time_ms):
    """K8 (into e4m3 pools, and in its float lane into bf16 and f32
    pools) and K8-q8 (into int8 + scale pools) at the serving step's
    write, at Llama-7B's heads and then GPT-124M's: the [16, 32, 32, 128]
    and [16, 32, 12, 64] bf16 K rows of `ragged_batch`'s q, at its
    positions and tables (tokens past a row's window go to the trash
    page), and again at 300x the scale, with about 13 % of the values
    then beyond +-448. The pools' bytes must equal the plain versions'
    bit for bit outside page 0 (the float lane's plain version is the
    unfused write, `index_copy_`). K8 and K8-q8 then write K and V (a
    second update of the same shape) in one launch, in every lane, and
    each pool must equal a single launch's and the plain version's bytes
    (K8-q8's pair also over 20 reruns). Then the kernels, the plain
    versions and, for K8, one `index_copy_` of the converted bytes to the
    same slots are timed, and the pairs beside two `index_copy_`s (K8)
    and their bounds."""
    errs = {"K8": 0.0, "K8-q8": 0.0}
    fl_err = 0.0
    # GPT-124M's write, then Llama-7B's (32 kv heads of 128); the timing
    # below runs at GPT-124M's
    for h, d in ((32, 128), (12, 64)):
        q, k, _, table, pos, _ = ragged_batch(dev, torch.bfloat16, h, h, SEED,
                                             d=d)
        v_upd = ragged_batch(dev, torch.bfloat16, h, h, SEED + 1,
                             d=d)[0]
        shape = k.shape
        fp8_zeros = lambda: torch.zeros(shape, dtype=torch.uint8,
                                        device=dev).view(tpa.FP8_DTYPE)
        q8_zeros = lambda: (torch.zeros(shape, dtype=torch.int8, device=dev),
                            torch.zeros(shape[:3], device=dev))
        for mult in (1.0, 300.0):
            upd = (q.float() * mult).to(torch.bfloat16)
            got8 = tpa.paged_scatter(fp8_zeros(), upd, pos, table)
            codes, scales = tpa.paged_scatter_q8(*q8_zeros(), upd, pos,
                                                 table)
            torch.cuda.synchronize()
            want8 = tpa.paged_scatter_reference(fp8_zeros(), upd, pos, table)
            wantc, wants = tpa.paged_scatter_q8_reference(*q8_zeros(), upd,
                                                          pos, table)
            same = {
                "K8": torch.equal(got8.view(torch.uint8)[1:],
                                  want8.view(torch.uint8)[1:]),
                "K8-q8": torch.equal(codes[1:], wantc[1:]) and torch.equal(
                    scales[1:].view(torch.int32),
                    wants[1:].view(torch.int32))}
            errs["K8"] = max(errs["K8"], (got8[1:].float()
                                          - want8[1:].float()).abs().max()
                             .item())
            errs["K8-q8"] = max(errs["K8-q8"], (codes[1:].float() - wantc[1:]
                                                ).abs().max().item(),
                                (scales[1:] - wants[1:]).abs().max().item())
            finite = bool(torch.isfinite(got8.float()).all()
                          and torch.isfinite(scales).all())
            beyond = (upd.float().abs() > tpa.FP8_MAX).float().mean().item()
            log(f"  K8 / K8-q8 bf16 {list(upd.shape)} x{mult:g} "
                f"({beyond:.3f} of the values beyond +-448): bit for bit "
                f"outside page 0 "
                f"{same}; every written value finite: {finite}")
            if not all(same.values()) or not finite:
                raise AssertionError("K8 / K8-q8 disagree with their plain "
                                     "versions")
            # K8-q8's pair: K and V in one launch, equal to the single
            # writes
            v_mult = (v_upd.float() * mult).to(torch.bfloat16)
            before = tpa.QUANT_LAUNCHES["K8-q8"]
            pair = tpa.paged_scatter_q8_pair(*q8_zeros()[:1], *q8_zeros()[:1],
                                             *q8_zeros()[1:], *q8_zeros()[1:],
                                             upd, v_mult, pos, table)
            torch.cuda.synchronize()
            one_v = tpa.paged_scatter_q8(*q8_zeros(), v_mult, pos, table)
            torch.cuda.synchronize()
            pair_same = tpa.QUANT_LAUNCHES["K8-q8"] == before + 2 and all(
                torch.equal(a[1:].view(torch.uint8),
                            b[1:].view(torch.uint8))
                for a, b in zip(pair, (codes, one_v[0], scales, one_v[1])))
            log(f"  K8-q8 pair bf16 K and V {list(upd.shape)} x{mult:g} in "
                f"one launch: equal to two single launches (and so to the "
                f"plain version) bit for bit outside page 0: {pair_same}")
            if not pair_same:
                raise AssertionError("K8-q8's pair disagrees")
            same_bits(f"K8-q8 pair {list(upd.shape)} x{mult:g}",
                      lambda: [t[1:] for t in tpa.paged_scatter_q8_pair(
                          *q8_zeros()[:1], *q8_zeros()[:1], *q8_zeros()[1:],
                          *q8_zeros()[1:], upd, v_mult, pos, table)])
        for pool_dtype in (torch.bfloat16, torch.float32):
            got = tpa.paged_scatter_kernel(torch.zeros(
                shape, dtype=pool_dtype, device=dev), q, pos, table)
            torch.cuda.synchronize()
            want = tpa.paged_scatter_reference(torch.zeros(
                shape, dtype=pool_dtype, device=dev), q, pos, table)
            same = torch.equal(got[1:], want[1:])
            fl_err = max(fl_err, (got[1:].float() - want[1:].float()).abs()
                         .max().item())
            log(f"  K8 float lane bf16 {list(q.shape)} -> {pool_dtype} "
                f"pool: equal to index_copy_ bit for bit outside page 0: "
                f"{same}")
            if not same:
                raise AssertionError("K8's float lane disagrees with "
                                     "index_copy_")
        zeros = {"e4m3": fp8_zeros,
                 "bf16": lambda: torch.zeros(shape, dtype=torch.bfloat16,
                                             device=dev),
                 "f32": lambda: torch.zeros(shape, device=dev)}
        bits = lambda t: t.view(torch.uint8) if t.dtype == tpa.FP8_DTYPE else t
        for lane, mk in zeros.items():
            before = (tpa.QUANT_LAUNCHES["K8"], tpa.MEGA_LAUNCHES["K8-float"])
            pair = tpa.paged_scatter_kernel_pair(mk(), mk(), q, v_upd, pos,
                                                 table)
            torch.cuda.synchronize()
            launched = (tpa.QUANT_LAUNCHES["K8"] - before[0],
                        tpa.MEGA_LAUNCHES["K8-float"] - before[1])
            same = launched == ((1, 0) if lane == "e4m3" else (0, 1))
            for got, upd in zip(pair, (q, v_upd)):
                one = tpa.paged_scatter_kernel(mk(), upd, pos, table)
                want = tpa.paged_scatter_reference(mk(), upd, pos, table)
                same = same and torch.equal(bits(got)[1:], bits(one)[1:]) and \
                    torch.equal(bits(got)[1:], bits(want)[1:])
            log(f"  K8 pair bf16 K and V {list(q.shape)} -> {lane} pools in "
                f"one launch: equal to two single launches and the plain "
                f"version bit for bit outside page 0: {same}")
            if not same:
                raise AssertionError(f"K8's pair ({lane}) disagrees")
    upd = q
    pool8, (pc, ps_) = fp8_zeros(), q8_zeros()
    poolf = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    msf = time_ms(lambda: tpa.paged_scatter_kernel(poolf, upd, pos, table))
    plainf = time_ms(lambda: tpa.paged_scatter_reference(poolf, upd, pos,
                                                         table), iters=5)
    ms8 = time_ms(lambda: tpa.paged_scatter(pool8, upd, pos, table))
    msq = time_ms(lambda: tpa.paged_scatter_q8(pc, ps_, upd, pos, table))
    # the plain writes enqueue ~3 ms of small launches each: few calls,
    # so the enqueue stays inside the timer's sleep
    plain8 = time_ms(lambda: tpa.paged_scatter_reference(pool8, upd, pos,
                                                         table), iters=5)
    plainq = time_ms(lambda: tpa.paged_scatter_q8_reference(pc, ps_, upd,
                                                            pos, table),
                     iters=5)
    flat = tpa._paged_flat_slots(shape[1], pos, table, upd.shape[1]
                                 ).reshape(-1)
    rows = upd.float().clamp(-tpa.FP8_MAX, tpa.FP8_MAX).to(
        tpa.FP8_DTYPE).view(torch.uint8).reshape(-1, *shape[2:])
    dst = pool8.view(torch.uint8).view(-1, *shape[2:])
    lib8 = time_ms(lambda: dst.index_copy_(0, flat, rows))
    rowsf = upd.reshape(-1, *shape[2:])
    dstf = poolf.view(-1, *shape[2:])
    libf = time_ms(lambda: dstf.index_copy_(0, flat, rowsf))
    # the pair: K and V in one launch, beside two index_copy_ calls
    pool8v, poolfv = fp8_zeros(), torch.zeros_like(poolf)
    pair8 = time_ms(lambda: tpa.paged_scatter_kernel_pair(
        pool8, pool8v, upd, v_upd, pos, table))
    pairf = time_ms(lambda: tpa.paged_scatter_kernel_pair(
        poolf, poolfv, upd, v_upd, pos, table))
    rows8v = v_upd.float().clamp(-tpa.FP8_MAX, tpa.FP8_MAX).to(
        tpa.FP8_DTYPE).view(torch.uint8).reshape(-1, *shape[2:])
    dst8v = pool8v.view(torch.uint8).view(-1, *shape[2:])
    rowsfv = v_upd.reshape(-1, *shape[2:])
    dstfv = poolfv.view(-1, *shape[2:])
    lib8x2 = time_ms(lambda: (dst.index_copy_(0, flat, rows),
                              dst8v.index_copy_(0, flat, rows8v)))
    pcv, psv = q8_zeros()
    pairq = time_ms(lambda: tpa.paged_scatter_q8_pair(pc, pcv, ps_, psv, upd,
                                                      v_upd, pos, table))
    libfx2 = time_ms(lambda: (dstf.index_copy_(0, flat, rowsf),
                              dstfv.index_copy_(0, flat, rowsfv)))
    n = upd.numel()
    # upd read once, the pools written once; the tables and positions
    io = table.numel() * 4 + pos.numel() * 4
    b8 = bound(n * upd.element_size() + n + io, 4 * n, F32_FLOPS)
    bq = bound(n * upd.element_size() + n + n // shape[3] * 4 + io, 6 * n,
               F32_FLOPS)
    bf = bound(2 * n * upd.element_size() + io, n, F32_FLOPS)
    b8x2 = bound(2 * (n * upd.element_size() + n) + io, 8 * n, F32_FLOPS)
    bfx2 = bound(4 * n * upd.element_size() + io, 2 * n, F32_FLOPS)
    bqx2 = bound(2 * (n * upd.element_size() + n + n // shape[3] * 4) + io,
                 12 * n, F32_FLOPS)
    log(f"  K8 pair bf16 K and V {list(upd.shape)}: -> e4m3 {pair8:.4f} ms "
        f"(two index_copy_ {lib8x2:.4f} ms, bound {b8x2[0]:.5f}), -> bf16 "
        f"{pairf:.4f} ms (two index_copy_ {libfx2:.4f} ms, bound "
        f"{bfx2[0]:.5f}); K8-q8 pair -> int8 + scales {pairq:.4f} ms (bound "
        f"{bqx2[0]:.5f})")
    log(f"  K8 bf16 {list(upd.shape)} -> e4m3: kernel {ms8:.4f} ms, plain "
        f"{plain8:.4f} ms, index_copy_ of the converted bytes {lib8:.4f} "
        f"ms, bound {b8[0]:.5f} ms ({b8[1]}); K8-q8 -> int8 + scales: "
        f"kernel {msq:.4f} ms, plain {plainq:.4f} ms, bound {bq[0]:.5f} ms "
        f"({bq[1]}); K8 float lane -> bf16: kernel {msf:.4f} ms, plain "
        f"{plainf:.4f} ms, index_copy_ {libf:.4f} ms, bound {bf[0]:.5f} ms "
        f"({bf[1]})")
    common = dict(route="cuda",
                  source="paddle_tpu_torch/ops/cuda/csrc/paged_scatter.cu")
    return (dict(name="K8 paged_scatter (e4m3 pools)", path="serving_fp8",
                 max_abs_err=errs["K8"],
                 replaces="paddle_tpu/ops/pallas/paged_attention.py:1294",
                 ms=ms8, plain_ms=plain8, bound_ms=b8[0], bound_by=b8[1],
                 library_ms=lib8,
                 library_call="index_copy_ of the converted e4m3 bytes to "
                              "the same slots",
                 pair=dict(ms=pair8, library_ms=lib8x2, bound_ms=b8x2[0],
                           bound_by=b8x2[1],
                           library_call="two index_copy_ calls (K, V)"),
                 **common),
            dict(name="K8-q8 paged_scatter_q8", path="serving_int8",
                 max_abs_err=errs["K8-q8"],
                 replaces="paddle_tpu/ops/pallas/paged_attention.py:1343",
                 ms=msq, plain_ms=plainq, bound_ms=bq[0], bound_by=bq[1],
                 library_ms=None,
                 pair=dict(ms=pairq, bound_ms=bqx2[0], bound_by=bqx2[1],
                           library_ms=None),
                 **common),
            dict(name="K8-float paged_scatter_kernel (float pools)",
                 path="serving_megakernel", max_abs_err=fl_err,
                 replaces="paddle_tpu/ops/pallas/paged_attention.py:1328",
                 ms=msf, plain_ms=plainf, bound_ms=bf[0], bound_by=bf[1],
                 library_ms=libf,
                 library_call="index_copy_ of the rows to the same slots",
                 pair=dict(ms=pairf, library_ms=libfx2, bound_ms=bfx2[0],
                           bound_by=bfx2[1],
                           library_call="two index_copy_ calls (K, V)"),
                 **common))


def check_lora_paged(dev, tpa, time_ms):
    """K11 at the serving step's shapes (`launch_check.lora_batch`): x
    [16, 32, 768] (the layer input of a unified step), adapter pools of 9
    pages at rank 8 (page 0 the zero page), every row at its own page
    (rows on page 0 or at scale 0 must give exactly 0), in f32 (the f32
    rule), bf16 and f16 — where t = x . A is rounded to the dtype between
    the products, so a t element whose f32 sums (kernel and plain add in
    other orders) straddle a rounding point moves by one ulp: the rule
    adds that ulp carried through B and the scale to the element's 2
    ulps. 20 repeats give the same bits. The launch (`lora_plan`:
    cluster, slices, grid) is recorded. Timed in bf16: the kernel, the
    plain version (gather + `lora_delta`) and two `torch.bmm` over the
    gathered pages."""
    from paddle_tpu_torch.ops.cuda.launch_check import lora_batch
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x, A, B, apage, ascale = lora_batch(dev, dtype, seed=SEED + 3)
        b, w, hid = x.shape
        r = A.shape[2]
        out = tpa.lora_delta_paged(x, A, B, apage, ascale)
        torch.cuda.synchronize()
        errs[dtype] = lora_within_rule(
            tpa, f"K11 lora_delta_paged [{b}, {w}, {hid}] rank {r} {dtype}",
            out, x, A, B, apage, ascale)
        same_bits(f"K11 {dtype}", lambda: (tpa.lora_delta_paged(
            x, A, B, apage, ascale),))
    x, A, B, apage, ascale = lora_batch(dev, torch.bfloat16, seed=SEED + 3)
    b, w, hid = x.shape
    r = A.shape[2]
    plan = tpa.lora_plan(x, A, B)
    ms = time_ms(lambda: tpa.lora_delta_paged(x, A, B, apage, ascale))
    plain_ms = time_ms(lambda: tpa.lora_delta_paged_reference(
        x, A, B, apage, ascale))
    Ag, Bg = A[apage.long()], B[apage.long()]
    lib_ms = time_ms(lambda: torch.bmm(torch.bmm(x, Ag), Bg))
    item = x.element_size()
    pages = len(set(apage.tolist()))
    n_bytes = (2 * x.numel() * item + pages * 2 * hid * r * item
               + apage.numel() * 4 + ascale.numel() * 4)
    bound_ms, bound_by = bound(n_bytes, 2 * b * w * r * 2 * hid, BF16_FLOPS)
    log(f"  K11 bf16 [{b}, {w}, {hid}] rank {r}, {pages} pages: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, two torch.bmm over the "
        f"gathered pages {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}); launch {plan}")
    return dict(name="K11 lora_delta_paged", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/lora_paged.cu",
                replaces="paddle_tpu/ops/pallas/paged_attention.py:1465",
                path="serving_adapters_megakernel",
                max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library_call="torch.bmm(torch.bmm(x, A[apage]), B[apage])",
                max_abs_err_f32=errs[torch.float32],
                max_abs_err_f16=errs[torch.float16], plan=plan,
                ranks={rk: check_lora_rank(dev, tpa, time_ms, rk)
                       for rk in LORA_LARGE_RANKS},
                llama_shapes=check_lora_llama(dev, tpa, time_ms))


def check_lora_llama(dev, tpa, time_ms) -> dict:
    """K11 at phase 8's adapter shapes, rank 8: x [16, 32, 4096] into
    4096 columns (Llama-7B's q, k, v and o deltas) and into 1024 (the
    k and v deltas of the GQA arm's 8 kv heads of 128), in f32, bf16 and
    f16 under the rank-8 rule (`lora_within_rule`), 20 repeats
    bit-identical; timed in bf16 beside its plain version. Returns each
    shape's errors, times and launch."""
    from paddle_tpu_torch.ops.cuda.launch_check import lora_batch
    out = {}
    for cout in (4096, 1024):
        shape = f"[16, 32, 4096] -> {cout}"
        errs = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            args = lora_batch(dev, dtype, seed=SEED + 3, cin=4096, cout=cout)
            got = tpa.lora_delta_paged(*args)
            torch.cuda.synchronize()
            errs[str(dtype)] = lora_within_rule(
                tpa, f"K11 lora_delta_paged {shape} rank 8 {dtype}", got,
                *args)
            same_bits(f"K11 {shape} {dtype}",
                      lambda: (tpa.lora_delta_paged(*args),))
        args = lora_batch(dev, torch.bfloat16, seed=SEED + 3, cin=4096,
                          cout=cout)
        ms = time_ms(lambda: tpa.lora_delta_paged(*args))
        plain_ms = time_ms(lambda: tpa.lora_delta_paged_reference(*args))
        plan = tpa.lora_plan(*args[:3])
        log(f"  K11 bf16 {shape} rank 8: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; launch {plan}")
        out[shape] = dict(max_abs_err=errs, ms=ms, plain_ms=plain_ms,
                          plan=plan)
    return out


def check_lora_rank(dev, tpa, time_ms, r: int) -> dict:
    """K11 at rank `r` over 16 (t summed a group of ranks at a time, d
    over R in k-steps of 16) at the serving step's shapes, in f32, bf16
    and f16, under the rank-8 rule (`lora_within_rule`), base-page rows
    exactly 0, 20 repeats bit-identical; timed in bf16 beside its plain
    version and two `torch.bmm` over the gathered pages. Returns its
    numbers and launch."""
    from paddle_tpu_torch.ops.cuda.launch_check import lora_batch
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        args = lora_batch(dev, dtype, seed=SEED + 3, r=r)
        out = tpa.lora_delta_paged(*args)
        torch.cuda.synchronize()
        errs[str(dtype)] = lora_within_rule(
            tpa, f"K11 lora_delta_paged [16, 32, 768] rank {r} {dtype}",
            out, *args)
        same_bits(f"K11 rank {r} {dtype}",
                  lambda: (tpa.lora_delta_paged(*args),))
    x, A, B, apage, ascale = lora_batch(dev, torch.bfloat16, seed=SEED + 3,
                                        r=r)
    b, w, hid = x.shape
    plan = tpa.lora_plan(x, A, B)
    ms = time_ms(lambda: tpa.lora_delta_paged(x, A, B, apage, ascale))
    plain_ms = time_ms(lambda: tpa.lora_delta_paged_reference(
        x, A, B, apage, ascale))
    Ag, Bg = A[apage.long()], B[apage.long()]
    lib_ms = time_ms(lambda: torch.bmm(torch.bmm(x, Ag), Bg))
    item = x.element_size()
    pages = len(set(apage.tolist()))
    bound_ms, bound_by = bound(
        2 * x.numel() * item + pages * 2 * hid * r * item + b * 8,
        2 * b * w * r * 2 * hid, BF16_FLOPS)
    log(f"  K11 bf16 [{b}, {w}, {hid}] rank {r}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, two torch.bmm {lib_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}); launch {plan}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=errs,
                plan=plan)


def lora_within_rule(tpa, tag, out, x, A, B, apage, ascale) -> float:
    """K11's rule (`check_lora_paged`'s): base-page and zero-scale rows
    exactly 0; f32 within the f32 rule, bf16/f16 within 2 ulps plus one
    ulp of t carried through B and the scale. Returns the max error."""
    zero = (apage == 0) | (ascale == 0)
    if out[zero].any():
        raise AssertionError(f"{tag}: a base-page or zero-scale row is not "
                             "exactly 0")
    ref = tpa.lora_delta_paged_reference(x, A, B, apage, ascale)
    if out.dtype == torch.float32:
        return check_close(tag, out, ref)
    ap = apage.long()
    t = torch.bmm(x.float(), A[ap].float()).to(out.dtype).float()
    s = ascale.to(out.dtype).float()[:, None, None]
    flip = torch.bmm(bf16_ulp(t, out.dtype), B[ap].float().abs()) * s
    return check_close(tag, out, ref, extra=flip,
                       extra_rule="+ one ulp of t through B and the scale")


# K12's shapes in phase 2, the first the record's: a megakernel step's
# 16 slots, one row, 16 slots x a verify width of 8, GPT-2's vocabulary
# (rows off a 16-byte boundary) and Llama 3's, and `spec_verify_accept`'s
# [16 slots x 32 columns, V] at GPT-124M's and Llama-7B's vocabularies
# (phase 10's megakernel arm)
ARGMAX_SHAPES = ((16, 50304), (1, 50304), (128, 50304), (16, 50257),
                 (16, 128256), (512, 50304), (512, 32000))


def argmax_rows(logits, tpa):
    """Write K12's hard rows into logits [B, V]: a maximum tied
    three ways, NaNs in two of the row's cluster slices (the later slice's
    first), an all -inf row, a row of equal values, -0.0 before 0.0 as
    the maximum, and a tie across the border of slices 0 and 1 of
    `_argmax_slices` at the row's own offset from a 16-byte boundary (the
    last element of slice 0 and the first of 1; in row 0 alone where
    B < 8)."""
    b, v = logits.shape
    s, _ = tpa._argmax_plan(b, v, torch.cuda.get_device_properties(
        logits.device).multi_processor_count)

    def slices(r):
        return tpa._argmax_slices(v, s, logits[r].data_ptr() // 4 % 4)

    def border(r):
        sl = slices(r)
        return sl[1][1][0][0] if s > 1 and sl[1][1] else v // 2

    if b < 8:
        logits[0, [border(0) - 1, border(0)]] = 11.0
        return logits
    last = slices(2)[-1][1]
    logits[1, [7, v // 3, v - 1]] = 9.0
    logits[2, [last[-1][0] if last else v - 1, 777]] = float("nan")
    logits[3] = float("-inf")
    logits[4] = 0.5
    logits[5] = -1.0
    logits[5, [v // 2, v // 2 + 1]] = torch.tensor([-0.0, 0.0],
                                                   device=logits.device)
    logits[6, [border(6) - 1, border(6)]] = 11.0
    logits[7, [border(7), v - 1]] = float("nan")
    return logits


def check_greedy_argmax(dev, tpa, time_ms):
    """K12 at ARGMAX_SHAPES on random f32 logits with `argmax_rows`' rows,
    and on a view whose rows start one element past a 16-byte boundary:
    equal to `torch.argmax` bit for bit, and the same over 20 repeats.
    Timed at each shape: the kernel, its plain version (`torch.argmax`
    then the int32 cast), `torch.argmax` and a launch that does nothing
    (`torch.cuda._sleep(0)`, the floor of a small kernel); K12's launch
    (`_argmax_plan`: blocks a row, threads a block) recorded."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    shapes = {}
    for b, v in ARGMAX_SHAPES:
        base = torch.randn(b, v, generator=g, device=dev)
        logits = argmax_rows(base.clone(), tpa)
        # the same random values one element past a 16-byte boundary, the
        # hard rows placed at that view's slice borders
        flat = torch.empty(b * v + 4, device=dev)
        shifted = argmax_rows(flat[1:1 + b * v].view(b, v).copy_(base), tpa)
        for tag, x in (("", logits), (" offset by one element", shifted)):
            got = tpa.decode_greedy_argmax(x)
            torch.cuda.synchronize()
            want = torch.argmax(x, dim=-1)
            same = torch.equal(got.long(), want) and got.dtype == torch.int32
            repeat = all(torch.equal(tpa.decode_greedy_argmax(x), got)
                         for _ in range(20))
            log(f"  K12 decode_greedy_argmax [{b}, {v}] f32{tag} (ties, "
                f"NaNs, -inf, equal, +-0 and slice-border rows): equal to "
                f"torch.argmax bit for bit {same}, {got[1:8].tolist()}; 20 "
                f"repeats identical {repeat}")
            if not (same and repeat):
                raise AssertionError(
                    f"K12 disagrees with torch.argmax at [{b}, {v}]{tag}")
        ms = time_ms(lambda: tpa.decode_greedy_argmax(logits))
        plain_ms = time_ms(
            lambda: torch.argmax(logits, dim=-1).to(torch.int32))
        lib_ms = time_ms(lambda: torch.argmax(logits, dim=-1))
        bound_ms, bound_by = bound(logits.numel() * 4 + b * 4,
                                   logits.numel(), F32_FLOPS)
        s, threads = tpa._argmax_plan(b, v, sms)
        log(f"  K12 [{b}, {v}]: {s} blocks a row x {threads} threads; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.argmax "
            f"{lib_ms:.4f} ms, an empty launch {floor_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        shapes[f"[{b}, {v}]"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, blocks_a_row=s, threads=threads)
    rec = shapes[f"[{ARGMAX_SHAPES[0][0]}, {ARGMAX_SHAPES[0][1]}]"]
    return dict(name="K12 decode_greedy_argmax", route="cuda",
                source="paddle_tpu_torch/ops/cuda/csrc/greedy_argmax.cu",
                replaces="paddle_tpu/ops/pallas/paged_attention.py:1586",
                path="serving_megakernel", max_abs_err=0.0,
                ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                library_ms=rec["library_ms"],
                library_call="torch.argmax(dim=-1)",
                empty_launch_ms=floor_ms, shapes=shapes)


def check_paged_attention_masked(dev, tpa, time_ms):
    """The user-mask lane of K6 and K7 on the serving batches of
    `ragged_batch` — f32 rep 1, bf16 rep 2 and rep 1 — with an additive
    N(0, 1) mask [B, H, lq, lmax] and a bool mask hiding 30 % of the keys
    (key 0 always kept), against the plain versions with the same
    mask (live queries). Then the bf16 rep-1 batch with the additive
    mask is timed in each lane: the kernel, the plain version, and SDPA
    over the gathered view with the mask added to the window; the bound
    counts the mask's f32 values of the live (query, key) pairs. Returns
    {"K6": ..., "K7": ...}: the masked lane's numbers, kept in those
    kernels' records (the engine passes no mask, so no serving path
    launches the lane)."""
    from paddle_tpu_torch.ops.cuda.launch_check import (lane_batch, ragged,
                                                        ragged_reference)
    out_recs = {}
    for lane, key in (("fp", "K6"), ("q8", "K7")):
        errs = {}
        for dtype, (h, hkv) in ((torch.float32, (12, 12)),
                                (torch.bfloat16, (12, 6)),
                                (torch.bfloat16, (12, 12))):
            ops, scales = lane_batch(ragged_batch(dev, dtype, h, hkv, SEED),
                                     lane)
            q, k, _, table, pos, q_len = ops
            b, lq = q.shape[:2]
            lmax = table.shape[1] * k.shape[1]
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            add = torch.randn(b, h, lq, lmax, generator=g, device=dev)
            keep = torch.rand(b, 1, 1, lmax, generator=g, device=dev) < 0.7
            keep[..., 0] = True
            live = (torch.arange(lq, device=dev)[None, :] < q_len[:, None])
            for name, m in (("additive", add), ("bool", keep)):
                got = ragged(ops, scales, mask=m)
                torch.cuda.synchronize()
                ref = ragged_reference(ops, scales, mask=tpa._mask_to_additive(
                    m, b, h, lmax, lq))
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{key} masked wrote a non-finite "
                                         "value")
                errs[dtype, name, h // hkv] = check_close(
                    f"{key} masked ({name}) H={h} H_kv={hkv} {dtype}", got,
                    ref, mask=live)
        # the bf16 rep-1 batch with the additive mask
        ms = time_ms(lambda: ragged(ops, scales, mask=add))
        plain_ms = time_ms(lambda: ragged_reference(
            ops, scales, mask=add), iters=5)
        lib_ms = time_ms(sdpa_yardstick(*ops, **scales, mask=add))
        ql, ps_ = q_len.cpu().numpy(), pos.cpu().numpy()
        flat, _, _ = tpa.count_page_block_reads(
            table.cpu().numpy(), ps_, ql, page_size=k.shape[1])
        keys = attended_keys(ps_, ql)
        n_bytes = (2 * int(ql.sum()) * h * q.shape[3] * q.element_size()
                   + flat * k.shape[2] * page_block_bytes(k, scales)
                   + keys * h * 4 + table.numel() * 4 + 2 * b * 4)
        bound_ms, bound_by = bound(n_bytes, 4 * keys * h * q.shape[3],
                                   BF16_FLOPS)
        log(f"  {key} masked bf16 [16, 32, 12, 64], {LANE_NAMES[lane]}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (gathered, "
            f"masked) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        out_recs[key] = dict(
            max_abs_err=max(e for (dt, _, _), e in errs.items()
                            if dt == torch.bfloat16),
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by)
    return out_recs


# -- phase 3: serve GPT-124M -------------------------------------------------
def make_traffic(vocab: int = GPT124M["vocab_size"]):
    """24 prompts of 32-700 tokens over a vocabulary of `vocab`. A third
    of them — the first and the
    last seven — are one shared 256-token system prompt, a shared 4-token
    separator, then their own text. The first has the shortest prompt of
    the first 16 admitted (the others have 300-700), so it finishes first
    and the last seven, still queued, attach its cached prompt pages and
    copy-on-write the page holding the separator."""
    rs = np.random.RandomState(SEED)
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


def launch_counts_serving(tln, tpa, tfa) -> dict:
    return {"K1": tln.LAUNCHES, "K3": tfa.LAUNCHES["fwd"],
            "K6": tpa.LAUNCHES, "K10a": tpa.GROUPED_LAUNCHES["phase1"],
            "K10b": tpa.GROUPED_LAUNCHES["phase2"], **tpa.QUANT_LAUNCHES,
            **tpa.DECODE_LAUNCHES, **tpa.MEGA_LAUNCHES}


# the serving step's launches per layer by KV dtype: the write (K8 or
# K8-q8, K and V in one launch; a float pool's write is index_copy_), and
# the
# walk with the defaults (K10's two phases) or with grouped=False (K6)
LANE_OF = {"fp": "fp", "fp8": "fp8", "int8": "q8"}
WRITE_OF = {"fp": None, "fp8": "K8", "int8": "K8-q8"}


# the legacy decode step's walk per layer by KV dtype: K9 in its lanes,
# and K7 at q_len 1 over int8 pools
DECODE_WALK_OF = {"fp": "K9", "fp8": "K9-fp8", "int8": "K7"}


def _no_launches(tpa) -> dict:
    return dict.fromkeys(["K1", "K3", "K6", "K10a", "K10b",
                          *tpa.QUANT_LAUNCHES, *tpa.DECODE_LAUNCHES,
                          *tpa.MEGA_LAUNCHES], 0)


def norm_launches(model) -> int:
    """K1 launches of one forward: GPT's 2L + 1 LayerNorms; none for
    Llama, whose RMSNorm is plain torch (jnp in the JAX package)."""
    cfg = model.config
    return 2 * cfg.num_hidden_layers + 1 if hasattr(model, "gpt") else 0


def per_step_launches(tpa, grouped: bool, kv_dtype: str,
                      attn_impl: str = "kernel", megakernel: bool = False,
                      adapters: bool = False, n_layers: int =
                      GPT124M["num_hidden_layers"],
                      k1: int = 2 * GPT124M["num_hidden_layers"] + 1
                      ) -> dict:
    """One unified step's launches: K1 `k1` (GPT's 2L + 1, Llama's 0);
    the walk per layer (K10's
    two phases, or K6, in the pools' lane), or K3 per layer under the
    gather arm; the lane's write per layer (K8 or K8-q8 once for K and
    V) — a float pool's unfused write is index_copy_, under the
    megakernel K8's float lane. Under the megakernel, K12 once a step and, with
    adapters, K11 four times a layer (the q, k and v prologue and the
    o-delta; in Llama the four standalone deltas); without it the
    adapters' deltas are library products."""
    want = _no_launches(tpa)
    want["K1"] = k1
    lane = LANE_OF[kv_dtype]
    if attn_impl == "gather":
        want["K3"] = n_layers
    else:
        for walk in (("K10a", "K10b") if grouped else ("K6",)):
            want[WALKS[walk, lane][0]] = n_layers
    write = WRITE_OF[kv_dtype] or ("K8-float" if megakernel else None)
    if write:
        want[write] = n_layers
    if megakernel:
        want["K12"] = 1
        if adapters:
            want["K11"] = 4 * n_layers
    return want


def legacy_launches(tpa, kv_dtype: str,
                    n_layers: int = GPT124M["num_hidden_layers"],
                    k1: int = 2 * GPT124M["num_hidden_layers"] + 1):
    """The legacy step's launches (per decode step, per prefill chunk):
    K1 `k1` in each; the decode step's walk (K9, K9-fp8 or K7) and a
    chunk's K3 per layer; the lane's write for K and V per layer in
    each."""
    per_decode, per_chunk = _no_launches(tpa), _no_launches(tpa)
    for want in (per_decode, per_chunk):
        want["K1"] = k1
        if WRITE_OF[kv_dtype]:
            want[WRITE_OF[kv_dtype]] = n_layers
    per_decode[DECODE_WALK_OF[kv_dtype]] = n_layers
    per_chunk["K3"] = n_layers
    return per_decode, per_chunk


def snap_cpu(t):
    """A CPU copy of a tensor (None stays None; e4m3 moves as bytes)."""
    if t is None:
        return None
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).to("cpu", copy=True).view(t.dtype)
    return t.to("cpu", copy=True)


def serve(dev, tln, tpa, model, grouped: bool, record: bool = False,
          profile: bool = False, kv_dtype: str = "fp", unified: bool = True,
          attn_impl: str = "kernel", megakernel: bool = False,
          adapter_pages=None, adapter_ranks=(2, 4, 8), page_size=None,
          token_budget=None, label: str = ""):
    """One run of phase 3's traffic on a fresh engine: the defaults
    (grouped walk, preemption, host tier) or grouped=False, over pools of
    `kv_dtype`; or the legacy alternating step (unified=False), or the
    gather arm (attn_impl="gather"), where the grouped walk drops; with
    the decode megakernel (`megakernel`); with `adapter_pages` set, the
    LORA adapters registered in an adapter pool of that many pages (rank
    buckets `adapter_ranks`, the pool's rank their largest) and the
    requests spread over the tenants of `adapter_traffic`; with
    `page_size`, pages of that many keys in place of ENGINE's; with
    `token_budget`, at most that many tokens packed a step, the engine's
    `debug_state()` read after DEBUG_STEP steps and its metrics rendered
    by `prometheus_render`. The traffic, the adapters and the launches
    follow the model (GPT or Llama: its depth, vocabulary and norms);
    `label` names the model in the log. A recorded step is rerun plain
    (`rerun_recorded`, `rerun_recorded_legacy`). Returns the launches,
    the stats and every request's tokens."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                          legacy_forward, unified_forward)
    from paddle_tpu_torch.serving.metrics import prometheus_render

    # a step rerun on the card keeps its snapshot there (a copy of
    # Llama-7B's pools is 8.3 GB: through the host it costs seconds)
    keep = ((lambda t: None if t is None else t.clone())
            if reference_on_card(model) else snap_cpu)
    snap = lambda t: (tuple(map(snap, t)) if isinstance(t, tuple)
                      else keep(t))

    class RecordingEngine(ServingEngine):
        """Keeps the inputs and held logits of unified step, or legacy
        decode step, RECORD_STEP."""
        recorded = None
        decodes = 0

        def _forward(self, *args):
            if not record or self.metrics.unified_steps != RECORD_STEP:
                return super()._forward(*args)
            before = ([snap(a) for a in args],
                      [snap(layer) for layer in self._pools],
                      snap(self._last_logits))
            out = super()._forward(*args)
            self.recorded = before + (out.cpu(),)
            return out

        def _decode_forward(self, *args):
            self.decodes += 1
            if not record or self.decodes != RECORD_STEP + 1:
                return super()._decode_forward(*args)
            before = ([snap(a) for a in args],
                      [snap(layer) for layer in self._pools])
            out = super()._decode_forward(*args)
            self.recorded = before + (out.cpu(),)
            return out

    adapters = adapter_pages is not None
    if unified:
        arm = (f"{kv_dtype} {'defaults' if grouped else 'grouped=False'}"
               f"{', gather' if attn_impl == 'gather' else ''}"
               f"{', megakernel' if megakernel else ''}"
               f"{f', adapters ({adapter_pages} pages)' if adapters else ''}"
               f"{f', rank buckets {adapter_ranks}' if adapters else ''}"
               f"{f', pages of {page_size}' if page_size else ''}"
               f"{f', token_budget {token_budget}' if token_budget else ''}")
    else:
        arm = f"{kv_dtype} legacy"
    arm = f"{label} {arm}" if label else arm
    cfg = model.config
    n_layers, k1 = cfg.num_hidden_layers, norm_launches(model)
    extra = {}
    if megakernel:
        extra["megakernel"] = True
    if adapters:
        extra.update(adapters=True, adapter_pages=adapter_pages,
                     adapter_ranks=adapter_ranks)
    if token_budget:
        extra["token_budget"] = token_budget
    eng = RecordingEngine(model, device=dev, seed=SEED,
                          **({} if grouped else {"grouped": False}),
                          **({} if kv_dtype == "fp" else
                             {"kv_dtype": kv_dtype}),
                          **({} if unified else {"unified": False}),
                          **({} if attn_impl == "kernel" else
                             {"attn_impl": attn_impl}), **extra,
                          **{**ENGINE, **({"page_size": page_size}
                                          if page_size else {})})
    want_gates = (grouped and unified and attn_impl == "kernel", True,
                  kv_dtype, unified, attn_impl, megakernel, adapters)
    if (eng.grouped, eng.preempt, eng.kv_dtype, eng.unified,
            eng.attn_impl, eng.megakernel,
            eng.adapters is not None) != want_gates:
        raise AssertionError(f"engine gates {eng.grouped, eng.preempt}, "
                             f"kv_dtype {eng.kv_dtype}, unified "
                             f"{eng.unified}, attn_impl {eng.attn_impl}, "
                             f"megakernel {eng.megakernel}, adapters "
                             f"{eng.adapters is not None}")
    prompts = make_traffic(cfg.vocab_size)
    tenants = [0] * len(prompts)
    if adapters:
        loras, tenants = adapter_traffic(cfg)
        ids = [eng.adapters.register(f"tenant{i}", w)
               for i, w in enumerate(loras)]
        if ids != list(range(1, len(loras) + 1)):
            raise AssertionError(f"adapter ids {ids}")
    t0 = time.perf_counter()
    reset_counts(tln, tfa, tpa)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS,
                                              adapter_id=a))
            for p, a in zip(prompts, tenants)]
    debug = None
    while eng.has_work:
        eng.step()
        if token_budget and debug is None and \
                eng.metrics.unified_steps == DEBUG_STEP:
            debug = eng.debug_state()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts_serving(tln, tpa, tfa)
    snap = eng.metrics.snapshot()
    steps = (eng.metrics.unified_steps if unified
             else snap["decode_step_s"]["count"])
    chunks = snap["prefill_chunks"]
    step_s = snap["step_s" if unified else "decode_step_s"]
    log(f"  [{arm}] served {len(reqs)} requests in {steps} "
        f"{'steps' if unified else 'decode steps and ' + str(chunks)}"
        f"{'' if unified else ' prefill chunks'}, "
        f"{wall:.3f} s: {snap['tokens_generated']} tokens, "
        f"{snap['tokens_per_sec']:.1f} tokens/s; "
        f"{'step' if unified else 'decode step'} p50 "
        f"{step_s['p50'] * 1e3:.3f} ms, p90 "
        f"{step_s['p90'] * 1e3:.3f} ms; TTFT p50 "
        f"{snap['ttft_s']['p50'] * 1e3:.1f} ms, p90 "
        f"{snap['ttft_s']['p90'] * 1e3:.1f} ms")
    pc = eng.prefix_cache.stats()
    sizes = snap["group_size_per_step"]
    log(f"  [{arm}] prefix cache: {pc['hits']} hits of {pc['lookups']}, "
        f"{pc['cached_tokens']} cached tokens, {pc['cow_copies']} COW "
        f"copies; modeled page-block reads {snap['page_block_reads_total']}"
        f" (per kv head and layer, summed over steps), "
        f"{snap['shared_page_reads_saved_total']} saved by the grouped "
        f"walk; sharing groups in {sizes['count']} step(s), largest "
        f"{sizes['max']}")
    if unified:
        per_step = per_step_launches(tpa, grouped, kv_dtype, attn_impl,
                                     megakernel, adapters, n_layers, k1)
        want = {k: n * steps for k, n in per_step.items()}
        log(f"  [{arm}] launches: "
            f"{ {k: n for k, n in launches.items() if n} } (per step "
            f"{ {k: n for k, n in per_step.items() if n} })")
    else:
        per_step, per_chunk = legacy_launches(tpa, kv_dtype, n_layers, k1)
        want = {k: n * steps + per_chunk[k] * chunks
                for k, n in per_step.items()}
        buckets = sorted(eng.prefill_buckets)
        allowed = {ENGINE["chunk_len"]} | {
            8 * 2 ** i for i in range(8) if 8 * 2 ** i <= ENGINE["chunk_len"]}
        log(f"  [{arm}] launches: "
            f"{ {k: n for k, n in launches.items() if n} } (per decode step "
            f"{ {k: n for k, n in per_step.items() if n} }, per prefill "
            f"chunk { {k: n for k, n in per_chunk.items() if n} }); prefill "
            f"buckets run {buckets}; host time to issue a prefill chunk "
            f"p50 {snap['prefill_chunk_s']['p50'] * 1e3:.3f} ms, p90 "
            f"{snap['prefill_chunk_s']['p90'] * 1e3:.3f} ms")
        if not set(buckets) <= allowed:
            raise AssertionError(f"prefill buckets {buckets} outside "
                                 f"{sorted(allowed)}")
    if any(r.finish_reason != "length" or len(r.output_tokens) != NEW_TOKENS
           for r in reqs):
        raise AssertionError("a request did not finish with its 64 tokens")
    if any(not 0 <= t < cfg.vocab_size
           for r in reqs for t in r.output_tokens):
        raise AssertionError("a token id outside the vocabulary")
    if launches != want or steps == 0:
        raise AssertionError(f"kernel launches {launches} != {want}")
    # with adapters the prefix cache keeps a namespace per tenant, so the
    # shared prompt is shared only among requests of one tenant
    if not adapters and (pc["hits"] < 1 or pc["cow_copies"] < 1):
        raise AssertionError("the traffic did not exercise attach and COW")
    if eng.grouped and not adapters and not (sizes["max"] or 0) >= 2:
        raise AssertionError("no step formed a group of two or more rows")
    eng.pool.assert_quiesced()
    stats = {"tokens_per_s": snap["tokens_per_sec"],
             "step_ms_p50": step_s["p50"] * 1e3,
             "step_ms_p90": step_s["p90"] * 1e3,
             "ttft_ms_p50": snap["ttft_s"]["p50"] * 1e3,
             "ttft_ms_p90": snap["ttft_s"]["p90"] * 1e3,
             "steps": steps, "wall_s": wall,
             "page_block_reads": snap["page_block_reads_total"],
             "page_reads_saved": snap["shared_page_reads_saved_total"],
             "largest_group": sizes["max"], "page_bytes": eng.page_bytes}
    if token_budget:
        packed = snap["packed_tokens_per_step"]["max"]
        text = prometheus_render({"r0": snap})
        info = [ln for ln in text.splitlines()
                if ln.startswith("paddle_serving_engine_info")]
        log(f"  [{arm}] packed tokens a step: at most {packed}; "
            f"debug_state() after {DEBUG_STEP} steps: step "
            f"{debug['step'] if debug else None}, "
            f"{len(debug['residents']) if debug else 0} residents, queue "
            f"depth {debug['queue']['depth'] if debug else None}, config "
            f"token_budget {debug['config']['token_budget'] if debug else None}"
            f"; prometheus_render: {len(text.splitlines())} lines, {info}")
        if packed is None or packed > token_budget:
            raise AssertionError(f"a step packed {packed} tokens, over the "
                                 f"budget of {token_budget}")
        if (debug is None or not debug["residents"]
                or debug["config"]["token_budget"] != token_budget):
            raise AssertionError(f"debug_state() mid-run: {debug}")
        if len(info) != 1 or 'kv_dtype="fp"' not in info[0]:
            raise AssertionError(f"engine_info series: {info}")
        stats.update(packed_max=packed, prometheus_lines=len(
            text.splitlines()), debug_residents=len(debug["residents"]))
    if adapters:
        stats["adapter_pool"] = eng.adapters.stats()
        log(f"  [{arm}] adapter pool: {stats['adapter_pool']}; requests by "
            f"adapter {snap['adapters']['requests_by_adapter']}")
        eng.adapters.assert_quiesced()
    if not unified:
        pcs = snap["prefill_chunk_s"]
        stats.update(prefill_chunks=chunks,
                     prefill_buckets=sorted(eng.prefill_buckets),
                     prefill_chunk_host_ms_p50=pcs["p50"] * 1e3,
                     prefill_chunk_host_ms_p90=pcs["p90"] * 1e3)
    if record and unified:
        stats["held"] = rerun_recorded(eng, model, unified_forward)
    elif record:
        stats["held"] = rerun_recorded_legacy(eng, model, legacy_forward)
    if profile and hasattr(model, "llama"):
        # three shared-prefix prompts and one other, 8 new tokens each:
        # at Llama's 32 layers the trace's processing outlasts the steps
        stats["profile"] = profile_steps(eng, prompts[:2] + prompts[17:19],
                                         new=8)
    elif profile:
        # the eight shared-prefix prompts and eight others, so that the
        # profiled steps form sharing groups
        stats["profile"] = profile_steps(eng, prompts[:8] + prompts[16:])
    return launches, stats, [list(r.output_tokens) for r in reqs]


def f32_copy_on_card(model):
    """An f32 copy of `model` on its device (built there, then loaded:
    a model too large for the host's f32 copy)."""
    plain = type(model)(model.config, device=model.device,
                        dtype=torch.float32, seed=SEED).eval()
    plain.load_state_dict(model.state_dict())
    return plain


def reference_on_card(model) -> bool:
    """Where a held step's plain f32 rerun runs. On the CPU for a model
    whose f32 copy the CPU runs in seconds (GPT-124M): a witness that
    shares no device, library or code path with the card. On the card,
    under `plain_serving`, past CPU_RERUN_MAX_PARAMS (Llama-7B, whose
    27 GB f32 copy through 32 layers the CPU would take minutes to run
    a step of), where the reruns of `held_on_card` hold it."""
    return sum(p.numel() for p in model.parameters()) > CPU_RERUN_MAX_PARAMS


def held_on_card(tag, model, held, live, pools, run) -> dict:
    """Hold a recorded step's logits `held` [S, V] (rows `live`) against
    reruns of the step on the card, each over fresh copies of its
    recorded `pools` (snapshots on the card, emptied once the last copy
    is made: the f32 copy of the model needs the room), through `run(m,
    move, pools, kernels)` (`move` puts a recorded tensor on the card in
    m's dtype; `kernels`: the engine's own routing, else the plain route
    `plain_serving` patches): the f32 copy through the plain versions,
    the reference (held logits within LLAMA_HELD_LOGITS_TOL); the bf16
    model through the plain versions, the bf16 floor (the held logits
    no farther from it than BF16_FLOOR_RATIO times its own mean
    distance from the reference: `bf16_floor_check`); the f32 copy
    through the kernels (LLAMA_F32_HELD_TOL). A planted fault, the plain
    bf16 rerun with every query's window one key short, is read against
    both checks and reported, not gated."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.ops.cuda import layer_norm as tln
    from paddle_tpu_torch.ops.cuda import paged_attention as tpa
    dev = model.device

    def mover(f32):
        return lambda t: (None if t is None else t.to(dev).float()
                          if f32 and t.dtype == torch.bfloat16
                          else t.to(dev, copy=True))

    def on_card(f32):
        return [tuple(map(mover(f32), layer)) for layer in pools]

    def plain(m, copies, fault=False):
        before = launch_counts_serving(tln, tpa, tfa)
        with plain_serving(short_window=fault):
            out = run(m, mover(m.dtype == torch.float32), copies, False)
        if launch_counts_serving(tln, tpa, tfa) != before:
            raise AssertionError(f"{tag}: the plain rerun launched a kernel")
        return out[live]

    with torch.no_grad():
        bf16 = plain(model, on_card(False))
        fault = plain(model, on_card(False), fault=True)
        # both f32 reruns over one copy: each layer writes its K/V before
        # it attends, so each reads the same pages
        copies = on_card(True)
        pools.clear()
        torch.cuda.empty_cache()
        f32_model = f32_copy_on_card(model)
        kernel32 = run(f32_model, mover(True), copies, True)[live]
        ref = plain(f32_model, copies)
        del f32_model, copies
        torch.cuda.empty_cache()
    held = held[live]
    dist = lambda a, b: (a - b).abs().max().item()
    out = {"max_abs_err": dist(held, ref),
           "argmax_agreement": (held.argmax(-1) == ref.argmax(-1)).float()
           .mean().item(),
           "f32_kernels_max_abs_err": dist(kernel32, ref),
           **bf16_floor_check(tag, {"held": held}, bf16, ref,
                              {"planted_fault": fault})}
    log(f"  {tag}: held logits vs the plain f32 rerun on the card "
        f"max_abs_err={out['max_abs_err']:.4f} (tolerance "
        f"{LLAMA_HELD_LOGITS_TOL}), argmax agreement "
        f"{out['argmax_agreement']:.3f}; the f32 model through the kernels "
        f"vs the plain f32 rerun {out['f32_kernels_max_abs_err']:.6f} "
        f"(tolerance {LLAMA_F32_HELD_TOL})")
    if not torch.isfinite(held).all() or \
            out["max_abs_err"] > LLAMA_HELD_LOGITS_TOL:
        raise AssertionError(f"{tag}: held logits disagree with the plain "
                             "rerun")
    if not torch.isfinite(kernel32).all() or \
            out["f32_kernels_max_abs_err"] > LLAMA_F32_HELD_TOL:
        raise AssertionError(f"{tag}: the f32 kernel path disagrees with "
                             "the plain rerun")
    return out


def bf16_floor_check(tag, got: dict, bf16, ref, controls=None) -> dict:
    """Hold each of `got`'s logits against `bf16`, the bf16 model's plain
    rerun of the same tokens: its mean |difference| at most
    BF16_FLOOR_RATIO times the bf16 floor, the mean |bf16 - ref| (`ref`
    the plain f32 rerun). Each of `controls` (a planted fault) is read
    the same way and against `ref`, and reported, not gated. Returns the
    floor, each one's mean and max |difference| from `bf16` (and the
    controls' from `ref`) and its ratio to the floor."""
    mean = lambda a, b: (a - b).abs().mean().item()
    dist = lambda a, b: (a - b).abs().max().item()
    floor = mean(bf16, ref)
    out = {"bf16_floor": {"mean_abs": floor, "max_abs": dist(bf16, ref)}}
    for name, t in {**got, **(controls or {})}.items():
        out[name + "_vs_plain_bf16"] = {
            "mean_abs": mean(t, bf16), "max_abs": dist(t, bf16),
            "ratio": mean(t, bf16) / floor}
    for name, t in (controls or {}).items():
        out[name + "_vs_plain_f32_max_abs"] = dist(t, ref)
    log(f"  {tag}: vs the plain bf16 rerun, mean |difference| over the "
        f"bf16 floor (plain bf16 vs plain f32: mean "
        f"{floor:.6f}, max {out['bf16_floor']['max_abs']:.4f}): " + ", ".join(
            f"{name} {out[name + '_vs_plain_bf16']['ratio']:.3f} (max "
            f"{out[name + '_vs_plain_bf16']['max_abs']:.4f})"
            for name in {**got, **(controls or {})})
        + f" (at most {BF16_FLOOR_RATIO})" + "".join(
            f"; {name} (not gated) vs the plain f32 rerun max "
            f"{out[name + '_vs_plain_f32_max_abs']:.4f}"
            for name in controls or {}))
    for name in got:
        if not out[name + "_vs_plain_bf16"]["ratio"] <= BF16_FLOOR_RATIO:
            raise AssertionError(f"{tag}: {name} logits farther from the "
                                 "plain bf16 rerun than bf16 rounding goes")
    return out


def f32_cpu_copy(model):
    """The model's f32 copy on the CPU, made at its first held rerun and
    kept while the model lives (phase 3's arms rerun the same model)."""
    plain = _F32_CPU.get(model)
    if plain is None:
        plain = _F32_CPU[model] = copy.deepcopy(model).float().cpu()
    return plain


def rerun_recorded(eng, model, unified_forward) -> dict:
    """Rerun the recorded step through the plain versions in f32 and hold
    its logits against the card's: on the CPU, or past
    CPU_RERUN_MAX_PARAMS on the card (`reference_on_card`,
    `held_on_card`). The plain rerun takes the paged walk's plain
    version whatever the engine's `attn_impl`, and the adapters' gathered
    pairs (the unfused path) whatever its megakernel gate, so the gather
    arm's step (K3 over the gathered view), the grouped walk's and the
    megakernel's are held against an independent reference. On the CPU
    the rerun walks the pages ungrouped: the grouped plain version, a
    Python loop over pages, gives the same logits up to f32 rounding in
    more than twice the time."""
    if eng.recorded is None:
        raise AssertionError(f"step {RECORD_STEP} never ran")
    (toks, pos, table, q_len, is_decode, group, lora), pools, last, held = \
        eng.recorded
    eng.recorded = None
    live = (q_len > 0).cpu()
    arm = (eng.kv_dtype + (", gather" if eng.attn_impl == "gather" else "")
           + (", megakernel" if eng.megakernel else "")
           + (", adapters" if eng.adapters is not None else ""))
    tag = (f"[{arm}] step {RECORD_STEP} ({int(q_len.sum())} tokens, "
           f"{int(live.sum())} live rows, grouped walk "
           f"{'on' if eng.grouped else 'off'})")

    def run(m, move, pools, grouped):
        # int8 codes, their scales and e4m3 pools move as they are: every
        # rerun reads the same quantized pages
        lo = None if lora is None else (
            tuple(tuple(map(move, layer)) for layer in lora[0]),
            *map(move, lora[1:]))
        grp = tuple(map(move, group)) if grouped and group is not None \
            else None
        return unified_forward(m, pools, *map(move, (
            toks, pos, table, q_len, is_decode, last)), grp, lora=lo).cpu()

    if reference_on_card(model):
        return held_on_card(tag, model, held, live, pools, run)
    move = lambda t: (None if t is None else t.float()
                      if t.dtype == torch.bfloat16 else t)
    t0 = time.perf_counter()
    with torch.no_grad():
        plain = run(f32_cpu_copy(model), move,
                    [tuple(map(move, layer)) for layer in pools], False)
    secs = time.perf_counter() - t0
    err = (held[live] - plain[live]).abs().max().item()
    agree = (held[live].argmax(-1) == plain[live].argmax(-1)).float().mean()
    log(f"  {tag}: held logits vs plain f32 rerun on the CPU (pages walked "
        f"ungrouped) max_abs_err={err:.4f} (tolerance {HELD_LOGITS_TOL}), "
        f"argmax agreement {agree.item():.3f}; {secs:.2f} s")
    if not torch.isfinite(held).all() or err > HELD_LOGITS_TOL:
        raise AssertionError("held logits disagree with the plain rerun")
    return {"max_abs_err": err, "argmax_agreement": agree.item(),
            "seconds": secs}


def rerun_recorded_legacy(eng, model, legacy_forward) -> dict:
    """Rerun the recorded legacy decode step through the plain versions
    in f32 over the same pools and hold its logits against the card's,
    on the rows that decoded (a table row not all trash): on the CPU, or
    past CPU_RERUN_MAX_PARAMS on the card (`held_on_card`)."""
    if eng.recorded is None:
        raise AssertionError(f"decode step {RECORD_STEP} never ran")
    (toks, pos, table), pools, held = eng.recorded
    eng.recorded = None
    live = (table != 0).any(1).cpu()
    tag = (f"[{eng.kv_dtype} legacy] decode step {RECORD_STEP} "
           f"({int(live.sum())} decoding rows of {toks.shape[0]})")

    def run(m, move, pools, kernels):
        t = move(toks)
        return legacy_forward(m, pools, t, move(pos), move(table),
                              torch.zeros(t.shape[0], dtype=torch.int64,
                                          device=t.device),
                              eng.attn_impl).cpu()

    if reference_on_card(model):
        return held_on_card(tag, model, held, live, pools, run)
    move = lambda t: (None if t is None else t.float()
                      if t.dtype == torch.bfloat16 else t)
    t0 = time.perf_counter()
    with torch.no_grad():
        plain = run(f32_cpu_copy(model), move,
                    [tuple(map(move, layer)) for layer in pools], False)
    secs = time.perf_counter() - t0
    err = (held[live] - plain[live]).abs().max().item()
    agree = (held[live].argmax(-1) == plain[live].argmax(-1)).float().mean()
    log(f"  {tag}: held logits vs plain f32 rerun max_abs_err={err:.4f} "
        f"(tolerance {HELD_LOGITS_TOL}), argmax agreement "
        f"{agree.item():.3f}; {secs:.2f} s")
    if not torch.isfinite(held).all() or err > HELD_LOGITS_TOL:
        raise AssertionError("legacy held logits disagree with the plain "
                             "rerun")
    return {"max_abs_err": err, "argmax_agreement": agree.item(),
            "seconds": secs}


def abort_loaded(dev, model) -> dict:
    """`abort_all()` on a loaded engine (phase 3's traffic at the
    defaults, stepped until a resident has emitted a token: residents
    mid-prefill and decoding, a queue behind them): every request
    retires "aborted" without another step, keeping its tokens, the pool
    and the host tier end quiesced, and the engine refuses new
    requests."""
    from paddle_tpu_torch.serving import (EngineClosed, SamplingParams,
                                          ServingEngine)
    eng = ServingEngine(model, device=dev, seed=SEED, **ENGINE)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS))
            for p in make_traffic()]
    while not any(r.output_tokens for r in reqs):
        eng.step()
    state = eng.debug_state()
    steps = eng.metrics.unified_steps
    emitted = [list(r.output_tokens) for r in reqs]
    outs = eng.abort_all()
    torch.cuda.synchronize()
    try:
        eng.add_request(make_traffic()[0])
        refused = False
    except EngineClosed:
        refused = True
    ok = (len(outs) == len(reqs) and refused
          and eng.metrics.unified_steps == steps
          and all(r.finish_reason == "aborted" for r in reqs)
          and [r.output_tokens for r in reqs] == emitted
          and eng.pool.free_pages + eng.pool.cached_pages
          == eng.num_pages - 1 and eng.pool.swapped_pages == 0
          and eng.host_pool.used_pages == 0)
    out = {"steps": steps, "residents": len(state["residents"]),
           "queued": state["queue"]["depth"],
           "pages_used_before": state["pool"]["pages_used"],
           "emitted_before": sum(len(r.output_tokens) for r in reqs),
           "retired": len(outs), "quiesced": ok}
    log(f"  abort_all() on a loaded engine: {json.dumps(out)}")
    if not ok or not state["residents"]:
        raise AssertionError("abort_all() left work or pages behind")
    return out


def serving(dev, tln, tpa):
    """Phase 3's four runs, defaults / grouped=False / grouped=False /
    defaults, on one model: launches of the first run of each arm (its
    path), their stats, and the tokens of all four, which must agree;
    then the defaults at a token budget of 64 (its own path) and
    `abort_all()` on a loaded engine."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                           dtype=torch.bfloat16, seed=SEED).eval()
    on, on_stats, on_tokens = serve(dev, tln, tpa, model, True, record=True,
                                    profile=True)
    off, off_stats, off_tokens = serve(dev, tln, tpa, model, False,
                                       profile=True)
    _, off2, off2_tokens = serve(dev, tln, tpa, model, False)
    _, on2, on2_tokens = serve(dev, tln, tpa, model, True)
    same = on_tokens == off_tokens == off2_tokens == on2_tokens
    log(f"  tokens of the four runs identical: {same}; tokens/s defaults "
        f"{on_stats['tokens_per_s']:.1f}, {on2['tokens_per_s']:.1f}; "
        f"grouped=False {off_stats['tokens_per_s']:.1f}, "
        f"{off2['tokens_per_s']:.1f}")
    if not same:
        raise AssertionError("grouped and ungrouped runs gave other tokens")
    budget, budget_stats, budget_tokens = serve(dev, tln, tpa, model, True,
                                                token_budget=TOKEN_BUDGET)
    pairs = [(a, b) for got, w in zip(budget_tokens, on_tokens)
             for a, b in zip(got, w)]
    budget_stats["agreement_with_defaults"] = sum(
        a == b for a, b in pairs) / len(pairs)
    budget_stats["abort_all"] = abort_loaded(dev, model)
    log(f"  [token_budget {TOKEN_BUDGET}] tokens equal to the defaults "
        f"arm's at {budget_stats['agreement_with_defaults']:.4f} of "
        f"positions (other packings batch the GEMMs differently)")
    # pages of 256 keys: the walks fold each page in two pieces of 128
    big, big_stats, big_tokens = serve(dev, tln, tpa, model, True,
                                       record=True, page_size=256)
    pairs = [(a, b) for got, w in zip(big_tokens, on_tokens)
             for a, b in zip(got, w)]
    big_stats["agreement_with_page_16"] = sum(
        a == b for a, b in pairs) / len(pairs)
    log(f"  [page 256] tokens equal to the page-16 defaults arm's at "
        f"{big_stats['agreement_with_page_16']:.4f} of positions")
    return ({"serving": on, "serving_ungrouped": off,
             "serving_page256": big, "serving_budget64": budget},
            {"defaults": [on_stats, on2], "grouped_off": [off_stats, off2],
             "page_256": big_stats, "token_budget": budget_stats},
            model, on_tokens)


def serving_quantized(dev, tln, tpa, model, fp_tokens, fp_stats) -> tuple:
    """Phase 3's quantized runs on the same model and traffic: for int8
    and fp8 KV, the defaults (with a recorded step rerun plain over the
    same quantized pools, and a profile) and grouped=False, whose tokens
    must be identical. Checks that a page costs 68/128 (int8) and 64/128
    (fp8) of a bf16 page; prints, without gating, the share of greedy
    tokens equal to the bf16 arm's (random weights leave small margins),
    tokens/s and the device's busy share. Returns the launches of each
    run (its path) and the stats."""
    by_path, stats, tokens = {}, {}, {}
    ratios = {"int8": (68, 128), "fp8": (64, 128)}
    for kv in ("int8", "fp8"):
        on, on_stats, on_tokens = serve(dev, tln, tpa, model, True,
                                        record=True, profile=True,
                                        kv_dtype=kv)
        off, off_stats, off_tokens = serve(dev, tln, tpa, model, False,
                                           kv_dtype=kv)
        name = "int8" if kv == "int8" else "fp8"
        by_path[f"serving_{name}"] = on
        by_path[f"serving_{name}_ungrouped"] = off
        pairs = [(a, b) for got, want in zip(on_tokens, fp_tokens)
                 for a, b in zip(got, want)]
        agree = sum(a == b for a, b in pairs) / len(pairs)
        whole = sum(got == want for got, want in zip(on_tokens, fp_tokens))
        ratio = on_stats["page_bytes"] / fp_stats["page_bytes"]
        num, den = ratios[kv]
        log(f"  [{kv}] defaults and grouped=False tokens identical: "
            f"{on_tokens == off_tokens}; tokens equal to the bf16 arm's at "
            f"{agree:.4f} of positions, {whole} of {len(fp_tokens)} requests "
            f"whole; tokens/s {on_stats['tokens_per_s']:.1f} (defaults), "
            f"{off_stats['tokens_per_s']:.1f} (grouped=False); page bytes "
            f"{on_stats['page_bytes']} vs bf16 {fp_stats['page_bytes']} "
            f"({ratio:.4f}, want {num}/{den}); device busy "
            f"{on_stats['profile']['device_busy_share']}")
        if on_tokens != off_tokens:
            raise AssertionError(f"{kv}: grouped and ungrouped runs gave "
                                 "other tokens")
        if on_stats["page_bytes"] * den != fp_stats["page_bytes"] * num:
            raise AssertionError(f"{kv}: page bytes {on_stats['page_bytes']}"
                                 f" are not {num}/{den} of bf16's")
        stats[kv] = {"defaults": on_stats, "grouped_off": off_stats,
                     "agreement_with_bf16": agree,
                     "requests_equal_to_bf16": whole,
                     "page_bytes_ratio": ratio}
        tokens[kv] = on_tokens
    return by_path, stats, tokens


def adapter_traffic(cfg):
    """The LORA adapters for the model of config `cfg` (`make_random_lora`
    from numpy seed 0, drawn in order; q out H * D, k and v out H_kv * D)
    and phase 3's requests' tenants: the first four one per adapter, the
    rest zipf over {base, 1..4} (weight 1/(i+1)), numpy seed 0 —
    scripts/serving_bench.py's `lora_trace` rule."""
    from paddle_tpu_torch.serving import make_random_lora
    k, h = LORA["adapters"], cfg.hidden_size
    kv_out = h // cfg.num_attention_heads * getattr(
        cfg, "num_key_value_heads", cfg.num_attention_heads)
    rng = np.random.RandomState(SEED)
    loras = [make_random_lora(cfg.num_hidden_layers, h, h, kv_out,
                              rank=LORA["rank"], rng=rng, amp=LORA["amp"])
             for _ in range(k)]
    zipf = np.array([1.0 / (i + 1) for i in range(k + 1)])
    zipf /= zipf.sum()
    trs = np.random.RandomState(SEED)
    tenants = [1 + i % k if i < k else int(trs.choice(k + 1, p=zipf))
               for i in range(N_REQUESTS)]
    return loras, tenants


def serving_megakernel(dev, tln, tpa, model, fp_tokens, int8_tokens) -> tuple:
    """Phase 3's megakernel and adapter arms on the same model and
    traffic, at the default engine geometry: the megakernel on, no
    adapters, over bf16 and over int8 pools, each run twice in turns
    with a gate-off run, whose tokens must all equal the megakernel-off
    defaults arms' (K8's float write equals index_copy_, K12 equals
    torch.argmax, bit for bit); the LORA adapters with the
    megakernel off and on (a recorded step's held logits against a plain
    f32 rerun each; the share of equal tokens printed, not checked);
    adapters and the megakernel with 2 adapter pages (the pool spills,
    evicts and restores: checked), and over int8 pools. Every arm checks
    its exact launches per step. Returns the launches of each run (its
    path) and the stats."""
    by_path, stats = {}, {}
    # the gate-off and gate-on arms in turns after the defaults arms
    # (off, on, off, on): host time varies between runs of one call
    runs = (("serving_megakernel", "fp", fp_tokens,
             dict(megakernel=True, profile=True)),
            ("serving_megakernel_off_again", "fp", fp_tokens, dict()),
            ("serving_megakernel_again", "fp", fp_tokens,
             dict(megakernel=True)),
            ("serving_int8_megakernel", "int8", int8_tokens,
             dict(megakernel=True, kv_dtype="int8")),
            ("serving_int8_megakernel_off_again", "int8", int8_tokens,
             dict(kv_dtype="int8")),
            ("serving_int8_megakernel_again", "int8", int8_tokens,
             dict(megakernel=True, kv_dtype="int8")),
            ("serving_adapters", "fp", None,
             dict(adapter_pages=8, record=True)),
            ("serving_adapters_megakernel", "fp", None,
             dict(adapter_pages=8, megakernel=True, record=True,
                  profile=True)),
            ("serving_adapters_megakernel_2pages", "fp", None,
             dict(adapter_pages=2, megakernel=True)),
            ("serving_adapters_r32_megakernel", "fp", None,
             dict(adapter_pages=8, megakernel=True,
                  adapter_ranks=LORA_RANK32_BUCKETS, record=True)),
            ("serving_int8_adapters_megakernel", "int8", None,
             dict(adapter_pages=8, megakernel=True, kv_dtype="int8",
                  record=True)))
    tokens = {}
    for path, kv, want, opts in runs:
        launches, st, tokens[path] = serve(dev, tln, tpa, model, True,
                                           **opts)
        if not path.endswith("again"):
            by_path[path] = launches
        if want is not None:
            same = tokens[path] == want
            log(f"  [{path}] tokens identical to the megakernel-off "
                f"{kv} defaults arm's: {same}")
            if not same:
                raise AssertionError(f"{path}: the megakernel changed the "
                                     "tokens")
        stats[path] = st
    off = tokens["serving_adapters"]
    for path in ("serving_adapters_megakernel",
                 "serving_adapters_megakernel_2pages",
                 "serving_adapters_r32_megakernel"):
        pairs = [(a, b) for got, w in zip(tokens[path], off)
                 for a, b in zip(got, w)]
        share = sum(a == b for a, b in pairs) / len(pairs)
        stats[path]["agreement_with_megakernel_off"] = share
        log(f"  [{path}] tokens equal to the megakernel-off adapters arm's "
            f"at {share:.4f} of positions")
    pool = stats["serving_adapters_megakernel_2pages"]["adapter_pool"]
    if pool["spills_total"] + pool["evictions_total"] < 1 or \
            pool["restores_total"] + pool["loads_total"] <= LORA["adapters"]:
        raise AssertionError(f"2 adapter pages did not churn: {pool}")
    return by_path, stats


def serving_legacy(dev, tln, tpa, model, fp_tokens) -> tuple:
    """Phase 3's legacy and gather arms on the same model and traffic:
    the legacy alternating step in bf16 twice (the first with a recorded
    decode step rerun plain, and a profile), over fp8 and over int8 pools
    once each, and the unified step's gather arm in bf16 once (with a
    recorded step rerun plain). The two
    bf16 legacy runs' tokens must be identical; printed, not checked:
    the share of tokens equal to the unified defaults arm's. Returns the
    launches of each run (its path) and the stats."""
    by_path, stats = {}, {}
    runs = (("serving_legacy", dict(unified=False, record=True,
                                    profile=True)),
            ("serving_legacy_again", dict(unified=False)),
            ("serving_legacy_fp8", dict(unified=False, kv_dtype="fp8")),
            ("serving_legacy_int8", dict(unified=False, kv_dtype="int8")),
            ("serving_gather", dict(attn_impl="gather", record=True)))
    tokens = {}
    for path, opts in runs:
        launches, st, tokens[path] = serve(dev, tln, tpa, model, True,
                                           **opts)
        pairs = [(a, b) for got, want in zip(tokens[path], fp_tokens)
                 for a, b in zip(got, want)]
        st["agreement_with_unified"] = sum(a == b for a, b in pairs) / len(
            pairs)
        log(f"  [{path}] tokens equal to the unified defaults arm's at "
            f"{st['agreement_with_unified']:.4f} of positions")
        if path != "serving_legacy_again":
            by_path[path] = launches
        stats[path] = st
    same = tokens["serving_legacy"] == tokens["serving_legacy_again"]
    log(f"  the two bf16 legacy runs' tokens identical: {same}")
    if not same:
        raise AssertionError("two legacy runs gave other tokens")
    return by_path, stats


def generate_phase(dev, tln, tpa, model, label: str = "",
                   sampling: bool = True) -> tuple:
    """`generate()` of `model` (bf16), batch 8 x prompt 128, 32 new
    tokens: greedy twice (identical tokens), a seeded top-k 50 sampling
    run twice (identical tokens; with `sampling`), beam search with
    GENERATE_BEAMS beams and the dense int8 cache (greedy). Exact
    launches: per forward K1 `norm_launches` and K3 one a layer (the
    prefill and one forward per later token; beam search's at batch 8 x
    beams), the int8 run's K3 only in its calibration prefill and its
    prefill (its decode steps attend through the plain `kv8_attend`, jnp
    in the JAX package). The prefill's last logits, and those of the
    decode step after it (K3 at Lq 1 over the dense cache, the window as
    its kvec), against a plain f32 rerun: on the CPU, or past
    CPU_RERUN_MAX_PARAMS on the card under `plain_path`
    (`reference_on_card`), where the cache-free forward of the same
    tokens through K3 is held too, as `held_on_card` holds a step: all
    three within LLAMA_HELD_LOGITS_TOL of the plain f32 rerun and
    BF16_FLOOR_RATIO x the bf16 floor of the plain bf16 rerun, and the
    f32 copy through the kernels within LLAMA_F32_HELD_TOL. Returns the
    launches of the greedy, beam and int8 runs (`label`generate, _beam,
    _int8) and the stats."""
    from paddle_tpu_torch.nlp.generation import (decode_model_step,
                                                 init_decode_caches)
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    cfg = model.config
    on_card = reference_on_card(model)
    rs = np.random.RandomState(SEED + 2)
    batch, plen, new = GENERATE["batch"], GENERATE["prompt"], GENERATE["new"]
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                      (batch, plen))).to(dev)
    model.generate(ids, max_new_tokens=2)          # warm-up
    torch.cuda.synchronize()
    n_layers, k1 = cfg.num_hidden_layers, norm_launches(model)
    runs = {"generate": dict(), "generate_beam": dict(
        decode_strategy="beam_search", num_beams=GENERATE_BEAMS),
        "generate_int8": dict(kv_cache_dtype="int8")}
    # forwards a run makes: the prefill and new - 1 decode steps; the
    # int8 run's calibration prefill besides
    forwards = {"generate": new, "generate_beam": new,
                "generate_int8": new + 1}
    k3 = {"generate": n_layers * new, "generate_beam": n_layers * new,
          "generate_int8": 2 * n_layers}
    by_path, out, stats = {}, {}, {}
    for path, kw in runs.items():
        reset_counts(tln, tfa, tpa)
        t0 = time.perf_counter()
        out[path] = model.generate(ids, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[label + path] = launches = launch_counts_serving(tln, tpa,
                                                                 tfa)
        want = _no_launches(tpa)
        want.update(K1=k1 * forwards[path], K3=k3[path])
        seq = out[path]
        agree = (seq[:, plen:] == out["generate"][:, plen:]).float().mean()
        stats[path] = {"tokens_per_s": batch * new / wall, "wall_s": wall,
                       "agreement_with_greedy": agree.item()}
        log(f"  [{label}{path}] [{batch}, {plen}] + {new} tokens: "
            f"{wall:.3f} s, {batch * new / wall:.1f} tokens/s; launches "
            f"{ {k: n for k, n in launches.items() if n} }; tokens equal "
            f"to greedy at {agree.item():.3f} of positions")
        if launches != want:
            raise AssertionError(f"{path} launches {launches} != {want}")
        if seq.shape != (batch, plen + new) or not torch.equal(
                seq[:, :plen], ids) or not (
                (seq >= 0) & (seq < cfg.vocab_size)).all():
            raise AssertionError(f"{path} returned the wrong sequence")
    greedy = out["generate"]
    # beam search's order among equal candidates on the card: the lower
    # index first (jax.lax.top_k's), as the stable sort on the CPU gives
    # it, over rows with many exact ties
    from paddle_tpu_torch.nlp.generation import _top_k_stable
    ties = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 4, (8, 4 * cfg.vocab_size)).astype(np.float32))
    card_order = [t.cpu() for t in _top_k_stable(ties.to(dev), 16)]
    stats["beam_tie_order_equal_to_cpu"] = all(
        torch.equal(a, b) for a, b in zip(card_order,
                                          _top_k_stable(ties, 16)))
    log(f"  [{label}generate] beam search's top-k over [8, "
        f"{4 * cfg.vocab_size}] with ties on the card equals the CPU's "
        f"stable order: {stats['beam_tie_order_equal_to_cpu']}")
    if not stats["beam_tie_order_equal_to_cpu"]:
        raise AssertionError("beam search's tie order on the card")
    again = model.generate(ids, max_new_tokens=new)
    same = {"greedy": torch.equal(greedy, again)}
    if sampling:
        sample = lambda: model.generate(
            ids, max_new_tokens=new, decode_strategy="sampling", top_k=50,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        s1, s2 = sample(), sample()
        same["sampling"] = torch.equal(s1, s2)
        stats["sampling_agreement_with_greedy"] = (
            s1[:, plen:] == greedy[:, plen:]).float().mean().item()
    with torch.no_grad():
        caches = init_decode_caches(n_layers, batch, plen + new,
                                    *model._decode_cache_spec()[1:],
                                    dtype=model.dtype, device=dev)
        first, caches = decode_model_step(model, ids, caches)
        nxt = first.argmax(-1)[:, None]
        before = tfa.LAUNCHES["fwd"]
        second, _ = decode_model_step(model, nxt, caches)
        torch.cuda.synchronize()
        step_k3 = tfa.LAUNCHES["fwd"] - before
        seq = torch.cat([ids, nxt], 1)
        if on_card:
            def plain_forward(m):
                before = launch_counts_serving(tln, tpa, tfa)
                with plain_path():
                    logits = m(seq)[:, -2:].float()
                if launch_counts_serving(tln, tpa, tfa) != before:
                    raise AssertionError("a plain rerun launched a kernel")
                return logits

            before = tfa.LAUNCHES["fwd"]
            free = model(seq)[:, -2:].float()
            free_k3 = tfa.LAUNCHES["fwd"] - before
            want_bf16 = plain_forward(model)
            plain = f32_copy_on_card(model)
            # the f32 model through the kernels: the prefill, the decode
            # step and the cache-free forward
            caches = init_decode_caches(n_layers, batch, plen + new,
                                        *model._decode_cache_spec()[1:],
                                        dtype=torch.float32, device=dev)
            first32, caches = decode_model_step(plain, ids, caches)
            second32, _ = decode_model_step(plain, nxt, caches)
            kernel32 = [torch.stack([first32, second32], 1),
                        plain(seq)[:, -2:].float()]
            want_logits = plain_forward(plain)
            err32 = max((k - want_logits).abs().max().item()
                        for k in kernel32)
            del plain, caches
            torch.cuda.empty_cache()
        else:
            plain = copy.deepcopy(model).float().cpu()
            want_logits = plain(seq.cpu())[:, -2:].float().to(dev)
    tol = LLAMA_HELD_LOGITS_TOL if on_card else HELD_LOGITS_TOL
    dist = lambda a, b: (a - b).abs().max().item()
    err = dist(first, want_logits[:, 0])
    err_step = dist(second, want_logits[:, 1])
    stats.update(first_logits_max_abs_err=err,
                 decode_step_logits_max_abs_err=err_step, **{
                     f"{k}_twice_identical": v for k, v in same.items()})
    if on_card:
        err_free = dist(free, want_logits)
        stats.update(cache_free_logits_max_abs_err=err_free,
                     f32_kernels_max_abs_err=err32, **bf16_floor_check(
                         f"[{label}generate]",
                         {"prefill_and_decode_step": torch.stack(
                             [first, second], 1).float(), "cache_free": free},
                         want_bf16, want_logits))
        log(f"  [{label}generate] the f32 model through the kernels (the "
            f"prefill, the decode step, the cache-free forward) vs the "
            f"plain f32 versions: max_abs_err={err32:.6f} (tolerance "
            f"{LLAMA_F32_HELD_TOL})")
        if not err32 <= LLAMA_F32_HELD_TOL:
            raise AssertionError("the f32 kernel path disagrees with the "
                                 "plain rerun")
    log(f"  [{label}generate] twice identical: {same}; vs plain f32 rerun "
        f"{'on the card' if on_card else 'on the CPU'}: prefill logits "
        f"max_abs_err={err:.4f}, first decode step's max_abs_err="
        f"{err_step:.4f} ({step_k3} K3 launches)"
        + (f", the cache-free forward's {err_free:.4f} ({free_k3} K3 "
           f"launches)" if on_card else "") + f"; tolerance {tol}")
    if not all(same.values()):
        raise AssertionError("generate is not reproducible")
    if not torch.isfinite(first).all() or err > tol:
        raise AssertionError("generate's first logits disagree with the "
                             "plain rerun")
    if step_k3 != n_layers or not torch.isfinite(second).all() \
            or err_step > tol:
        raise AssertionError("generate's decode step disagrees with the "
                             "plain rerun")
    if on_card and (free_k3 != n_layers or not torch.isfinite(free).all()
                    or err_free > tol):
        raise AssertionError("the cache-free forward disagrees with the "
                             "plain rerun")
    return by_path, stats


def preemption(dev, model, kv_dtype: str = "fp") -> dict:
    """Full-width preemption over pools of `kv_dtype`: 16 priority-5
    requests fill 16 slots and a pool of PREEMPT_PAGES pages; once all
    decode, a priority-0 burst of PREEMPT_BURST arrives that only
    preemption admits. Every request's tokens must equal those of a run
    that never preempts (preempt=False, the default pool), and the pool
    must be quiesced after drain()."""
    from paddle_tpu_torch.serving import (RequestState, SamplingParams,
                                          ServingEngine)

    class SwapTimedEngine(ServingEngine):
        """Times each resume's swap-in, device work included."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.swap_in = []       # (pages restored, ms) per resume

        def _apply_swap_in(self, req):
            n = len(req._swap.restores)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._apply_swap_in(req)
            torch.cuda.synchronize()
            self.swap_in.append((n, (time.perf_counter() - t0) * 1e3))

    rs = np.random.RandomState(SEED + 1)
    vocab = GPT124M["vocab_size"]
    low = [rs.randint(0, vocab, size=PREEMPT_PROMPT) for _ in range(16)]
    burst = [rs.randint(0, vocab, size=PREEMPT_PROMPT)
             for _ in range(PREEMPT_BURST)]

    def drive(eng):
        lo = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS,
                                                priority=5)) for p in low]
        while not all(r.state is RequestState.DECODE and r.output_tokens
                      for r in lo):
            eng.step()
        hi = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS,
                                                priority=0)) for p in burst]
        eng.run()
        eng.drain()              # checks that the pool is quiesced
        reqs = lo + hi
        if any(r.finish_reason != "length" for r in reqs):
            raise AssertionError("a request did not finish")
        return [list(r.output_tokens) for r in reqs], reqs

    t0 = time.perf_counter()
    eng = SwapTimedEngine(model, device=dev, seed=SEED, kv_dtype=kv_dtype,
                          num_pages=PREEMPT_PAGES, **ENGINE)
    tokens, reqs = drive(eng)
    wall = time.perf_counter() - t0
    m = eng.metrics
    ref = ServingEngine(model, device=dev, seed=SEED, preempt=False,
                        kv_dtype=kv_dtype, **ENGINE)
    want, _ = drive(ref)
    restored = sum(n for n, _ in eng.swap_in)
    swap_ms = [ms for _, ms in eng.swap_in]
    pc = eng.prefix_cache.stats()
    out = {"preemptions": m.preemptions,
           "preempted_requests": sum(r.preemptions > 0 for r in reqs),
           "swapped_out_pages": m.swapped_out_pages,
           "swapped_in_pages": m.swapped_in_pages,
           "spilled_pages": pc["spilled_pages"],
           "restored_pages": pc["restored_pages"],
           "resumes": len(swap_ms), "resume_pages": restored,
           "swap_in_ms": swap_ms, "wall_s": wall,
           "reference_preemptions": ref.metrics.preemptions}
    log(f"  [{kv_dtype}] preemption: {m.preemptions} preemptions of "
        f"{out['preempted_requests']} requests, {m.swapped_out_pages} pages "
        f"swapped out and {m.swapped_in_pages} in ({pc['spilled_pages']} "
        f"prefix pages spilled, {pc['restored_pages']} restored); "
        f"{len(swap_ms)} resumes restored {restored} pages in "
        f"{sum(swap_ms):.3f} ms ({max(swap_ms, default=0):.3f} ms the "
        f"longest, synchronised host clock); {wall:.2f} s; tokens equal "
        f"the never-preempted run's: {tokens == want}")
    if m.preemptions < 1 or m.swapped_out_pages < 1 or not swap_ms:
        raise AssertionError("the burst did not preempt and swap")
    if ref.metrics.preemptions:
        raise AssertionError("the reference run preempted")
    if tokens != want:
        raise AssertionError("preempted requests' tokens differ")
    return out


def profile_steps(eng, prompts, new: int = 16) -> dict:
    """Where a serving step's time goes: run `prompts` (`new` new tokens
    each) under torch.profiler and report the device's busy share of the
    wall time and the kernels that took the most device time. Only the
    device's activity is traced: with the host's op events as well, the
    trace of Llama-7B's 32 layers took 30-90 s an arm to process on the
    H100 (PERF.md). Profiling still slows the host, so these numbers are
    not the tokens/s above."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import SamplingParams
    count = lambda: (eng.metrics.unified_steps if eng.unified
                     else eng.metrics.decode_steps)
    steps0 = count()
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=new))
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.pool.assert_quiesced()
    out = dict(steps=count() - steps0, **device_busy(prof, wall_us))
    log(f"  profile of {out['steps']} steps: {time.perf_counter() - t_all:.1f}"
        f" s with the trace's processing")
    return out


# kernels whose device time a profile totals, by a part of their symbol:
# the walk (K6, K7, K9 and both phases of K10: one kernel, whichever the
# arm launches), K11 (lora_paged.cu), K8 (paged_scatter.cu's float and
# e4m3 lanes) and K2 (the training step's LayerNorm backward)
PROFILED_KERNELS = {"walk": "ring_walk_kernel", "K11": "lora_paged_kernel",
                    "K8": "scatter_tile_kernel", "K2": "ln_bwd_kernel"}


def device_busy(prof, wall_us: float) -> dict:
    """The device's busy time and share of `wall_us` in a profile, the
    kernels that took the most device time and the totals (calls, ms) of
    PROFILED_KERNELS. Device-side events,
    less the GPU mirrors of the engine's own record_function ranges
    (serving::...), which are spans, not work."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("serving::")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    totals = {name: [0, 0.0] for name in PROFILED_KERNELS}
    for e in kernels:
        for name, symbol in PROFILED_KERNELS.items():
            if symbol in e.key:
                totals[name][0] += e.count
                totals[name][1] += e.self_device_time_total / 1e3
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us if busy_us else None,
           "top_kernels": [[e.key[:70], e.count,
                            e.self_device_time_total / 1e3] for e in top],
           "kernel_totals": totals}
    log(f"  profiled: device busy {out['device_busy_ms']:.2f} of "
        f"{out['wall_ms']:.2f} ms wall; " + ", ".join(
            f"{name} {ms:.3f} ms in {calls} calls"
            for name, (calls, ms) in totals.items()))
    for name, count, ms in out["top_kernels"]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {name}")
    return out


# -- phase 8: Llama ----------------------------------------------------------
def same_share(got, want) -> float:
    """The share of token positions at which two runs agree."""
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g, w)]
    return sum(a == b for a, b in pairs) / len(pairs)


def llama_phase(dev, tln, tpa) -> tuple:
    """Phase 8: Llama-7B (bf16, random weights from SEED; the arms,
    `generate()` and phases 10's and 11's Llama-7B parts on its first
    LLAMA7B_ARM_LAYERS layers) serves phase 3's traffic in six arms (the
    defaults, grouped=False, int8 pools, the legacy step, the megakernel
    on, LORA adapters with the megakernel on;
    the defaults, int8, legacy and adapter arms each with a recorded
    step held on the card by `held_on_card`), each with its exact
    launches per step and a profile; the defaults,
    grouped=False and megakernel tokens must be identical. Then its
    `generate()` (greedy twice, beam search, the int8 cache; the prefill
    and a decode step against a plain f32 rerun on the card). Then the
    GQA arm at Llama-3-8B's widths (4 layers, rep 4, vocab 128256): the
    defaults, grouped=False and the megakernel on (K12 over 128256
    columns), tokens identical. Returns the launches of each run (its
    path) and the stats."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import make_draft_model
    by_path, stats, tokens = {}, {}, {}

    def arms(model, label, runs):
        for path, opts in runs:
            t_arm = time.perf_counter()
            by_path[path], stats[path], tokens[path] = serve(
                dev, tln, tpa, model, opts.pop("grouped", True),
                profile=True, label=label, **opts)
            torch.cuda.empty_cache()
            log(f"  [{path}] {time.perf_counter() - t_arm:.1f} s in all")

    t0 = time.perf_counter()
    full = LlamaForCausalLM(LlamaConfig(**LLAMA7B), device=dev,
                            dtype=torch.bfloat16, seed=SEED).eval()
    model = make_draft_model(full, LLAMA7B_ARM_LAYERS)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in full.parameters())
    del full
    torch.cuda.empty_cache()
    log(f"  Llama-7B: {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.2f} s; the arms, generate(), phase "
        f"10's and phase 11's arms run on its first {LLAMA7B_ARM_LAYERS} "
        f"layers ({sum(p.numel() for p in model.parameters())} "
        "parameters)")
    arms(model, f"llama-7b, {LLAMA7B_ARM_LAYERS} layers", (
        ("llama_serving", dict(record=True)),
        ("llama_serving_ungrouped", dict(grouped=False)),
        ("llama_serving_int8", dict(kv_dtype="int8", record=True)),
        ("llama_serving_legacy", dict(unified=False, record=True)),
        ("llama_serving_megakernel", dict(megakernel=True)),
        ("llama_serving_adapters_megakernel",
         dict(megakernel=True, adapter_pages=8, record=True))))
    base = tokens["llama_serving"]
    same = (base == tokens["llama_serving_ungrouped"]
            == tokens["llama_serving_megakernel"])
    for path in ("llama_serving_int8", "llama_serving_legacy",
                 "llama_serving_adapters_megakernel"):
        stats[path]["agreement_with_defaults"] = same_share(tokens[path],
                                                            base)
    log(f"  [llama-7b] defaults, grouped=False and megakernel tokens "
        f"identical: {same}; tokens equal to the defaults arm's: " + ", ".join(
            f"{p[14:]} {stats[p]['agreement_with_defaults']:.4f}"
            for p in ("llama_serving_int8", "llama_serving_legacy",
                      "llama_serving_adapters_megakernel")))
    if not same:
        raise AssertionError("Llama-7B: grouped=False or the megakernel "
                             "changed the tokens")
    gen_paths, stats["generate"] = generate_phase(
        dev, tln, tpa, model, label="llama_", sampling=False)
    by_path.update(gen_paths)
    log("phase 11 quarantine, its Llama-7B part (the defaults arm on "
        f"phase 8's {LLAMA7B_ARM_LAYERS}-layer copy):")
    t_q = time.perf_counter()
    by_path["llama_quarantine"], stats["quarantine"] = quarantine_arm(
        dev, tln, tpa, model, "llama_quarantine", {},
        LLAMA_HELD_LOGITS_TOL)
    stats["quarantine"]["seconds"] = time.perf_counter() - t_q
    log(f"  phase 11, Llama-7B part: {stats['quarantine']['seconds']:.1f} s")
    log("phase 10 speculative serving, its Llama-7B part (phase 8's "
        f"{LLAMA7B_ARM_LAYERS}-layer copy):")
    t_spec = time.perf_counter()
    spec_paths, stats["spec"] = spec_phase_llama(dev, tln, tpa, model)
    by_path.update(spec_paths)
    log(f"  phase 10, Llama-7B part: {time.perf_counter() - t_spec:.1f} s")
    log("phase 12 embeddings and the KV fabric, their Llama-7B part (phase "
        f"8's {LLAMA7B_ARM_LAYERS}-layer copy):")
    p12_paths, stats["phase12"] = phase12_llama(dev, tln, tpa, model)
    by_path.update(p12_paths)
    del model
    torch.cuda.empty_cache()

    model = LlamaForCausalLM(LlamaConfig(**LLAMA3_GQA), device=dev,
                             dtype=torch.bfloat16, seed=SEED).eval()
    arms(model, "llama-3-8b widths, 4 layers", (
        ("llama3_gqa_serving", dict()),
        ("llama3_gqa_serving_ungrouped", dict(grouped=False)),
        ("llama3_gqa_serving_megakernel", dict(megakernel=True))))
    same = (tokens["llama3_gqa_serving"]
            == tokens["llama3_gqa_serving_ungrouped"]
            == tokens["llama3_gqa_serving_megakernel"])
    log(f"  [llama-3-8b widths] defaults, grouped=False and megakernel "
        f"tokens identical: {same}")
    if not same:
        raise AssertionError("the GQA arm: grouped=False or the megakernel "
                             "changed the tokens")
    del model
    torch.cuda.empty_cache()
    return by_path, stats


# -- phase 10: speculative serving -------------------------------------------
# the templated arm: 16 requests, each a 2-token head and a 24-token block
# repeated 4 times (tests/test_serving_spec.py's `templated_prompt` at the
# step's width), 64 new tokens, greedy
SPEC_TEMPLATED = dict(requests=16, head=2, block=24, reps=4)
# phase 10's GPT-124M runs a weight copy of its first SPEC_GPT_LAYERS
# layers, a cut for time (at 12 layers the part took 52-145 s)
SPEC_GPT_LAYERS = 6
SPEC_TIERS = ("ngram:4", "model:4")
# each spec arm's profiled run: the traffic's four shortest prompts,
# SPEC_PROFILE_NEW tokens each, traced over SPEC_PROFILE_STEPS steps once
# every row decodes (a trace's processing grows with its kernel events,
# and a draft micro-step adds a draft model's worth)
SPEC_PROFILE_NEW, SPEC_PROFILE_STEPS = 12, 3
# the target engine's arms: (name, engine options)
SPEC_ARMS = (("defaults", {}), ("int8", dict(kv_dtype="int8")),
             ("megakernel", dict(megakernel=True)),
             ("adapters", dict(adapters=True, adapter_pages=8)))


def templated_traffic(vocab: int):
    rs = np.random.RandomState(SEED)
    t = SPEC_TEMPLATED
    return [np.concatenate([rs.randint(0, vocab, size=t["head"]),
                            np.tile(rs.randint(0, vocab, size=t["block"]),
                                    t["reps"])]).astype(np.int64)
            for _ in range(t["requests"])]


def spec_launches(tpa, model, eng) -> tuple:
    """A speculative engine's launches per target step and per draft
    micro-step. The target step is phase 3's (`per_step_launches`: K1 2L
    + 1 for GPT, the walk per layer in the pools' lane, the lane's write)
    with K12 twice under the megakernel (the sampling argmax and
    `spec_verify_accept` over every verify column). The draft step runs
    the draft model ungrouped over float pools without the megakernel,
    as the JAX draft program: K1 2L_d + 1 for GPT, K6 once a layer, its
    write `index_copy_`."""
    cfg = model.config
    target = per_step_launches(
        tpa, eng.grouped, eng.kv_dtype, eng.attn_impl, eng.megakernel,
        eng.adapters is not None, cfg.num_hidden_layers,
        norm_launches(model))
    if eng.megakernel and eng.spec is not None:
        target["K12"] = 2
    draft = _no_launches(tpa)
    if eng._draft is not None:
        dm = eng._draft.model
        draft["K1"] = norm_launches(dm)
        draft["K6"] = dm.config.num_hidden_layers
    return target, draft


def spec_serve(dev, tln, tpa, model, prompts, spec, arm, opts, label,
               tenants=None, profile=False) -> dict:
    """One run of `prompts` (64 new tokens each, greedy) on a fresh engine
    with `spec` ("ngram:4", "model:4" or None) and the arm's options,
    counting launches from 0: exact against `spec_launches` times the
    target steps and the draft micro-steps. A spec-off run keeps, for
    every token, the top-two margin of the held logits it was sampled
    from. Then, with `profile`, `profile_decode_steps` on the same
    engine for the device's busy share; then `drain()`, with the page
    pool and the draft pool quiesced. Returns the tokens, margins and
    stats."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine

    class MarginEngine(ServingEngine):
        """Keeps each step's top-two held logits (on the card, read after
        the run) and, per emitted token, the step and slot it came from."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tops, self.where = [], []

        def _sample_next(self):
            if self.spec is None:
                self.tops.append(torch.topk(self._last_logits, 2,
                                            dim=-1).values)
            return super()._sample_next()

        def _emit_tokens(self, slots, nxt, finished, accept=None,
                         drafts=None):
            if self.spec is None:
                for s in slots:
                    req = self.scheduler.running.get(int(s))
                    if req is not None and req.state.name == "DECODE":
                        self.where.append((req.request_id,
                                           len(self.tops) - 1, int(s)))
            super()._emit_tokens(slots, nxt, finished, accept, drafts)

    tag = f"{label} {arm} spec={spec or 'off'}"
    eng = MarginEngine(model, device=dev, seed=SEED, spec=spec, **ENGINE,
                       **opts)
    cfg = model.config
    if eng.adapters is not None:
        loras, all_tenants = adapter_traffic(cfg)
        for i, w in enumerate(loras):
            eng.adapters.register(f"tenant{i}", w)
        tenants = all_tenants[:len(prompts)]
    tenants = tenants or [0] * len(prompts)
    torch.cuda.synchronize()
    reset_counts(tln, tfa, tpa)
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS,
                                              adapter_id=a))
            for p, a in zip(prompts, tenants)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts_serving(tln, tpa, tfa)
    snap = eng.metrics.snapshot()
    steps = snap["unified_steps"]
    micro = 0 if eng._draft is None else eng._draft.micro_steps
    per_step, per_micro = spec_launches(tpa, model, eng)
    want = {k: per_step[k] * steps + per_micro[k] * micro
            for k in per_step}
    if launches != want:
        raise AssertionError(f"[{tag}] kernel launches {launches} != {want}")
    if any(r.finish_reason != "length" or len(r.output_tokens) != NEW_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)
           for r in reqs):
        raise AssertionError(f"[{tag}] a request did not finish with "
                             f"{NEW_TOKENS} tokens in the vocabulary")
    drafted, accepted = snap["spec_drafted_tokens"], \
        snap["spec_accepted_tokens"]
    if sum(r.accepted_draft_tokens for r in reqs) != accepted:
        raise AssertionError(f"[{tag}] accepted_draft_tokens disagree")
    margins = None
    if spec is None:
        tops = torch.stack(eng.tops).cpu() if eng.tops else None
        by_req = {}
        for rid, step, slot in eng.where:
            by_req.setdefault(rid, []).append(
                float(tops[step, slot, 0] - tops[step, slot, 1]))
        margins = [by_req[r.request_id] for r in reqs]
    step_s = snap["step_s"]
    stats = {"tokens_per_s": snap["tokens_per_sec"],
             "step_ms_p50": step_s["p50"] * 1e3,
             "step_ms_p90": step_s["p90"] * 1e3, "steps": steps,
             "wall_s": wall, "drafted": drafted, "accepted": accepted,
             "acceptance": accepted / drafted if drafted else None,
             "tokens_per_step":
                 snap["spec_tokens_per_step"]["mean"],
             "draft_micro_steps": micro,
             "launches_per_target_step": {k: n for k, n in per_step.items()
                                          if n},
             "launches_per_draft_micro_step": {
                 k: n for k, n in per_micro.items() if n}}
    log(f"  [{tag}] {len(reqs)} requests in {steps} steps "
        f"({micro} draft micro-steps), {wall:.3f} s: "
        f"{snap['tokens_generated']} tokens, "
        f"{snap['tokens_per_sec']:.1f} tokens/s; step p50 "
        f"{stats['step_ms_p50']:.3f} ms, p90 {stats['step_ms_p90']:.3f} ms;"
        f" drafted {drafted}, accepted {accepted} "
        f"(acceptance {stats['acceptance']}), tokens a decode row a step "
        f"{stats['tokens_per_step']}; launches "
        f"{ {k: n for k, n in launches.items() if n} }"
        f" = per target step {stats['launches_per_target_step']} x {steps}"
        f" + per draft micro-step {stats['launches_per_draft_micro_step']}"
        f" x {micro}")
    if profile:
        stats["profile"] = profile_decode_steps(
            eng, sorted(prompts, key=len)[:4])
        stats["device_busy_share"] = stats["profile"]["device_busy_share"]
    if eng._draft is not None:
        stats["draft_pool"] = eng._draft.stats()
    eng.drain()
    eng.pool.assert_quiesced()
    if eng._draft is not None:
        eng._draft.assert_quiesced()
    del eng
    torch.cuda.empty_cache()
    return dict(tokens=[list(r.output_tokens) for r in reqs],
                margins=margins, stats=stats, launches=launches)


def profile_decode_steps(eng, prompts) -> dict:
    """The device's busy share of speculative decode steps: `prompts`
    (SPEC_PROFILE_NEW new tokens each) run until every row decodes, then
    SPEC_PROFILE_STEPS steps are traced (the device only), then the rest
    runs untraced."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import SamplingParams
    reqs = [eng.add_request(p, SamplingParams(
        max_new_tokens=SPEC_PROFILE_NEW)) for p in prompts]
    while any(r.state.name in ("QUEUED", "PREFILL") for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SPEC_PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    out = dict(steps=SPEC_PROFILE_STEPS, **device_busy(prof, wall_us))
    log(f"  profile of {SPEC_PROFILE_STEPS} decode steps: "
        f"{time.perf_counter() - t_all:.1f} s with the trace's processing")
    return out


def spec_identity(tag, on, off, tol) -> dict:
    """Spec on against spec off, request by request: equal, or the first
    differing token is one whose spec-off top-two margin lies within
    `tol` (a near tie: the GEMMs' row counts differ between the runs, so
    bf16 results may differ by a rounding there); any other difference
    fails. Returns the share of equal positions and the near ties."""
    ties = []
    for i, (a, b) in enumerate(zip(on["tokens"], off["tokens"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        margin = off["margins"][i][j]
        ties.append({"request": i, "position": j, "spec_on": a[j],
                     "spec_off": b[j], "margin": margin})
        log(f"  [{tag}] request {i} differs first at token {j}: spec on "
            f"{a[j]}, off {b[j]}, spec-off top-two margin {margin:.5f} "
            f"(tolerance {tol})")
        if not margin <= tol:
            raise AssertionError(f"[{tag}] request {i} token {j} differs "
                                 f"with a margin of {margin} > {tol}")
    share = same_share(on["tokens"], off["tokens"])
    log(f"  [{tag}] spec on vs off: {len(on['tokens']) - len(ties)} of "
        f"{len(on['tokens'])} requests identical, {share:.4f} of positions;"
        f" {len(ties)} near ties")
    return {"same_share": share, "near_ties": ties}


def spec_phase_gpt(dev, tln, tpa, model) -> tuple:
    """Phase 10, GPT-124M's first SPEC_GPT_LAYERS layers: `ngram:4` and
    `model:4` (the half-depth draft model) on phase 3's traffic and on the templated traffic, each in
    the defaults, int8, megakernel and adapter arms, each against the
    spec-off run of the same arm and traffic (`spec_identity`, tolerance
    HELD_LOGITS_TOL). Acceptance must be above 0 on the templated
    traffic. Returns the launches of each spec run (its path) and the
    stats."""
    by_path, stats = {}, {}
    vocab = model.config.vocab_size
    for traffic, prompts in (("phase3", make_traffic(vocab)),
                             ("templated", templated_traffic(vocab))):
        for arm, opts in SPEC_ARMS:
            off = spec_serve(dev, tln, tpa, model, prompts, None, arm, opts,
                             f"gpt-124m {traffic}")
            stats[f"{traffic}_{arm}_off"] = off["stats"]
            for spec in SPEC_TIERS:
                on = spec_serve(dev, tln, tpa, model, prompts, spec, arm,
                                opts, f"gpt-124m {traffic}", profile=True)
                key = f"{traffic}_{arm}_{spec.split(':')[0]}"
                on["stats"]["identity"] = spec_identity(
                    f"gpt-124m {traffic} {arm} {spec}", on, off,
                    HELD_LOGITS_TOL)
                on["stats"]["speedup_tokens_per_s"] = (
                    on["stats"]["tokens_per_s"]
                    / off["stats"]["tokens_per_s"])
                stats[key] = on["stats"]
                by_path[f"spec_{key}"] = on["launches"]
                if traffic == "templated" and not on["stats"]["accepted"]:
                    raise AssertionError(f"[{key}] accepted no draft")
    return by_path, stats


def spec_phase_llama(dev, tln, tpa, model) -> tuple:
    """Phase 10, Llama-7B on phase 8's 8-layer copy: `ngram:4` and
    `model:4` (the draft model at its default half depth) on phase 3's
    traffic at the defaults, against the spec-off run (`spec_identity`,
    tolerance LLAMA_HELD_LOGITS_TOL)."""
    by_path, stats = {}, {}
    prompts = make_traffic(model.config.vocab_size)
    off = spec_serve(dev, tln, tpa, model, prompts, None, "defaults", {},
                     "llama-7b")
    stats["defaults_off"] = off["stats"]
    for spec in SPEC_TIERS:
        on = spec_serve(dev, tln, tpa, model, prompts, spec, "defaults", {},
                        "llama-7b", profile=True)
        key = f"defaults_{spec.split(':')[0]}"
        on["stats"]["identity"] = spec_identity(
            f"llama-7b {spec}", on, off, LLAMA_HELD_LOGITS_TOL)
        on["stats"]["speedup_tokens_per_s"] = (
            on["stats"]["tokens_per_s"] / off["stats"]["tokens_per_s"])
        stats[key] = on["stats"]
        by_path[f"llama_spec_{key}"] = on["launches"]
    return by_path, stats


# -- phase 11: observability, quarantine, the census and the driver ---------
# obs on against off: OBS_RUNS alternating runs a side of phase 3's
# traffic, then OBS_TRACED_STEPS decode steps traced for the device-to-host
# copies, after one warm-up step and a pause of OBS_TRACE_GAP_S seconds
OBS_RUNS, OBS_TRACED_STEPS = 2, 3
OBS_TRACE_GAP_S = 0.05
LAYERS_OFF = dict(obs=False, slo=False, cost_census=False)
# the quarantine arms: the first QUARANTINE["requests"] prompts of phase 3's
# traffic, QUARANTINE["new"] greedy tokens each; request `victim` poisoned at
# admission, after `after` steps (mid-prefill: a prompt of phase 3's
# traffic takes 9-22 steps at 32 tokens a step), and once it has streamed
# `tokens` tokens; at most QUARANTINE_NEAR_TIES near ties an arm
# (`spec_identity`'s rule)
QUARANTINE = dict(requests=8, new=24, victim=3, after=5, tokens=5)
QUARANTINE_NEAR_TIES = 2
QUARANTINE_ARMS = (("quarantine", {}),
                   ("quarantine_legacy", dict(unified=False)),
                   ("quarantine_spec_ngram", dict(spec="ngram:4")))
# the driver: 8 streamed requests, then a kill at step 20 and a failed
# third admission
DRIVER = dict(requests=8, new=32, kill_step=20, join_s=120.0)


def obs_run(dev, tln, tpa, model, on: bool, opts: dict) -> dict:
    """One run of phase 3's traffic (64 greedy tokens each) on a fresh
    engine with obs, the SLO tracker and the "model" census at their
    defaults (`on`) or all three off, launches counted from 0 and held to
    phase 3's per-step launches. With the layers on, the flight ring's
    records must agree with the metrics snapshot: the packed tokens of
    every step, and the last step's queue depth and residents."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    eng = ServingEngine(model, device=dev, seed=SEED, **ENGINE, **opts,
                        **({} if on else LAYERS_OFF))
    layers = (eng.obs is not None, eng.slo is not None, eng.census_mode)
    if layers != ((True, True, "model") if on else (False, False, "off")):
        raise AssertionError(f"obs={on}: the engine built {layers}")
    prompts = make_traffic(model.config.vocab_size)
    torch.cuda.synchronize()
    reset_counts(tln, tfa, tpa)
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS))
            for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts_serving(tln, tpa, tfa)
    snap = eng.metrics.snapshot()
    steps = snap["unified_steps"]
    per_step = per_step_launches(tpa, eng.grouped, eng.kv_dtype,
                                 eng.attn_impl, eng.megakernel)
    if launches != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"obs={on} {opts}: launches {launches}, "
                             f"{steps} steps of {per_step}")
    if any(r.finish_reason != "length" or len(r.output_tokens) != NEW_TOKENS
           for r in reqs):
        raise AssertionError(f"obs={on} {opts}: a request did not finish")
    out = dict(tokens=[list(r.output_tokens) for r in reqs],
               launches=launches, steps=steps, wall_s=wall,
               tokens_per_s=snap["tokens_per_sec"],
               step_ms_p50=snap["step_s"]["p50"] * 1e3)
    if on:
        flight = eng.obs.flight.snapshot()
        recs = [r for r in flight["steps"] if "note" not in r]
        packed = sum(r["prefill_tokens"] + r["decode_tokens"]
                     + r["draft_tokens"] for r in recs)
        want = (snap["packed_prefill_tokens"] + snap["packed_decode_tokens"]
                + snap["packed_draft_tokens"])
        last = recs[-1]
        residents = round(snap["slot_occupancy"] * snap["num_slots"])
        got = (len(recs), packed, last["queue_depth"], last["residents"])
        if got != (flight["steps_recorded"], want, snap["queue_depth"],
                   residents):
            raise AssertionError(f"flight ring {got} against the snapshot "
                                 f"{(flight['steps_recorded'], want)}, "
                                 f"queue {snap['queue_depth']}, residents "
                                 f"{residents}")
        census = eng.cost_census()
        if census["source"] != "model" or eng._census_captures != 1:
            raise AssertionError(f"census {census}")
        out.update(flight_steps=len(recs), packed_tokens=packed,
                   slo_worst=snap["slo"]["worst"],
                   tracer=eng.obs.tracer.stats())
    eng.pool.assert_quiesced()
    return out


def device_copies(dev, model, opts: dict, on: bool) -> dict:
    """The copies and kernels the device ran in OBS_TRACED_STEPS traced
    steps once every resident decodes (the first 16 prompts of phase 3's
    traffic), with the layers on or off. The tracer warms up on one step
    it discards, and the traced window opens OBS_TRACE_GAP_S seconds
    before the first traced step: a window that opened right before a
    step lost the first of its copies and kernels in some traces, on
    either side. Only the device's own events count (no runtime call, no
    mirror of a serving:: span)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    eng = ServingEngine(model, device=dev, seed=SEED, **ENGINE, **opts,
                        **({} if on else LAYERS_OFF))
    for p in make_traffic(model.config.vocab_size)[:ENGINE["num_slots"]]:
        eng.add_request(p, SamplingParams(max_new_tokens=NEW_TOKENS))
    for _ in range(NEW_TOKENS):
        eng.step()
        if all(r.state.name == "DECODE"
               for r in eng.scheduler.running.values()):
            break
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1,
                                   active=OBS_TRACED_STEPS,
                                   repeat=1)) as prof:
        for _ in range(OBS_TRACED_STEPS + 1):
            eng.step()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(OBS_TRACE_GAP_S)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith("serving::")]
    eng.abort_all()
    out = {"d2h": sum("DtoH" in n for n in names),
           "h2d": sum("HtoD" in n for n in names),
           "kernels": sum("Memcpy" not in n and "Memset" not in n
                          for n in names)}
    if out["d2h"] < OBS_TRACED_STEPS:
        raise AssertionError(
            f"the trace shows {out['d2h']} device-to-host copies in "
            f"{OBS_TRACED_STEPS} steps: "
            f"{sorted({n for n in names if 'Memcpy' in n})}")
    return out


def obs_phase(dev, tln, tpa, model) -> tuple:
    """Phase 11, obs on against off: GPT-124M's defaults and megakernel
    arms, OBS_RUNS alternating runs a side (off, on, on, off):
    the same tokens and launches in every run, the same device-to-host
    copies in the traced steps; step p50 and tokens/s the median of a
    side's runs."""
    by_path, stats = {}, {}
    for arm, opts in (("defaults", {}), ("megakernel",
                                         dict(megakernel=True))):
        runs = {False: [], True: []}
        for i in range(OBS_RUNS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                runs[on].append(obs_run(dev, tln, tpa, model, on, opts))
        first = runs[False][0]
        for r in runs[False] + runs[True]:
            if r["tokens"] != first["tokens"]:
                raise AssertionError(f"[obs {arm}] tokens differ")
            if r["launches"] != first["launches"]:
                raise AssertionError(f"[obs {arm}] launches differ: "
                                     f"{r['launches']} {first['launches']}")
        copies = {on: device_copies(dev, model, opts, on)
                  for on in (False, True)}
        if copies[False] != copies[True]:
            raise AssertionError(f"[obs {arm}] traced steps differ: "
                                 f"{copies}")
        side = {on: {"step_ms_p50": statistics.median(
                         r["step_ms_p50"] for r in runs[on]),
                     "tokens_per_s": statistics.median(
                         r["tokens_per_s"] for r in runs[on]),
                     "step_ms_p50_runs": [r["step_ms_p50"]
                                          for r in runs[on]],
                     "tokens_per_s_runs": [r["tokens_per_s"]
                                           for r in runs[on]]}
                for on in (False, True)}
        on_run = runs[True][0]
        stats[arm] = {
            "off": side[False], "on": side[True],
            "step_ms_p50_on_minus_off": (side[True]["step_ms_p50"]
                                         - side[False]["step_ms_p50"]),
            "tokens_per_s_on_over_off": (side[True]["tokens_per_s"]
                                         / side[False]["tokens_per_s"]),
            "steps": first["steps"], "traced_steps": copies[True],
            "flight_steps": on_run["flight_steps"],
            "packed_tokens": on_run["packed_tokens"],
            "slo_worst": on_run["slo_worst"], "tracer": on_run["tracer"]}
        by_path[f"obs_{arm}"] = on_run["launches"]
        log(f"  [obs {arm}] tokens and launches equal in {2 * OBS_RUNS} "
            f"runs ({first['steps']} steps each); traced "
            f"{OBS_TRACED_STEPS} steps, off {copies[False]}, on "
            f"{copies[True]}; step p50 off {side[False]['step_ms_p50']:.3f}"
            f" ms, on {side[True]['step_ms_p50']:.3f} ms; tokens/s off "
            f"{side[False]['tokens_per_s']:.1f}, on "
            f"{side[True]['tokens_per_s']:.1f}; flight ring "
            f"{on_run['flight_steps']} records, {on_run['packed_tokens']} "
            f"packed tokens = the snapshot's, SLO {on_run['slo_worst']}")
    return by_path, stats


def quarantine_serve(dev, tln, tpa, model, opts, prompts, poison=None,
                     hook=None, margins=False) -> dict:
    """One quarantine run of `prompts` on a fresh engine with the arm's
    options: `poison` = (request index, steps before the poison, tokens
    it streams before the poison; 0 and 0 at admission), through a
    `FaultInjector`; or `hook`, a step fault hook of
    its own. Counts the rounds that launched (normal and probe) and holds
    the launches to the arm's launches a step (a legacy arm's: a decode
    step's and a prefill chunk's). With `margins`, the top-two margin of
    the held logits behind every emitted token."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import (FaultInjector, SamplingParams,
                                          ServingEngine)

    class RoundEngine(ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.rounds = {"normal": 0, "probe": 0}
            self.tops, self.where = [], []

        def _launched(self):
            m = self.metrics
            return m.unified_steps + m.decode_step_s.count + m.prefill_chunks

        def _run_round(self, finished, suppress=frozenset()):
            before = self._launched()
            out = super()._run_round(finished, suppress)
            if self._launched() > before:
                self.rounds["probe" if suppress else "normal"] += 1
            return out

        def _sample_next(self):
            if margins:
                self.tops.append(torch.topk(self._last_logits, 2,
                                            dim=-1).values)
            return super()._sample_next()

        def _emit_tokens(self, slots, nxt, finished, accept=None,
                         drafts=None):
            if margins:
                for s in slots:
                    req = self.scheduler.running.get(int(s))
                    if req is not None and req.state.name == "DECODE":
                        self.where.append((req.request_id,
                                           len(self.tops) - 1, int(s)))
            super()._emit_tokens(slots, nxt, finished, accept, drafts)

    eng = RoundEngine(model, device=dev, seed=SEED, **ENGINE, **opts)
    inj = FaultInjector()
    if hook is not None:
        eng.step_fault_hook = hook
    elif poison is not None:
        eng.step_fault_hook = lambda ids: inj.on_engine_step("r0", ids)
    torch.cuda.synchronize()
    reset_counts(tln, tfa, tpa)
    reqs = [eng.add_request(p, SamplingParams(
        max_new_tokens=QUARANTINE["new"])) for p in prompts]
    steps_before = 0
    if poison is not None:
        victim, after, streamed = poison
        while steps_before < after or (
                len(reqs[victim].output_tokens) < streamed
                and steps_before < 200):
            eng.step()
            steps_before += 1
        inj.poison(reqs[victim].request_id)
    error = None
    try:
        eng.run()
    except RuntimeError as exc:
        if hook is None:
            raise
        error = exc
    torch.cuda.synchronize()
    launches = launch_counts_serving(tln, tpa, tfa)
    snap = eng.metrics.snapshot()
    if eng.unified:
        per_step, _ = spec_launches(tpa, model, eng)
        want = {k: n * snap["unified_steps"] for k, n in per_step.items()}
        launched = snap["unified_steps"]
    else:
        per_step, per_chunk = legacy_launches(
            tpa, eng.kv_dtype, model.config.num_hidden_layers,
            norm_launches(model))
        want = {k: n * snap["decode_step_s"]["count"]
                + per_chunk[k] * snap["prefill_chunks"]
                for k, n in per_step.items()}
        launched = snap["decode_step_s"]["count"]
    if launches != want:
        raise AssertionError(f"quarantine {opts}: launches {launches} != "
                             f"{want}")
    if eng.unified and launched != sum(eng.rounds.values()):
        raise AssertionError(f"quarantine {opts}: {launched} launched "
                             f"steps, rounds {eng.rounds}")
    out = dict(tokens=[list(r.output_tokens) for r in reqs],
               reasons=[r.finish_reason for r in reqs],
               errors=[type(r.error).__name__ if r.error else None
                       for r in reqs],
               rounds=dict(eng.rounds), launches=launches,
               steps=snap["decode_steps"], steps_before=steps_before,
               error=error,
               poisoned=snap["requests"]["poisoned"],
               incidents=[(i["kind"], len(i["steps"]))
                          for i in eng.obs.flight.snapshot()["incidents"]],
               timelines={r.request_id: [e["kind"] for e in
                                         eng.obs.tracer.timeline(
                                             r.request_id)]
                          for r in reqs}, per_step=per_step)
    if margins:
        tops = torch.stack(eng.tops).cpu() if eng.tops else None
        by_req = {}
        for rid, step, slot in eng.where:
            by_req.setdefault(rid, []).append(
                float(tops[step, slot, 0] - tops[step, slot, 1]))
        out["margins"] = [by_req.get(r.request_id, []) for r in reqs]
    if error is not None:
        eng.abort_all()
    else:
        eng.drain()
    eng.pool.assert_quiesced()
    del eng
    torch.cuda.empty_cache()
    return out


def quarantine_arm(dev, tln, tpa, model, path, opts, tol) -> tuple:
    """Phase 11, one quarantine arm: QUARANTINE["requests"] prompts of
    phase 3's traffic served without the victim, then with the victim
    poisoned at admission, after QUARANTINE["after"] steps and after its
    QUARANTINE["tokens"]-th token: the victim
    ends "poisoned" with `PoisonedRequest` and a timeline that ends in
    "poison", every innocent's tokens equal its tokens without the victim
    (near ties by `spec_identity`'s rule at `tol`, at most
    QUARANTINE_NEAR_TIES an arm), one "poison_quarantine" incident (after
    the step fault's, holding the steps before it), launches = the arm's
    launches a step x the rounds that launched; then a hook that raises
    for every round propagates and poisons nobody."""
    prompts = make_traffic(model.config.vocab_size)[:QUARANTINE["requests"]]
    v = QUARANTINE["victim"]
    innocent = [i for i in range(len(prompts)) if i != v]
    spec = "spec" in opts
    base = quarantine_serve(dev, tln, tpa, model, opts,
                            [prompts[i] for i in innocent],
                            margins=not spec)
    if spec:
        # a burst's tokens come from several verify columns: the margins
        # are the spec-off run's, as phase 10 reads them
        base["margins"] = quarantine_serve(
            dev, tln, tpa, model,
            {k: o for k, o in opts.items() if k != "spec"},
            [prompts[i] for i in innocent], margins=True)["margins"]
    stats, ties = {}, []
    for when, after, streamed in (
            ("at admission", 0, 0),
            (f"after {QUARANTINE['after']} steps", QUARANTINE["after"], 0),
            (f"after {QUARANTINE['tokens']} tokens", 0,
             QUARANTINE["tokens"])):
        got = quarantine_serve(dev, tln, tpa, model, opts, prompts,
                               poison=(v, after, streamed))
        before = got["steps_before"]
        tag = f"{path} poisoned {when}"
        want_reasons = ["length"] * len(prompts)
        want_reasons[v] = "poisoned"
        rid = f"req-{v}"
        kinds = [k for k, _ in got["incidents"]]
        if (got["reasons"] != want_reasons
                or got["errors"][v] != "PoisonedRequest"
                or got["poisoned"] != 1
                or got["timelines"][rid][-1] != "poison"
                or kinds != ["step_fault", "poison_quarantine"]
                or got["incidents"][-1][1] < before):
            raise AssertionError(f"[{tag}] reasons {got['reasons']}, "
                                 f"errors {got['errors']}, incidents "
                                 f"{got['incidents']}, victim's timeline "
                                 f"{got['timelines'][rid]}")
        if len(got["tokens"][v]) < streamed:
            raise AssertionError(f"[{tag}] the victim streamed "
                                 f"{len(got['tokens'][v])} tokens")
        on = {"tokens": [got["tokens"][i] for i in innocent]}
        arm_ties = spec_identity(tag, on, base, tol)["near_ties"]
        ties += arm_ties
        stats[when] = {"rounds": got["rounds"], "steps": got["steps"],
                       "steps_before_poison": before,
                       "victim_tokens": len(got["tokens"][v]),
                       "probe_rounds": got["rounds"]["probe"],
                       "incidents": got["incidents"],
                       "near_ties": arm_ties,
                       "launches_per_step": {k: n for k, n in
                                             got["per_step"].items() if n}}
        log(f"  [{tag}] victim req-{v} poisoned after {before} steps and "
            f"{len(got['tokens'][v])} tokens, {len(innocent)} "
            f"innocents equal to the run without it "
            f"({len(arm_ties)} near ties); rounds that launched "
            f"{got['rounds']}, probe rounds {got['rounds']['probe']}; "
            f"launches { {k: n for k, n in got['launches'].items() if n} } "
            f"= per step "
            f"{stats[when]['launches_per_step']} x the rounds; incidents "
            f"{got['incidents']}")
        launches = got["launches"]
    if len(ties) > QUARANTINE_NEAR_TIES:
        raise AssertionError(f"[{path}] {len(ties)} near ties")
    boom = RuntimeError("a fault that tracks no request")

    def hook(ids):
        raise boom

    glob = quarantine_serve(dev, tln, tpa, model, opts, prompts[:2],
                            hook=hook)
    if (glob["error"] is not boom or glob["poisoned"] != 0
            or [k for k, _ in glob["incidents"]]
            != ["step_fault", "replica_death"]
            or any(glob["launches"].values())):
        raise AssertionError(f"[{path}] a global fault: {glob['error']!r}, "
                             f"poisoned {glob['poisoned']}, incidents "
                             f"{glob['incidents']}, launches "
                             f"{glob['launches']}")
    stats["global_fault"] = {"propagated": True, "poisoned": 0}
    log(f"  [{path}] a hook raising every round propagated, poisoned "
        "nobody, launched nothing")
    return launches, stats


def quarantine_phase(dev, tln, tpa, model) -> tuple:
    """Phase 11, quarantine on GPT-124M: the defaults, legacy and
    `spec="ngram:4"` arms (Llama-7B's runs inside phase 8)."""
    by_path, stats = {}, {}
    for path, opts in QUARANTINE_ARMS:
        by_path[path], stats[path] = quarantine_arm(
            dev, tln, tpa, model, path, dict(opts), HELD_LOGITS_TOL)
    return by_path, stats


def census_phase(dev, model) -> dict:
    """Phase 11, the cost census of GPT-124M's defaults engine: "model"
    and "lowered" (one forward of the step at [16, 32] counted on the
    card), each source the mode asked for; the "lowered" record must
    equal the same geometry counted on the CPU (a bf16 GPT-124M built
    here with device="cpu": shape arithmetic)."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    records, secs = {}, {}
    for mode in ("model", "lowered"):
        eng = ServingEngine(model, device=dev, seed=SEED, **ENGINE,
                            cost_census=mode)
        t0 = time.perf_counter()
        records[mode] = dict(eng.cost_census())
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
        if records[mode]["source"] != mode:
            raise AssertionError(f"census {mode}: source "
                                 f"{records[mode]['source']}")
        del eng
    t0 = time.perf_counter()
    cpu_model = GPTForCausalLM(GPTConfig(**GPT124M), device="cpu",
                               dtype=torch.bfloat16, seed=SEED).eval()
    cpu = ServingEngine(cpu_model, device="cpu", seed=SEED, **ENGINE,
                        cost_census="lowered").cost_census()
    secs["cpu"] = time.perf_counter() - t0
    keys = ("source", "flops", "bytes_accessed", "kernels",
            "capacity_tokens")
    low = records["lowered"]
    if {k: low[k] for k in keys} != {k: cpu[k] for k in keys}:
        raise AssertionError(f"census on the card { {k: low[k] for k in keys} }"
                             f" != on the CPU { {k: cpu[k] for k in keys} }")
    del cpu_model
    gc.collect()
    model_rec = records["model"]
    out = {mode: {k: rec[k] for k in ("source", "flops", "bytes_accessed",
                                      "capacity_tokens")}
           for mode, rec in records.items()}
    out["lowered"]["kernels"] = low["kernels"]
    out.update(flops_lowered_over_model=low["flops"] / model_rec["flops"],
               bytes_lowered_over_model=(low["bytes_accessed"]
                                         / model_rec["bytes_accessed"]),
               seconds=secs, cpu_equal=True)
    log(f"  [census] model: {model_rec['flops']:.6g} FLOPs, "
        f"{model_rec['bytes_accessed']:.6g} bytes; lowered: "
        f"{low['flops']:.6g} FLOPs ({out['flops_lowered_over_model']:.4f}x"
        f"), {low['bytes_accessed']:.6g} bytes "
        f"({out['bytes_lowered_over_model']:.4f}x), kernels "
        f"{low['kernels']}; equal to the CPU's count; capture "
        f"{secs['lowered']:.2f} s on the card, {secs['cpu']:.2f} s on the "
        "CPU (with its model)")
    return out


def driver_phase(dev, model) -> dict:
    """Phase 11, the engine driver over GPT-124M: 8 streamed requests
    (read as they grow, from the main thread) with the tokens of the same
    requests on an engine stepped directly; then `kill_at_step` at step
    20 (requests queued before the pump starts): the residents retire as
    "replica_failure", a submission after the death raises `ReplicaDead`,
    the flight ring holds a "replica_death" incident; then
    `fail_add_request(3)` refuses the third admission only. Every pump
    thread is joined."""
    from paddle_tpu_torch.serving import (FaultInjector, InjectedFault,
                                          SamplingParams, ServingEngine)
    from paddle_tpu_torch.serving.http import EngineDriver, ReplicaDead
    prompts = make_traffic(model.config.vocab_size)[:DRIVER["requests"]]
    sampling = SamplingParams(max_new_tokens=DRIVER["new"])
    join = DRIVER["join_s"]
    stats = {}

    def engine():
        return ServingEngine(model, device=dev, seed=SEED, **ENGINE)

    want = [list(r.token_ids) for r in engine().generate(prompts, sampling)]
    drv = EngineDriver(engine(), "replica-0").start()
    t0 = time.perf_counter()
    reqs = [drv.submit(p, sampling) for p in prompts]
    reads, seen = 0, [0] * len(reqs)
    while not all(r.finished for r in reqs):
        if time.perf_counter() - t0 > join:
            raise AssertionError("the driver did not finish its requests")
        for i, r in enumerate(reqs):
            n = len(r.output_tokens)
            reads += n > seen[i]
            seen[i] = n
        time.sleep(0.001)
    wall = time.perf_counter() - t0
    if not drv.drain(join):
        raise AssertionError("the driver's pump did not stop")
    got = [list(r.output_tokens) for r in reqs]
    if got != want or any(r.finish_reason != "length" for r in reqs):
        raise AssertionError("the driver's tokens differ from a direct run")
    stats["serve"] = {"requests": len(reqs), "reads": reads, "wall_s": wall,
                      "steps": drv.steps}

    eng = engine()
    inj = FaultInjector().kill_at_step("replica-0", DRIVER["kill_step"])
    drv = EngineDriver(eng, "replica-0", faults=inj)
    queued = [eng.add_request(p, sampling) for p in prompts]
    drv.start()
    drv._thread.join(join)
    try:
        drv.submit(prompts[0], sampling)
        late = None
    except ReplicaDead as exc:
        late = type(exc).__name__
    incidents = [i["kind"] for i in eng.obs.flight.snapshot()["incidents"]]
    if (drv._thread.is_alive() or not drv.dead
            or not isinstance(drv.death_exc, InjectedFault)
            or drv.steps != DRIVER["kill_step"] or late != "ReplicaDead"
            or {r.finish_reason for r in queued} != {"replica_failure"}
            or incidents != ["replica_death"]):
        raise AssertionError(f"kill at step {DRIVER['kill_step']}: steps "
                             f"{drv.steps}, death {drv.death_exc!r}, late "
                             f"submission {late}, reasons "
                             f"{[r.finish_reason for r in queued]}, "
                             f"incidents {incidents}")
    eng.pool.assert_quiesced()
    stats["kill"] = {"step": drv.steps, "streamed_before": sum(
        len(r.output_tokens) for r in queued), "incidents": incidents}

    inj = FaultInjector().fail_add_request(3)
    drv = EngineDriver(engine(), "replica-0", faults=inj).start()
    outcomes = []
    for p in prompts[:5]:
        try:
            outcomes.append(drv.submit(p, sampling))
        except InjectedFault as exc:
            outcomes.append(exc.kind)
    if not drv.drain(join):
        raise AssertionError("the driver's pump did not stop")
    reasons = [o if isinstance(o, str) else o.finish_reason
               for o in outcomes]
    if reasons != ["length", "length", "add_request", "length", "length"] \
            or inj.add_fails_fired != 1:
        raise AssertionError(f"fail_add_request(3): {reasons}")
    stats["fail_add"] = {"outcomes": reasons}
    log(f"  [driver] {len(reqs)} streamed requests ({reads} reads of new "
        f"tokens, {wall:.3f} s) with a direct run's tokens; killed at step "
        f"{stats['kill']['step']} after {stats['kill']['streamed_before']} "
        f"tokens: residents retired as replica_failure, a late submission "
        f"raised ReplicaDead, incidents {incidents}; fail_add_request(3): "
        f"{reasons}")
    return stats


def phase11(dev, tln, tpa) -> tuple:
    """Phase 11 on a fresh GPT-124M (bf16, random weights from SEED)."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                           dtype=torch.bfloat16, seed=SEED).eval()
    by_path, stats = {}, {}
    obs_paths, stats["obs"] = obs_phase(dev, tln, tpa, model)
    by_path.update(obs_paths)
    t1 = time.perf_counter()
    q_paths, stats["quarantine"] = quarantine_phase(dev, tln, tpa, model)
    by_path.update(q_paths)
    t2 = time.perf_counter()
    stats["census"] = census_phase(dev, model)
    t3 = time.perf_counter()
    stats["driver"] = driver_phase(dev, model)
    del model
    torch.cuda.empty_cache()
    stats["seconds"] = {"obs": t1 - t0, "quarantine": t2 - t1,
                        "census": t3 - t2,
                        "driver": time.perf_counter() - t3,
                        "all": time.perf_counter() - t0}
    log(f"  phase 11: {stats['seconds']['all']:.1f} s (obs "
        f"{t1 - t0:.1f}, quarantine {t2 - t1:.1f}, census {t3 - t2:.1f}, "
        f"driver {stats['seconds']['driver']:.1f})")
    return by_path, stats


# -- phase 12: grammar, embeddings, sessions and the KV fabric --------------
# phase 12's GPT-124M runs a weight copy of its first GRAMMAR_GPT_LAYERS
# layers (phase 10's cut); its constrained traffic is phase 3's prompts
# with GRAMMAR_NEW greedy tokens each, EOS token 0 (chr(0): no built-in
# grammar's character outside a regex's "." and negated classes, and
# allowed only where the automaton accepts)
GRAMMAR_GPT_LAYERS = 6
GRAMMAR_NEW, GRAMMAR_EOS = 48, 0
# request i of phase 3's 24 -> its grammar: 6 choice, 5 regex and 5 JSON
# rows, 8 unconstrained (None)
GRAMMAR_SPECS = (
    [dict(kind="choice", choices=c) for c in (
        ("yes", "no"), ("red", "green", "blue"),
        ("alpha", "beta", "gamma", "delta"), ("true", "false"),
        ("north", "south", "east", "west"), ("accept", "reject", "defer"))]
    + [dict(kind="regex", pattern=p) for p in (
        "[a-z]+@[a-z]+\\.(com|org)", "[0-9][0-9][0-9]-[0-9][0-9][0-9][0-9]",
        "(ab|cd)+x?", "[A-Z][a-z]*( [A-Z][a-z]*)*", "-?[0-9]+(\\.[0-9]+)?")]
    + [dict(kind="json_object")] * 5)
GRAMMAR_ROWS = [None] * 24
for _i, _spec in zip([i for i in range(24) if i % 3 != 2], GRAMMAR_SPECS):
    GRAMMAR_ROWS[_i] = _spec
# the arms (K12 once a step under the megakernel, twice with spec) and
# the runs a side of the defaults arm's gate-on/off timing
GRAMMAR_ARMS = (("defaults", {}), ("megakernel", dict(megakernel=True)),
                ("spec_ngram", dict(megakernel=True, spec="ngram:4")))
GRAMMAR_RUNS = 3
# K12 in phase 2 on grammar-biased logits: the f32 logits plus a bias of
# 0 / -1e30 (rows with one allowed token, with three allowed tied at one
# value, with EOS alone allowed, with about half allowed)
BIASED_ARGMAX_SHAPES = ((16, 50304), (512, 50304))
# embeddings: the first EMBED_REQUESTS * 2 prompts of phase 3's traffic,
# the even ones embed requests, the odd ones generating GRAMMAR_NEW tokens
EMBED_REQUESTS = 8
# sessions: turn 1 (SESSION["prompt"] tokens, SESSION["new"] new) pinned,
# then SESSION["others"] requests of SESSION["other_prompt"] tokens through
# a pool of SESSION["pages"] pages that holds turn 1 beside four of them
# at a time but not beside all twelve, no host tier; then turn 2 (turn 1,
# its output and SESSION["follow"] tokens)
SESSION = dict(prompt=512, new=16, others=12, other_prompt=256, follow=8,
               pages=120, slots=4, ttl_s=30.0)
# the fabric: a FABRIC_PROMPT-token prompt (31 pages of 16), prefilled on
# engine A to its first token t1, exported; engine B imports and continues
# prompt + [t1] for FABRIC_NEW tokens. Both A's own continuation and B's
# then match the 31 pages and prefill t1 alone: one computation
FABRIC_PROMPT, FABRIC_NEW = 496, 32


def check_greedy_argmax_biased(dev, tpa) -> dict:
    """K12 on grammar-biased logits (`BIASED_ARGMAX_SHAPES`): equal to
    `torch.argmax` of the same tensor bit for bit, 20 reruns identical;
    the tied rows pick their first allowed token, the EOS rows EOS."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for b, v in BIASED_ARGMAX_SHAPES:
        logits = torch.randn(b, v, generator=g, device=dev)
        bias = torch.where(torch.rand(b, v, generator=g, device=dev) < 0.5,
                           0.0, -1e30)
        allowed = torch.randint(1, v, (b, 3), generator=g, device=dev)
        rows = torch.arange(b, device=dev)
        one, tied, eos = rows[rows % 4 == 0], rows[rows % 4 == 1], \
            rows[rows % 4 == 2]
        bias[one] = -1e30
        bias[one, allowed[one, 0]] = 0.0
        bias[tied] = -1e30
        for j in range(3):
            bias[tied, allowed[tied, j]] = 0.0
            logits[tied, allowed[tied, j]] = 0.25
        bias[eos] = -1e30
        bias[eos, GRAMMAR_EOS] = 0.0
        x = logits + bias
        got = tpa.decode_greedy_argmax(x)
        torch.cuda.synchronize()
        want = torch.argmax(x, dim=-1)
        same = torch.equal(got.long(), want)
        repeat = all(torch.equal(tpa.decode_greedy_argmax(x), got)
                     for _ in range(20))
        first = torch.equal(got[tied].long(),
                            allowed[tied].min(dim=-1).values)
        only = bool((got[one].long() == allowed[one, 0]).all()
                    and (got[eos] == GRAMMAR_EOS).all())
        log(f"  K12 decode_greedy_argmax [{b}, {v}] on grammar-biased f32 "
            f"logits (one allowed, three tied, EOS alone, half allowed): "
            f"equal to torch.argmax bit for bit {same}; 20 repeats "
            f"identical {repeat}; tied rows their first allowed {first}; "
            f"single-token rows their token {only}")
        if not (same and repeat and first and only):
            raise AssertionError(f"K12 on biased logits [{b}, {v}]")
        out[f"[{b}, {v}]"] = dict(equal=same, repeats_identical=repeat)
    return out


def grammar_spec(i: int):
    from paddle_tpu_torch.serving import GrammarSpec
    kw = GRAMMAR_ROWS[i]
    return None if kw is None else GrammarSpec(**kw)


def grammar_check(tag, vocab, i, toks, reason):
    """Request i's output under its grammar: every token its automaton
    allowed (EOS only where it accepts, and last); ended by EOS with text
    the grammar validates, or by length in a live state."""
    spec = grammar_spec(i)
    g = spec.make(vocab)
    for j, t in enumerate(toks):
        if t == GRAMMAR_EOS:
            if not g.accepting() or j != len(toks) - 1:
                raise AssertionError(f"[{tag}] request {i}: EOS at {j} in "
                                     "a state that does not accept")
            break
        g.advance(t)            # raises on a token the grammar forbids
    text = "".join(chr(t) for t in toks if t != GRAMMAR_EOS)
    valid = spec.validates(text)
    if not (valid if reason == "stop" else reason == "length"):
        raise AssertionError(f"[{tag}] request {i} ended {reason!r} with "
                             f"{text!r}")
    return valid


def near_ties(tag, model, prompts, got, want, rows, tol) -> list:
    """Rows `rows` of two runs: equal, or the first differing token one
    whose top-two margin in `want`'s run, teacher-forced through `model`,
    lies within `tol` (a near tie: the runs pack their steps differently,
    so bf16 GEMMs may round a row differently); any other difference
    fails. Returns the near ties."""
    ties = []
    for i in rows:
        a, b = got[i], want[i]
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None and len(a) == len(b):
            continue
        if j is None:
            raise AssertionError(f"[{tag}] request {i}: {len(a)} tokens "
                                 f"against {len(b)}")
        seq = np.concatenate([prompts[i], np.asarray(b[:j], np.int64)])
        with torch.no_grad():
            lg = model(torch.from_numpy(seq).to(model.device)[None])[0, -1]
        top = torch.topk(lg.float(), 2).values
        margin = float(top[0] - top[1])
        ties.append({"request": i, "position": j, "got": a[j], "want": b[j],
                     "margin": margin})
        log(f"  [{tag}] request {i} differs first at token {j}: {a[j]} "
            f"against {b[j]}, top-two margin {margin:.5f} (tolerance {tol})")
        if not margin <= tol:
            raise AssertionError(f"[{tag}] request {i} token {j} differs "
                                 f"with a margin of {margin} > {tol}")
    return ties


def grammar_serve(dev, tln, tpa, model, arm, opts, gate: bool,
                  constrained: bool) -> dict:
    """One run of phase 3's prompts (GRAMMAR_NEW greedy tokens each) on a
    fresh engine with the grammar gate `gate`, the GRAMMAR_ROWS
    constrained when `constrained`; launches counted from 0 and held to
    `spec_launches` per step (the bias adds no launch); each constrained
    output held to its grammar (`grammar_check`)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine

    class BiasBytes(ServingEngine):
        """Sums the bytes of the grammar biases each step uploads."""
        bias_bytes = 0

        def _grammar_operands(self, *a, **kw):
            out = super()._grammar_operands(*a, **kw)
            self.bias_bytes += self.grammar_bias_bytes
            return out

    tag = f"grammar {arm} gate={'on' if gate else 'off'}" + (
        " constrained" if constrained else "")
    vocab = model.config.vocab_size
    eng = BiasBytes(model, device=dev, seed=SEED, grammar=gate, **ENGINE,
                    **opts)
    prompts = make_traffic(vocab)
    sps = [SamplingParams(max_new_tokens=GRAMMAR_NEW)
           if not constrained or grammar_spec(i) is None else
           SamplingParams(max_new_tokens=GRAMMAR_NEW,
                          eos_token_id=GRAMMAR_EOS, grammar=grammar_spec(i))
           for i in range(len(prompts))]
    torch.cuda.synchronize()
    reset_counts(tln, tfa, tpa)
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts_serving(tln, tpa, tfa)
    snap = eng.metrics.snapshot()
    steps = snap["unified_steps"]
    per_step, _ = spec_launches(tpa, model, eng)
    if launches != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"[{tag}] launches {launches}, {steps} steps "
                             f"of {per_step}")
    valid = 0
    for i, r in enumerate(reqs):
        if sps[i].grammar is not None:
            valid += grammar_check(tag, vocab, i, r.output_tokens,
                                   r.finish_reason)
        elif r.finish_reason != "length" or \
                len(r.output_tokens) != GRAMMAR_NEW:
            raise AssertionError(f"[{tag}] request {i} did not finish")
    stats = {"tokens_per_s": snap["tokens_per_sec"],
             "step_ms_p50": snap["step_s"]["p50"] * 1e3, "steps": steps,
             "wall_s": wall, "tokens": snap["tokens_generated"],
             **{k: snap[k] for k in ("grammar_requests",
                                     "grammar_masked_steps",
                                     "grammar_masked_rows",
                                     "grammar_rejected_drafts",
                                     "spec_drafted_tokens",
                                     "spec_accepted_tokens")},
             "bias_bytes_per_step": eng.bias_bytes / steps,
             "k12_per_step": launches["K12"] / steps,
             "validated": valid,
             "finish": {r: sum(q.finish_reason == r for q in reqs)
                        for r in ("stop", "length")}}
    log(f"  [{tag}] {len(reqs)} requests in {steps} steps, {wall:.3f} s: "
        f"{stats['tokens']} tokens, {stats['tokens_per_s']:.1f} tokens/s, "
        f"step p50 {stats['step_ms_p50']:.3f} ms; grammar rows "
        f"{stats['grammar_masked_rows']} over {stats['grammar_masked_steps']}"
        f" steps, rejected drafts {stats['grammar_rejected_drafts']}, "
        f"{valid} outputs valid, finish {stats['finish']}; bias bytes a "
        f"step {stats['bias_bytes_per_step']:.0f}; K12 a step "
        f"{stats['k12_per_step']}")
    eng.drain()
    eng.pool.assert_quiesced()
    del eng
    torch.cuda.empty_cache()
    return dict(tokens=[list(r.output_tokens) for r in reqs], stats=stats,
                launches=launches)


def grammar_phase(dev, tln, tpa, model) -> tuple:
    """Phase 12's grammar part: each arm's constrained run against the
    gate-off run of the same traffic (the unconstrained rows equal, or
    near ties, `near_ties` at HELD_LOGITS_TOL); in the defaults arm
    GRAMMAR_RUNS alternating runs a side (off, on, on, off, off, on; the
    medians of tokens/s and step p50) and the gate on with no constrained
    request, equal to the gate off in tokens and launches."""
    by_path, stats = {}, {}
    prompts = make_traffic(model.config.vocab_size)
    free = [i for i in range(len(prompts)) if GRAMMAR_ROWS[i] is None]
    for arm, opts in GRAMMAR_ARMS:
        sides = {True: [], False: []}
        order = ((False, True, True, False, False, True)
                 if arm == "defaults" else (True, False))
        for gate in order:
            sides[gate].append(grammar_serve(dev, tln, tpa, model, arm, opts,
                                             gate, constrained=gate))
        on, off = sides[True][0], sides[False][0]
        for runs in sides.values():
            if any(r["tokens"] != runs[0]["tokens"] for r in runs):
                raise AssertionError(f"grammar {arm}: runs of one side "
                                     "differ")
        rec = dict(on["stats"])
        rec["unconstrained_near_ties"] = near_ties(
            f"grammar {arm}", model, prompts, on["tokens"], off["tokens"],
            free, HELD_LOGITS_TOL)
        med = lambda side, key: statistics.median(
            r["stats"][key] for r in sides[side])
        rec["gate_on_off"] = {
            side: {"tokens_per_s": med(gate, "tokens_per_s"),
                   "step_ms_p50": med(gate, "step_ms_p50"),
                   "runs": len(sides[gate])}
            for side, gate in (("on", True), ("off", False))}
        if arm == "defaults":
            bare = grammar_serve(dev, tln, tpa, model, arm, opts, True,
                                 constrained=False)
            same = (bare["tokens"] == off["tokens"]
                    and bare["launches"] == off["launches"])
            log(f"  [grammar {arm}] the gate on with no constrained request"
                f" equals the gate off in tokens and launches: {same}")
            if not same or bare["stats"]["grammar_masked_steps"]:
                raise AssertionError("the grammar gate on changed an "
                                     "unconstrained run")
            rec["gate_on_unconstrained_equal"] = same
        log(f"  [grammar {arm}] gate on {rec['gate_on_off']['on']}, off "
            f"{rec['gate_on_off']['off']}")
        stats[arm] = rec
        by_path[f"grammar_{arm}"] = on["launches"]
    return by_path, stats


def embed_serve(dev, tln, tpa, model, opts, tag, embed=True,
                plain=False) -> dict:
    """The first 2 x EMBED_REQUESTS prompts of phase 3's traffic on a
    fresh engine: the even ones embed requests (when `embed`, else left
    out), the odd ones generating GRAMMAR_NEW greedy tokens. Each epilogue
    keeps every byte of its rows' pages (all of them, read before and
    after) and launches exactly the walk and the write once a layer (K9
    or K7; K8-q8 over int8 pools) and K1 2L + 1 (GPT); the run's launches
    are its steps' plus its epilogues'. With `plain`, each epilogue runs
    a second time under `plain_serving` (no launch) over the same pools,
    the embedding of the plain versions kept beside the kernels'."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = model.config
    n_layers = cfg.num_hidden_layers

    class Epilogue(ServingEngine):
        """Checks and times each embed epilogue."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.epilogues, self.rows, self.ms = [], 0, []

        def _embed_rows(self, rows):
            pages = torch.tensor(sorted({p for s, _ in rows
                                         for p in self._slot_pages[s]}),
                                 device=self.device)
            before = [[(k[pages].clone(), v[pages].clone())
                       for k, v in plane] for plane in self._planes]
            torch.cuda.synchronize()
            counts = launch_counts_serving(tln, tpa, tfa)
            t0 = time.perf_counter()
            super()._embed_rows(rows)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            after = launch_counts_serving(tln, tpa, tfa)
            self.epilogues.append({k: after[k] - counts[k] for k in after})
            self.rows += len(rows)
            for plane, copies in zip(self._planes, before):
                for (k, v), (k0, v0) in zip(plane, copies):
                    if not (torch.equal(k[pages], k0)
                            and torch.equal(v[pages], v0)):
                        raise AssertionError(f"[{tag}] the epilogue "
                                             "changed a page")
            if plain:
                kernel = [req.embedding for _, req in rows]
                with plain_serving():
                    super()._embed_rows(rows)
                if launch_counts_serving(tln, tpa, tfa) != after:
                    raise AssertionError(f"[{tag}] the plain epilogue "
                                         "launched a kernel")
                for (_, req), vec in zip(rows, kernel):
                    req.plain_embedding = req.embedding
                    req.embedding = vec

    eng = Epilogue(model, device=dev, seed=SEED, **ENGINE, **opts)
    prompts = make_traffic(cfg.vocab_size)[:2 * EMBED_REQUESTS]
    picks = [i for i in range(len(prompts)) if embed or i % 2]
    torch.cuda.synchronize()
    reset_counts(tln, tfa, tpa)
    t0 = time.perf_counter()
    reqs = {i: eng.add_request(prompts[i], SamplingParams(embed=True)
                               if i % 2 == 0 else
                               SamplingParams(max_new_tokens=GRAMMAR_NEW))
            for i in picks}
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts_serving(tln, tpa, tfa)
    steps = eng.metrics.snapshot()["unified_steps"]
    per_step = per_step_launches(tpa, eng.grouped, eng.kv_dtype,
                                 eng.attn_impl, eng.megakernel, False,
                                 n_layers, norm_launches(model))
    per_epilogue = _no_launches(tpa)
    per_epilogue["K1"] = norm_launches(model)
    per_epilogue[DECODE_WALK_OF[eng.kv_dtype]] = n_layers
    if WRITE_OF[eng.kv_dtype]:
        per_epilogue[WRITE_OF[eng.kv_dtype]] = n_layers
    if any(e != per_epilogue for e in eng.epilogues):
        raise AssertionError(f"[{tag}] epilogue launches {eng.epilogues} "
                             f"!= {per_epilogue}")
    want = {k: per_step[k] * steps + per_epilogue[k] * len(eng.epilogues)
            for k in per_step}
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want}")
    if eng.rows != (EMBED_REQUESTS if embed else 0):
        raise AssertionError(f"[{tag}] {eng.rows} embed rows retired")
    for i, r in reqs.items():
        if i % 2 == 0 and (r.finish_reason != "stop" or r.output_tokens
                           or r.embedding is None
                           or r.embedding.shape != (cfg.hidden_size,)
                           or not np.isfinite(r.embedding).all()):
            raise AssertionError(f"[{tag}] embed request {i}: "
                                 f"{r.finish_reason}")
        if i % 2 and len(r.output_tokens) != GRAMMAR_NEW:
            raise AssertionError(f"[{tag}] request {i} did not finish")
    eng.drain()
    eng.pool.assert_quiesced()
    out = dict(prompts=prompts, launches=launches, steps=steps, wall_s=wall,
               epilogues=len(eng.epilogues), epilogue_ms=eng.ms,
               per_epilogue={k: n for k, n in per_epilogue.items() if n},
               tokens={i: list(r.output_tokens) for i, r in reqs.items()},
               embeddings={i: r.embedding for i, r in reqs.items()
                           if i % 2 == 0},
               plain={i: getattr(r, "plain_embedding", None)
                      for i, r in reqs.items() if i % 2 == 0})
    del eng
    torch.cuda.empty_cache()
    return out


def embed_arm(dev, tln, tpa, model, opts, tag) -> tuple:
    """One embed arm: the bf16 run (its launches the path's; the
    generating rows against a run without the embed rows, `near_ties`),
    then the f32 copy's run, each embedding through the kernels held to
    its epilogue's plain versions over the same pools and, over float
    pools, to the plain f32 backbone's last hidden state over the prompt
    (`plain_path`), both within LLAMA_F32_HELD_TOL (phase 8's 0.01)."""
    from paddle_tpu_torch.serving.engine import model_backbone
    run = embed_serve(dev, tln, tpa, model, opts, tag)
    alone = embed_serve(dev, tln, tpa, model, opts, tag + " no embed rows",
                        embed=False)
    gen = sorted(alone["tokens"])
    ties = near_ties(tag, model, run["prompts"],
                     {i: run["tokens"][i] for i in gen},
                     {i: alone["tokens"][i] for i in gen}, gen,
                     LLAMA_HELD_LOGITS_TOL if hasattr(model, "llama")
                     else HELD_LOGITS_TOL)
    f32 = f32_copy_on_card(model)
    ref = embed_serve(dev, tln, tpa, f32, opts, tag + " f32 copy",
                      plain=True)
    err_plain = max(float(np.abs(ref["embeddings"][i] - ref["plain"][i])
                          .max()) for i in ref["embeddings"])
    err_prompt = []
    with torch.no_grad(), plain_path():
        for i, vec in ref["embeddings"].items():
            p = torch.from_numpy(run["prompts"][i]).to(dev)[None]
            want = model_backbone(f32)(p)[0, -1].float().cpu().numpy()
            err_prompt.append(float(np.abs(vec - want).max()))
            if i == 0:
                bf16_err = float(np.abs(run["embeddings"][i] - want).max())
    del f32
    torch.cuda.empty_cache()
    stats = dict(steps=run["steps"], wall_s=run["wall_s"],
                 epilogues=run["epilogues"],
                 epilogue_ms=run["epilogue_ms"],
                 epilogue_ms_median=statistics.median(run["epilogue_ms"]),
                 launches_per_epilogue=run["per_epilogue"],
                 f32_kernels_vs_plain_epilogue=err_plain,
                 f32_vs_plain_backbone=max(err_prompt),
                 bf16_vs_plain_f32_backbone_request0=bf16_err,
                 near_ties=ties)
    log(f"  [{tag}] {EMBED_REQUESTS} embed rows beside "
        f"{EMBED_REQUESTS} generating ones in {run['steps']} steps, "
        f"{run['epilogues']} epilogues ({run['per_epilogue']} each), "
        f"epilogue ms {[round(m, 3) for m in run['epilogue_ms']]}; every "
        f"byte of the rows' pages kept; the f32 copy's embeddings through "
        f"the kernels vs the plain epilogue {err_plain:.2e}, vs the plain "
        f"f32 backbone over the prompt {max(err_prompt):.2e} (tolerance "
        f"{LLAMA_F32_HELD_TOL}); bf16 request 0 vs the plain f32 backbone "
        f"{bf16_err:.4f}; generating rows against a run without the embed "
        f"rows: {len(ties)} near ties")
    gated = err_plain if opts.get("kv_dtype") == "int8" else \
        max(err_plain, max(err_prompt))
    if not gated <= LLAMA_F32_HELD_TOL:
        raise AssertionError(f"[{tag}] embeddings off by {gated}")
    return run["launches"], stats


def session_phase(dev, model) -> dict:
    """Session pins on GPT-124M (`SESSION`), the engine's clock the
    host's plus an offset this phase moves: with the pin held, turn 2
    hits every full page of turn 1 under pressure that evicts them; with
    the clock moved past the TTL, the same pressure leaves turn 2 cold.
    TTFT of both turns printed."""
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    s = SESSION
    rs = np.random.RandomState(SEED + 12)
    vocab = model.config.vocab_size
    turn1 = rs.randint(0, vocab, size=s["prompt"]).astype(np.int64)
    others = [rs.randint(0, vocab, size=s["other_prompt"]).astype(np.int64)
              for _ in range(s["others"])]
    out = {}
    for case, skew_s in (("pinned", 0.0), ("expired", s["ttl_s"] + 1.0)):
        skew = [0.0]
        eng = ServingEngine(model, device=dev, seed=SEED,
                            clock=lambda: time.monotonic() + skew[0],
                            num_slots=s["slots"], page_size=16,
                            chunk_len=32, max_len=992, num_pages=s["pages"],
                            host_pages=0, session_ttl_s=s["ttl_s"])
        one = eng.generate([turn1], SamplingParams(
            max_new_tokens=s["new"], session="chat"))[0]
        pinned = eng.prefix_cache.stats()["pinned_pages"]
        skew[0] = skew_s
        eng.generate(others, SamplingParams(max_new_tokens=s["new"]))
        evicted = eng.prefix_cache.stats()["evicted_pages"]
        turn2 = np.concatenate([turn1, one.token_ids,
                                rs.randint(0, vocab, size=s["follow"])])
        two = eng.generate([turn2], SamplingParams(max_new_tokens=s["new"],
                                                   session="chat"))[0]
        full = (s["prompt"] + s["new"]) // 16 * 16
        out[case] = dict(pinned_pages=pinned, evicted_pages=evicted,
                         turn2_cached_tokens=two.cached_tokens,
                         full_page_tokens=full,
                         ttft_turn1_ms=one.ttft_s * 1e3,
                         ttft_turn2_ms=two.ttft_s * 1e3)
        log(f"  [session {case}] turn 1 pinned {pinned} pages; the other "
            f"{s['others']} requests evicted {evicted} pages; turn 2 hit "
            f"{two.cached_tokens} of turn 1's {full} full-page tokens; TTFT"
            f" turn 1 {one.ttft_s * 1e3:.2f} ms, turn 2 "
            f"{two.ttft_s * 1e3:.2f} ms")
        want = full if case == "pinned" else 0
        if two.cached_tokens != want or pinned != full // 16 or not evicted:
            raise AssertionError(f"[session {case}] turn 2 hit "
                                 f"{two.cached_tokens}, want {want}")
        eng.drain()
        eng.pool.assert_quiesced()
        del eng
    torch.cuda.empty_cache()
    return out


def fabric_arm(dev, model, kv_dtype, tag) -> dict:
    """Engine A prefills a FABRIC_PROMPT-token prompt to its first token
    and exports the chain of prompt + [t1]; engine B imports it and
    continues prompt + [t1] for FABRIC_NEW tokens, equal to A's own
    continuation, with every full page a hit. The frame's bytes are the
    header's accounting; a page-32 engine refuses it whole and quiesces;
    A's snapshot after `drain()` restores into a fresh engine, which
    continues with the same tokens from a warm hit."""
    from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                          frame_header)
    ps = ENGINE["page_size"]
    rs = np.random.RandomState(SEED + 13)
    prompt = rs.randint(0, model.config.vocab_size,
                        size=FABRIC_PROMPT).astype(np.int64)
    make = lambda **kw: ServingEngine(model, device=dev, seed=SEED,
                                      kv_dtype=kv_dtype,
                                      **{**ENGINE, **kw})
    a = make()
    t1 = a.generate([prompt], SamplingParams(max_new_tokens=1))[0].token_ids
    seq = np.concatenate([prompt, t1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = a.export_prefix_frame(seq)
    export_ms = (time.perf_counter() - t0) * 1e3
    hdr = frame_header(frame)
    hlen = int.from_bytes(frame[4:8], "little")
    full = seq.size // ps * ps
    if (len(frame) != 8 + hlen + 8 * hdr["n_tokens"] + hdr["payload_bytes"]
            or hdr["payload_bytes"] != hdr["n_pages"] * a.page_bytes
            or hdr["valid"] != full):
        raise AssertionError(f"[{tag}] frame accounting {hdr}")
    want = a.generate([seq], SamplingParams(
        max_new_tokens=FABRIC_NEW))[0].token_ids
    b = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grafted = b.import_prefix_frame(frame)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    got = b.generate([seq], SamplingParams(max_new_tokens=FABRIC_NEW))[0]
    if grafted != hdr["n_pages"] or got.token_ids != want or \
            got.cached_tokens != full:
        raise AssertionError(f"[{tag}] B grafted {grafted}, hit "
                             f"{got.cached_tokens} of {full}; tokens equal "
                             f"{got.token_ids == want}")
    c = make(page_size=32)
    try:
        c.import_prefix_frame(frame)
        raise AssertionError(f"[{tag}] a page-32 engine took the frame")
    except ValueError as e:
        refused = str(e)
    if c.prefix_cache.tree_pages:
        raise AssertionError(f"[{tag}] the refused frame grafted pages")
    c.drain()
    c.pool.assert_quiesced()
    a.drain()
    a.pool.assert_quiesced()
    snap = a.export_prefix_state()
    d = make()
    restored = d.import_prefix_state(snap)
    warm = d.generate([seq], SamplingParams(max_new_tokens=FABRIC_NEW))[0]
    if warm.token_ids != want or warm.cached_tokens != full:
        raise AssertionError(f"[{tag}] the restored engine hit "
                             f"{warm.cached_tokens}, tokens equal "
                             f"{warm.token_ids == want}")
    for eng in (b, d):
        eng.drain()
        eng.pool.assert_quiesced()
    out = dict(frame_bytes=len(frame), pages=hdr["n_pages"],
               payload_bytes=hdr["payload_bytes"], export_ms=export_ms,
               import_ms=import_ms, refused=refused,
               snapshot_nodes=len(snap["nodes"]), restored_pages=restored)
    log(f"  [{tag}] frame of {hdr['n_pages']} pages, {len(frame)} bytes "
        f"({hdr['payload_bytes']} of pages); export {export_ms:.3f} ms, "
        f"import {import_ms:.3f} ms; B continued {FABRIC_NEW} tokens equal "
        f"to A's from a {got.cached_tokens}-token hit; page 32 refused "
        f"({refused}); snapshot of {len(snap['nodes'])} nodes restored "
        f"{restored} pages, warm hit {warm.cached_tokens}, tokens equal")
    del a, b, c, d
    torch.cuda.empty_cache()
    return out


def phase12(dev, tln, tpa) -> tuple:
    """Phase 12 on GPT-124M's first GRAMMAR_GPT_LAYERS layers (bf16,
    random weights from SEED): grammar, embeddings (defaults, int8),
    sessions and the fabric (bf16, int8, fp8)."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import make_draft_model
    t0 = time.perf_counter()
    full = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                          dtype=torch.bfloat16, seed=SEED).eval()
    model = make_draft_model(full, GRAMMAR_GPT_LAYERS)
    del full
    torch.cuda.empty_cache()
    by_path, stats = {}, {}
    gram_paths, stats["grammar"] = grammar_phase(dev, tln, tpa, model)
    by_path.update(gram_paths)
    t1 = time.perf_counter()
    stats["embed"] = {}
    for path, opts in (("embed_gpt", {}),
                       ("embed_gpt_int8", dict(kv_dtype="int8"))):
        by_path[path], stats["embed"][path] = embed_arm(
            dev, tln, tpa, model, opts, f"gpt-124m {path}")
    t2 = time.perf_counter()
    stats["session"] = session_phase(dev, model)
    t3 = time.perf_counter()
    stats["fabric"] = {kv: fabric_arm(dev, model, kv, f"gpt-124m fabric {kv}")
                       for kv in ("fp", "int8", "fp8")}
    bf16 = stats["fabric"]["fp"]["payload_bytes"]
    for rec in stats["fabric"].values():
        rec["wire_bytes_vs_bf16"] = rec["payload_bytes"] / bf16
    del model
    torch.cuda.empty_cache()
    stats["seconds"] = {"grammar": t1 - t0, "embed": t2 - t1,
                        "session": t3 - t2,
                        "fabric": time.perf_counter() - t3,
                        "all": time.perf_counter() - t0}
    log(f"  phase 12: {stats['seconds']['all']:.1f} s (grammar "
        f"{t1 - t0:.1f}, embeddings {t2 - t1:.1f}, sessions {t3 - t2:.1f}, "
        f"fabric {stats['seconds']['fabric']:.1f}); fabric wire bytes "
        f"against bf16: " + ", ".join(
            f"{kv} {rec['wire_bytes_vs_bf16']:.4f}"
            for kv, rec in stats["fabric"].items()))
    return by_path, stats


def phase12_llama(dev, tln, tpa, model) -> tuple:
    """Phase 12's Llama-7B part, on phase 8's 8-layer copy: the embed arm
    at the defaults and the fabric over int8 pools."""
    by_path, stats = {}, {}
    t0 = time.perf_counter()
    by_path["llama_embed"], stats["embed"] = embed_arm(
        dev, tln, tpa, model, {}, "llama-7b llama_embed")
    stats["fabric_int8"] = fabric_arm(dev, model, "int8",
                                      "llama-7b fabric int8")
    stats["seconds"] = time.perf_counter() - t0
    log(f"  phase 12, Llama-7B part: {stats['seconds']:.1f} s")
    return by_path, stats


# -- phase 13: the HTTP front end, the router and the control plane ---------
P13_NEW = 48
# phase 3's prompts by index (0 and 17-23 behind the shared 256-token
# prefix, 1-15 of 300-700 tokens): arm A's blocking JSON, SSE,
# response_format and embeddings requests
P13_JSON = (0, 1, 2, 3, 17, 18, 19, 20)
P13_SSE = (4, 5, 6, 21, 22, 23)
P13_FORMAT = (7, 8)
P13_EMBED = (9, 10)
P13_FORMATS = ({"type": "choice", "choices": ["yes", "no", "maybe"]},
               {"type": "json_object"})
# arm B: eight SSE streams, replica-0 killed once four of its streams
# have tokens; then four streams, replica-0 hung, under a watchdog of
# P13_WATCHDOG_S (the kernels were built in phase 1: no first-use build)
P13_MIGRATE = (4, 5, 6, 21, 22, 23, 0, 1)
P13_HANG = (2, 3, 17, 18)
P13_WATCHDOG_S = 2.0
# arm C: distinct prompts of 300-700 tokens (19-43 full pages; arm A's,
# so their bf16 runs alone are shared), each prefilled on replica-0
# (prefill) and continued on replica-1 (decode)
P13_HANDOFF = (1, 2, 3, 4)
# arm D: the warm restart's prompt; arm E: the resident that the drain
# lets finish, and the rate limit (requests a second per client key)
P13_RESTART = 15
P13_BLOCKER = dict(prompt=16, new=300)
P13_RATE = dict(rate_limit=0.5, rate_limit_burst=1)
# a stream's token against the in-process run: equal, or a near tie
# (phase 12's rule); an embedding equal to the in-process one bit for bit
P13_SOCKET_S = 120.0
P13_JOIN_S = 120.0


def http_post(addr, body, path="/v1/completions", key=None):
    """(status, headers, body, seconds) of one blocking request."""
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=P13_SOCKET_S)
    t0 = time.perf_counter()
    try:
        hdr = {"Content-Type": "application/json"}
        if key is not None:
            hdr["Authorization"] = f"Bearer {key}"
        conn.request("POST", path, json.dumps(body), hdr)
        resp = conn.getresponse()
        out = json.loads(resp.read())
        return (resp.status, dict(resp.getheaders()), out,
                time.perf_counter() - t0)
    finally:
        conn.close()


def http_get(addr, path):
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=P13_SOCKET_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def http_sse(addr, body, key=None):
    """One streamed completion read to [DONE]: status, tokens, the final
    frame, the ticket id and the client-observed TTFT in seconds."""
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=P13_SOCKET_S)
    t0 = time.perf_counter()
    ttft, tokens, final, rid = None, [], None, None
    try:
        hdr = {"Content-Type": "application/json"}
        if key is not None:
            hdr["Authorization"] = f"Bearer {key}"
        conn.request("POST", "/v1/completions",
                     json.dumps({**body, "stream": True}), hdr)
        resp = conn.getresponse()
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if not line.startswith(b"data: "):
                continue
            frame = json.loads(line[6:])
            rid = frame.get("id", rid)
            ch = (frame.get("choices") or [{}])[0]
            if ch.get("token") is not None:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                tokens.append(ch["token"])
            if ch.get("finish_reason") or "error" in frame:
                final = frame
        return dict(status=resp.status, tokens=tokens, final=final, id=rid,
                    ttft_s=ttft)
    finally:
        conn.close()


def run_clients(jobs) -> list:
    """Run each zero-argument job on its own thread at once; their
    results in order. Every thread is joined within P13_JOIN_S."""
    import threading
    out = [None] * len(jobs)
    errs = []

    def run(i, job):
        try:
            out[i] = job()
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, j), daemon=True)
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(P13_JOIN_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP client did not finish in "
                             f"{P13_JOIN_S} s")
    if errs:
        raise errs[0]
    return out


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def mid_decode(eng) -> list:
    """Ids of the engine's residents that have emitted tokens (read from
    another thread: a torn read is retried)."""
    for _ in range(10):
        try:
            return [r.request_id for r in list(eng.scheduler.running.values())
                    if r.output_tokens and not r.finished]
        except RuntimeError:
            continue
    return []


def wait_for(pred, timeout=P13_JOIN_S, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return time.monotonic() - t0
        time.sleep(0.002)
    raise AssertionError(f"phase 13: {what} not reached in {timeout} s")


class P13Engine:
    """Mixes into ServingEngine: counts its embed epilogues and times its
    fabric exports and imports (on the pump thread that runs them)."""

    def _p13_init(self):
        self.epilogues, self.exports, self.imports = 0, [], []

    def _embed_rows(self, rows):
        self.epilogues += 1
        return super()._embed_rows(rows)

    def export_prefix_frame(self, *a, **kw):
        t0 = time.perf_counter()
        frame = super().export_prefix_frame(*a, **kw)
        self.exports.append(((time.perf_counter() - t0) * 1e3,
                             0 if frame is None else len(frame)))
        return frame

    def import_prefix_frame(self, frame):
        t0 = time.perf_counter()
        n = super().import_prefix_frame(frame)
        self.imports.append(((time.perf_counter() - t0) * 1e3, n))
        return n


def p13_engine(model, dev, **kw):
    from paddle_tpu_torch.serving import ServingEngine

    class Engine(P13Engine, ServingEngine):
        pass

    eng = Engine(model, device=dev, seed=SEED, **{**ENGINE, **kw})
    eng._p13_init()
    return eng


def p13_sampling(i, new=P13_NEW):
    """Request i's sampling in arm A (the same in-process and over HTTP)."""
    from paddle_tpu_torch.serving import GrammarSpec, SamplingParams
    if i in P13_EMBED:
        return SamplingParams(embed=True)
    if i in P13_FORMAT:
        rf = P13_FORMATS[P13_FORMAT.index(i)]
        return SamplingParams(
            max_new_tokens=new, eos_token_id=GRAMMAR_EOS,
            grammar=GrammarSpec(kind=rf["type"],
                                choices=tuple(rf.get("choices") or ())
                                or None))
    return SamplingParams(max_new_tokens=new)


def p13_body(prompt, i, new=P13_NEW):
    if i in P13_EMBED:
        return {"input": prompt.tolist()}
    body = {"prompt": prompt.tolist(), "max_tokens": new}
    if i in P13_FORMAT:
        body.update(eos_token_id=GRAMMAR_EOS,
                    response_format=P13_FORMATS[P13_FORMAT.index(i)])
    return body


def p13_solo(model, dev, prompts, idx, cache, kv="fp") -> dict:
    """Each request of `idx` served alone in-process by one engine on the
    same weights over `kv` pools (its tokens, or its embedding), memoised
    in `cache`. The engine has the grammar gate on, as arm A's replicas:
    with nothing constrained it gives the gate-off tokens and launches."""
    todo = [i for i in idx if (i, kv) not in cache]
    if todo:
        eng = p13_engine(model, dev, grammar=True,
                         **({} if kv == "fp" else dict(kv_dtype=kv)))
        for i in todo:
            out = eng.generate([prompts[i]], p13_sampling(i))[0]
            cache[i, kv] = (out.embedding if i in P13_EMBED
                            else list(out.token_ids))
        eng.drain()
        eng.pool.assert_quiesced()
        del eng
    return {i: cache[i, kv] for i in idx}


def p13_launches(tln, tpa, model, engines) -> dict:
    """The launches a set of engines owes: each one's unified steps times
    the step's launches plus its embed epilogues times an epilogue's."""
    cfg = model.config
    want = _no_launches(tpa)
    for eng in engines:
        per_step = per_step_launches(
            tpa, eng.grouped, eng.kv_dtype, eng.attn_impl, eng.megakernel,
            False, cfg.num_hidden_layers, norm_launches(model))
        per_epi = _no_launches(tpa)
        per_epi["K1"] = norm_launches(model)
        per_epi[DECODE_WALK_OF[eng.kv_dtype]] = cfg.num_hidden_layers
        if WRITE_OF[eng.kv_dtype]:
            per_epi[WRITE_OF[eng.kv_dtype]] = cfg.num_hidden_layers
        steps = eng.metrics.snapshot()["unified_steps"]
        for k in want:
            want[k] += per_step[k] * steps + per_epi[k] * eng.epilogues
    return want


def p13_series_ok(line: str) -> bool:
    """One exposition line: a metric name, optional labels, a number."""
    cut = line.rindex("}") + 1 if "}" in line else line.index(" ")
    name, value = line[:cut], line[cut:].strip()
    if not re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*='
                    r'"(?:[^"\\]|\\.)*",?)*\})?$', name):
        return False
    try:
        float(value)
    except ValueError:
        return False
    return True


def p13_hold(tag, model, prompts, got, want, ties):
    """Streams against the in-process runs (`near_ties`: equal, or the
    first differing token a near tie within HELD_LOGITS_TOL)."""
    ties.extend(dict(arm=tag, **t) for t in near_ties(
        tag, model, prompts, got, {i: want[i] for i in got}, sorted(got),
        HELD_LOGITS_TOL))


def p13_mixed(dev, tln, tpa, model, prompts, solo, ties) -> tuple:
    """Arm A: two replicas behind `serve()`; 8 blocking JSON requests, 6
    SSE streams, 2 response_format requests and 2 embeddings requests at
    once, against the same requests in-process (one engine, all at once)
    and each alone; launches exact; /metrics parses; probes 200."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import GrammarSpec
    from paddle_tpu_torch.serving.http import serve
    idx = P13_JSON + P13_SSE + P13_FORMAT + P13_EMBED
    gen = [i for i in idx if i not in P13_EMBED]
    # in-process, all at once on one engine (TTFT and tokens/s)
    eng = p13_engine(model, dev, grammar=True)
    t0 = time.perf_counter()
    outs = eng.generate([prompts[i] for i in idx],
                        [p13_sampling(i) for i in idx])
    torch.cuda.synchronize()
    inproc_wall = time.perf_counter() - t0
    inproc = {i: o for i, o in zip(idx, outs)}
    eng.drain()
    del eng
    engines = [p13_engine(model, dev, grammar=True) for _ in range(2)]
    server = serve(engines)
    addr = server.server_address[:2]
    try:
        torch.cuda.synchronize()
        reset_counts(tln, tfa, tpa)
        jobs = []
        for i in idx:
            if i in P13_SSE:
                jobs.append(lambda i=i: http_sse(addr, p13_body(prompts[i],
                                                                i)))
            else:
                path = "/v1/embeddings" if i in P13_EMBED else \
                    "/v1/completions"
                jobs.append(lambda i=i, path=path: http_post(
                    addr, p13_body(prompts[i], i), path=path))
        t0 = time.perf_counter()
        res = dict(zip(idx, run_clients(jobs)))
        wall = time.perf_counter() - t0
        metrics_st, text = http_get(addr, "/metrics")
        probes = (http_get(addr, "/healthz")[0], http_get(addr, "/readyz")[0])
    finally:
        server.drain(P13_JOIN_S)
    torch.cuda.synchronize()
    launches = launch_counts_serving(tln, tpa, tfa)
    want = p13_launches(tln, tpa, model, engines)
    if launches != want:
        raise AssertionError(f"[http mixed] launches {launches} != {want}")
    got, client_ttft, engine_ttft, emb_err = {}, [], [], []
    for i in idx:
        r = res[i]
        if i in P13_SSE:
            if r["status"] != 200 or r["final"] is None or \
                    r["final"]["choices"][0]["finish_reason"] != "length":
                raise AssertionError(f"[http mixed] stream {i}: {r}")
            got[i] = r["tokens"]
            client_ttft.append(r["ttft_s"])
            continue
        st, _, body, _ = r
        if st != 200:
            raise AssertionError(f"[http mixed] request {i}: {st} {body}")
        if i in P13_EMBED:
            vec = np.asarray(body["data"][0]["embedding"], np.float32)
            ref = np.asarray(solo[i], np.float32)
            if vec.shape != (model.config.hidden_size,) or \
                    not np.isfinite(vec).all():
                raise AssertionError(f"[http mixed] embedding {i}")
            emb_err.append(float(np.abs(vec - ref).max()))
            if not np.array_equal(vec, ref):
                raise AssertionError(f"[http mixed] embedding {i} differs "
                                     f"from the request alone by "
                                     f"{emb_err[-1]}")
            continue
        ch = body["choices"][0]
        got[i] = ch["token_ids"]
        engine_ttft.append(body["timing"]["ttft_s"])
        if i in P13_FORMAT:
            rf = P13_FORMATS[P13_FORMAT.index(i)]
            spec = GrammarSpec(kind=rf["type"],
                               choices=tuple(rf.get("choices") or ()) or None)
            text_out = "".join(chr(t) for t in got[i] if t != GRAMMAR_EOS)
            ok = (spec.validates(text_out) if ch["finish_reason"] == "stop"
                  else ch["finish_reason"] == "length")
            if not ok:
                raise AssertionError(f"[http mixed] response_format {i}: "
                                     f"{ch['finish_reason']} {text_out!r}")
        elif ch["finish_reason"] != "length" or len(got[i]) != P13_NEW:
            raise AssertionError(f"[http mixed] request {i}: {ch}")
    p13_hold("http mixed", model, prompts, got, solo, ties)
    series = [ln for ln in text.splitlines()
              if ln and not ln.startswith("#")]
    bad = [ln for ln in series if not p13_series_ok(ln)]
    if metrics_st != 200 or bad or probes != (200, 200) or \
            "paddle_serving_replicas_healthy 2" not in text:
        raise AssertionError(f"[http mixed] /metrics {metrics_st}, "
                             f"{bad[:3]}, probes {probes}")
    steps = [e.metrics.snapshot()["unified_steps"] for e in engines]
    tokens = sum(len(t) for t in got.values())
    in_ttft = [inproc[i].ttft_s for i in gen]
    stats = dict(
        requests=len(idx), steps=steps,
        epilogues=[e.epilogues for e in engines],
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        inprocess_wall_s=inproc_wall,
        inprocess_tokens_per_s=sum(len(inproc[i].token_ids) for i in gen)
        / inproc_wall,
        http_client_ttft_ms={"p50": pct(client_ttft, 50) * 1e3,
                             "p90": pct(client_ttft, 90) * 1e3,
                             "n": len(client_ttft)},
        http_engine_ttft_ms={"p50": pct(engine_ttft, 50) * 1e3,
                             "p90": pct(engine_ttft, 90) * 1e3,
                             "n": len(engine_ttft)},
        inprocess_ttft_ms={"p50": pct(in_ttft, 50) * 1e3,
                           "p90": pct(in_ttft, 90) * 1e3, "n": len(in_ttft)},
        embed_max_abs_err=emb_err, metrics_series=len(series),
        served={e: n for e, n in zip(("replica-0", "replica-1"), [
            e.metrics.requests_completed for e in engines])})
    log(f"  [http mixed] {len(idx)} requests over 2 replicas in {wall:.3f} s"
        f" ({stats['tokens_per_s']:.1f} tokens/s; in-process "
        f"{stats['inprocess_tokens_per_s']:.1f}); steps {steps}, epilogues "
        f"{stats['epilogues']}; launches = steps x per-step + epilogues x "
        f"per-epilogue; TTFT ms p50/p90 SSE client "
        f"{stats['http_client_ttft_ms']['p50']:.2f}/"
        f"{stats['http_client_ttft_ms']['p90']:.2f}, engine "
        f"{stats['http_engine_ttft_ms']['p50']:.2f}/"
        f"{stats['http_engine_ttft_ms']['p90']:.2f}, in-process "
        f"{stats['inprocess_ttft_ms']['p50']:.2f}/"
        f"{stats['inprocess_ttft_ms']['p90']:.2f}; embeddings within "
        f"{max(emb_err):.2e} of the in-process ones (bit for bit); /metrics "
        f"{len(series)} series")
    for e in engines:
        e.pool.assert_quiesced()
    del engines
    torch.cuda.empty_cache()
    return launches, stats


def p13_streams(addr, prompts, idx, on_start=None) -> dict:
    """SSE streams of `idx` at once; `on_start` runs beside them."""
    jobs = [lambda i=i: http_sse(addr, p13_body(prompts[i], i)) for i in idx]
    if on_start is not None:
        jobs.append(on_start)
    res = run_clients(jobs)
    return dict(zip(idx, res[:len(idx)]))


def p13_check_streams(tag, res, moved):
    """Each stream ended "length" with its budget; those on the lost
    replica report usage.migrations >= 1."""
    for i, r in res.items():
        fin = r["final"]
        if r["status"] != 200 or fin is None or \
                fin["choices"][0]["finish_reason"] != "length" or \
                len(r["tokens"]) != P13_NEW or \
                fin["usage"]["completion_tokens"] != P13_NEW:
            raise AssertionError(f"[{tag}] stream {i}: {r}")
        if r["id"] in moved and fin["usage"]["migrations"] < 1:
            raise AssertionError(f"[{tag}] stream {i} moved without "
                                 "usage.migrations")
    return sum(r["final"]["usage"]["migrations"] for r in res.values())


def p13_migration(dev, model, prompts, solo, ties) -> dict:
    """Arm B: a kill of replica-0 with at least four of its streams
    mid-decode, then a hang of replica-0 under the watchdog."""
    from paddle_tpu_torch.serving import FaultInjector
    from paddle_tpu_torch.serving.http import ReplicaHung, serve
    out = {}
    for fault in ("kill", "hang"):
        idx = P13_MIGRATE if fault == "kill" else P13_HANG
        need = 4 if fault == "kill" else 2
        inj = FaultInjector()
        engines = [p13_engine(model, dev) for _ in range(2)]
        server = serve(engines, faults=inj,
                       watchdog_timeout_s=P13_WATCHDOG_S)
        addr = server.server_address[:2]
        d0 = server.router.drivers[0]
        moved, fired = [], {}

        def trigger():
            wait_for(lambda: len(mid_decode(engines[0])) >= need,
                     what=f"{need} streams mid-decode on replica-0")
            moved.extend(mid_decode(engines[0]))
            fired["t"] = time.monotonic()
            fired["step"] = d0.steps
            if fault == "kill":
                inj.kill_at_step("replica-0", 0)
            else:
                inj.hang_at_step("replica-0", 0, 10 * P13_JOIN_S)
            fired["detect_s"] = wait_for(lambda: d0.dead,
                                         what=f"replica-0 {fault} seen")

        try:
            t0 = time.perf_counter()
            res = p13_streams(addr, prompts, idx, on_start=trigger)
            wall = time.perf_counter() - t0
            migrations = p13_check_streams(f"http {fault}", res, moved)
            death = type(d0.death_exc).__name__
            if fault == "hang":
                if not isinstance(d0.death_exc, ReplicaHung):
                    raise AssertionError(f"[http hang] death {death}")
                wd = server.router._watchdog_interval_s
                if fired["detect_s"] > P13_WATCHDOG_S + wd + 0.5:
                    raise AssertionError(
                        f"[http hang] condemned after {fired['detect_s']} s")
            stats = dict(streams=len(idx), on_lost_replica=len(moved),
                         migrations=migrations,
                         migrations_total=server.router.migrations_total,
                         retries_total=server.router.retries_total,
                         watchdog_kills=server.router.watchdog_kills_total,
                         death=death, fired_at_step=fired["step"],
                         detect_s=fired["detect_s"], wall_s=wall)
        finally:
            inj.release_hangs()
            server.drain(P13_JOIN_S)
        p13_hold(f"http {fault}", model, prompts,
                 {i: r["tokens"] for i, r in res.items()}, solo, ties)
        log(f"  [http {fault}] {len(idx)} SSE streams, {len(moved)} "
            f"mid-decode on replica-0 at its {fault} (step "
            f"{fired['step']}): every stream ended with its {P13_NEW} tokens,"
            f" {migrations} migrations reported ({death} seen after "
            f"{fired['detect_s']:.3f} s; watchdog {P13_WATCHDOG_S} s)")
        out[fault] = stats
        engines[1].pool.assert_quiesced()
        del engines
        torch.cuda.empty_cache()
    return out


def p13_handoff(dev, tln, tpa, model, prompts, solo_cache, ties) -> tuple:
    """Arm C: `Router(fabric=FabricConfig(roles=...))` behind a
    `ServingHTTPServer`: each prompt prefills on replica-0 at a one-token
    budget, its pages move as a frame, replica-1 continues; in bf16 and
    int8 pools."""
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.serving import FabricConfig
    from paddle_tpu_torch.serving.http import (EngineDriver, Router,
                                               ServingHTTPServer)
    by_path, out = {}, {}
    ps = ENGINE["page_size"]
    for kv in ("fp", "int8"):
        kw = {} if kv == "fp" else dict(kv_dtype=kv)
        want = p13_solo(model, dev, prompts, P13_HANDOFF, solo_cache, kv)
        engines = [p13_engine(model, dev, **kw) for _ in range(2)]
        router = Router(
            [EngineDriver(e, name=f"replica-{n}")
             for n, e in enumerate(engines)],
            fabric=FabricConfig(roles={"replica-0": "prefill",
                                       "replica-1": "decode"}))
        server = ServingHTTPServer(router, "127.0.0.1", 0).start()
        addr = server.server_address[:2]
        try:
            torch.cuda.synchronize()
            reset_counts(tln, tfa, tpa)
            res = dict(zip(P13_HANDOFF, run_clients([
                lambda i=i: http_post(addr, p13_body(prompts[i], i))
                for i in P13_HANDOFF])))
            fab = router.stats()["fabric"]
        finally:
            server.drain(P13_JOIN_S)
        torch.cuda.synchronize()
        launches = launch_counts_serving(tln, tpa, tfa)
        if launches != p13_launches(tln, tpa, model, engines):
            raise AssertionError(f"[http handoff {kv}] launches {launches}")
        pages = sum(prompts[i].size // ps for i in P13_HANDOFF)
        got = {}
        for i, (st, _, body, _) in res.items():
            ch = body["choices"][0] if st == 200 else None
            if ch is None or ch["finish_reason"] != "length" or \
                    len(ch["token_ids"]) != P13_NEW:
                raise AssertionError(f"[http handoff {kv}] {i}: {body}")
            got[i] = ch["token_ids"]
        if (fab["handoffs_total"], fab["pages_moved_total"],
                fab["transfer_failures_total"]) != (len(P13_HANDOFF), pages,
                                                    0):
            raise AssertionError(f"[http handoff {kv}] fabric {fab}, "
                                 f"{pages} full pages")
        p13_hold(f"http handoff {kv}", model, prompts, got, want, ties)
        exports, imports = engines[0].exports, engines[1].imports
        out[kv] = dict(handoffs=fab["handoffs_total"],
                       pages_moved=fab["pages_moved_total"],
                       frame_bytes=[b for _, b in exports],
                       export_ms=[ms for ms, _ in exports],
                       import_ms=[ms for ms, _ in imports],
                       steps=[e.metrics.snapshot()["unified_steps"]
                              for e in engines])
        log(f"  [http handoff {kv}] {fab['handoffs_total']} hand-offs, "
            f"{fab['pages_moved_total']} pages moved (the prompts' full "
            f"pages); frames {out[kv]['frame_bytes']} B, export ms "
            f"{[round(x, 3) for x in out[kv]['export_ms']]}, import ms "
            f"{[round(x, 3) for x in out[kv]['import_ms']]}; launches = "
            f"steps {out[kv]['steps']} x per-step")
        by_path[f"http_handoff_{kv}"] = launches
        for e in engines:
            e.pool.assert_quiesced()
        del engines
        torch.cuda.empty_cache()
    return by_path, out


def p13_restart(dev, model, prompts) -> dict:
    """Arm D: `serve()` under PADDLE_TPU_KV_FABRIC=on. A prompt is served,
    then served again where affinity places it (the replica that holds
    it: its cached tokens are the warm figure); that replica is removed
    (its tree stashed), a new one added (restored), the other removed:
    the prompt on the new replica reports the warm figure's cached
    tokens, at least its full pages, with the first answer's tokens."""
    import os
    from paddle_tpu_torch.serving.http import serve
    prompt = prompts[P13_RESTART]
    full = prompt.size // ENGINE["page_size"] * ENGINE["page_size"]
    old = os.environ.get("PADDLE_TPU_KV_FABRIC")
    os.environ["PADDLE_TPU_KV_FABRIC"] = "on"
    try:
        server = serve([p13_engine(model, dev) for _ in range(2)])
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_KV_FABRIC")
        else:
            os.environ["PADDLE_TPU_KV_FABRIC"] = old
    addr = server.server_address[:2]
    router = server.router
    try:
        body = {"prompt": prompt.tolist(), "max_tokens": 8}
        answers = [http_post(addr, body)]
        router.refresh_fabric_summaries()
        answers.append(http_post(addr, body))
        served = [d for d in router.drivers
                  if d.engine.metrics.requests_completed]
        router.remove_replica(served[0].name, wait=True)
        new = router.add_replica(p13_engine(model, dev))
        restored = new.engine.metrics.fabric_restored_pages
        other = next(d for d in router.drivers if d is not new)
        router.remove_replica(other.name, wait=True)
        answers.append(http_post(addr, body))
    finally:
        server.drain(P13_JOIN_S)
    cached = [a[2]["usage"]["cached_tokens"] for a in answers]
    same = all(a[2]["choices"][0]["token_ids"]
               == answers[0][2]["choices"][0]["token_ids"] for a in answers)
    if [a[0] for a in answers] != [200] * 3 or len(served) != 1 or \
            restored <= 0 or cached[0] != 0 or cached[2] != cached[1] or \
            cached[2] < full or not same:
        raise AssertionError(f"[http restart] statuses "
                             f"{[a[0] for a in answers]}, served by "
                             f"{[d.name for d in served]}, restored "
                             f"{restored}, cached {cached} (full pages "
                             f"{full}), tokens equal {same}")
    log(f"  [http restart] {served[0].name} served the prompt of "
        f"{prompt.size} tokens twice (cached {cached[0]}, then {cached[1]} "
        f"where affinity placed it), was removed and its tree stashed; "
        f"{new.name} restored {restored} pages; the prompt there: cached "
        f"{cached[2]} ({full} in full pages), tokens equal {same}")
    return dict(restored_pages=restored, cached_tokens=cached,
                full_page_tokens=full, tokens_equal=same)


def p13_overload(dev, model, prompts) -> dict:
    """Arm E on one replica of one slot and a queue of one, with the rate
    limiter and the control plane on: the limiter's 429, a deadline's
    504, an infeasible deadline's 429, a full queue's 429, then `drain()`
    (/readyz 503 at once, the resident finishes)."""
    from paddle_tpu_torch.serving import SamplingParams
    from paddle_tpu_torch.serving.http import serve
    eng = p13_engine(model, dev, num_slots=1, max_queue=1)
    server = serve([eng], controller=True, **P13_RATE)
    addr = server.server_address[:2]
    drv = server.router.drivers[0]
    small = {"prompt": prompts[P13_BLOCKER["prompt"]][:16].tolist(),
             "max_tokens": 4}
    codes, blocker, filler = {}, {}, None
    try:
        codes["first"] = http_post(addr, small, key="flood")
        codes["rate_limited"] = http_post(addr, small, key="flood")
        import threading
        bt = threading.Thread(target=lambda: blocker.setdefault(
            "r", http_sse(addr, {
                "prompt": prompts[P13_BLOCKER["prompt"]].tolist(),
                "max_tokens": P13_BLOCKER["new"]}, key="blocker")),
            daemon=True)
        bt.start()
        wait_for(lambda: len(mid_decode(eng)) == 1, what="the resident")
        codes["deadline"] = http_post(addr, {**small, "deadline": 0.05},
                                      key="d504")
        filler = drv.submit(prompts[1][:32], SamplingParams(max_new_tokens=4))
        wait_for(lambda: drv.stats()["queue_depth"] == 1,
                 what="a queued request")
        codes["infeasible"] = http_post(addr, {**small, "deadline": 0.01},
                                        key="dinf")
        codes["queue_full"] = http_post(addr, small, key="full")
        dt = threading.Thread(target=server.drain, args=(P13_JOIN_S,),
                              daemon=True)
        t0 = time.monotonic()
        dt.start()
        wait_for(lambda: not server.accepting, timeout=5.0, what="draining")
        readyz = http_get(addr, "/readyz")[0]
        readyz_s = time.monotonic() - t0
        dt.join(P13_JOIN_S)
        bt.join(P13_JOIN_S)
        if dt.is_alive() or bt.is_alive():
            raise AssertionError("[http overload] drain did not end")
    finally:
        server.drain(P13_JOIN_S)
    want = {"first": (200, None), "rate_limited": (429, "rate_limit_exceeded"),
            "deadline": (504, "deadline_exceeded"),
            "infeasible": (429, "deadline_infeasible"),
            "queue_full": (429, "rate_limit_exceeded")}
    got = {k: (v[0], v[2].get("error", {}).get("type")) for k, v in
           codes.items()}
    retry = {k: codes[k][1].get("Retry-After") for k in
             ("rate_limited", "infeasible", "queue_full")}
    fin = blocker["r"]["final"]
    if got != want or not all(int(r or 0) >= 1 for r in retry.values()) or \
            readyz != 503 or fin is None or \
            fin["choices"][0]["finish_reason"] != "length" or \
            len(blocker["r"]["tokens"]) != P13_BLOCKER["new"] or \
            not filler.wait(P13_JOIN_S):
        raise AssertionError(f"[http overload] {got}, Retry-After {retry}, "
                             f"readyz {readyz}, resident {fin}")
    eng.pool.assert_quiesced()
    ctrl = server.router.controller.stats()
    log(f"  [http overload] statuses {got}; Retry-After {retry}; the "
        f"controller shed {ctrl['admission_shed_total']}; drain: /readyz "
        f"503 after {readyz_s:.3f} s, the resident finished its "
        f"{P13_BLOCKER['new']} tokens, the queued request "
        f"{filler.finish_reason}")
    return dict(statuses={k: v[0] for k, v in got.items()},
                retry_after=retry, readyz_503_s=readyz_s,
                shed=ctrl["admission_shed_total"],
                queued_finish=filler.finish_reason)


def phase13(dev, tln, tpa) -> tuple:
    """Phase 13 on GPT-124M's first GRAMMAR_GPT_LAYERS layers (bf16,
    random weights from SEED) behind the port's HTTP front end: arms A-E."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import make_draft_model
    t0 = time.perf_counter()
    full = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                          dtype=torch.bfloat16, seed=SEED).eval()
    model = make_draft_model(full, GRAMMAR_GPT_LAYERS)
    del full
    torch.cuda.empty_cache()
    prompts = make_traffic(model.config.vocab_size)
    cache, ties, stats, secs = {}, [], {}, {}
    idx = P13_JSON + P13_SSE + P13_FORMAT + P13_EMBED + P13_HANG
    solo = p13_solo(model, dev, prompts, sorted(set(idx + P13_MIGRATE
                                                    + P13_HANDOFF)), cache)
    secs["solo"] = time.perf_counter() - t0
    t = time.perf_counter()
    launches, stats["mixed"] = p13_mixed(dev, tln, tpa, model, prompts, solo,
                                         ties)
    by_path = {"http_mixed": launches}
    secs["mixed"] = time.perf_counter() - t
    t = time.perf_counter()
    stats["migration"] = p13_migration(dev, model, prompts, solo, ties)
    secs["migration"] = time.perf_counter() - t
    t = time.perf_counter()
    hand_paths, stats["handoff"] = p13_handoff(dev, tln, tpa, model, prompts,
                                               cache, ties)
    by_path.update(hand_paths)
    secs["handoff"] = time.perf_counter() - t
    t = time.perf_counter()
    stats["restart"] = p13_restart(dev, model, prompts)
    stats["overload"] = p13_overload(dev, model, prompts)
    secs["restart_overload"] = time.perf_counter() - t
    secs["all"] = time.perf_counter() - t0
    stats["near_ties"] = ties
    stats["seconds"] = secs
    del model
    torch.cuda.empty_cache()
    log(f"  phase 13: {secs['all']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in secs.items() if k != 'all')}); "
        f"near ties {len(ties)}")
    return by_path, stats


# -- phase 4: train GPT-124M -------------------------------------------------
def launch_counts(tln, tfa) -> dict:
    return {"K1": tln.LAUNCHES, "K2": tln.BWD_LAUNCHES,
            "K3": tfa.LAUNCHES["fwd"], "K4": tfa.LAUNCHES["dq"],
            "K5": tfa.LAUNCHES["dkv"]}


def reset_counts(tln, tfa, tpa):
    for mod in (tln, tfa, tpa):
        if mod is not None:
            mod.reset_launches()


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
    no kernel launches: the reference of the held step. With
    `fault_module`, a planted fault: every attention call inside that
    module (its forward and a recompute's rerun alike) masks each
    query's own key, its last under the causal mask (query 0 keeps its
    one key)."""

    def __init__(self, fault_module=None):
        self.fault_module = fault_module

    def __enter__(self):
        from paddle_tpu_torch.nn.functional import attention, norm
        from paddle_tpu_torch.ops.cuda import flash_attention as tfa
        from paddle_tpu_torch.ops.cuda import layer_norm as tln

        class PlainLayerNorm:
            apply = staticmethod(tln.layer_norm_reference)

        inside = []

        def plain_attention(q, k, v, bias=None, *a, **kw):
            if inside:
                lq, lk = q.shape[1], k.shape[1]
                own = torch.eye(lq, lk, dtype=torch.bool, device=q.device)
                own[0, 0] = False
                fault = torch.zeros(lq, lk, device=q.device).masked_fill(
                    own, -1e30)[None, None]
                bias = fault if bias is None else bias + fault
            return tfa.flash_attention_reference(q, k, v, bias, *a, **kw)[0]

        self.saved = [(norm, "LayerNormFunction", norm.LayerNormFunction),
                      (attention, "flash_attention_blhd",
                       attention.flash_attention_blhd)]
        norm.LayerNormFunction = PlainLayerNorm
        attention.flash_attention_blhd = plain_attention
        self.hooks = []
        if self.fault_module is not None:
            self.hooks = [
                self.fault_module.register_forward_pre_hook(
                    lambda *_: inside.append(True)),
                self.fault_module.register_forward_hook(
                    lambda *_: inside.clear())]
        return self

    def __exit__(self, *exc):
        for hook in self.hooks:
            hook.remove()
        for mod, name, value in self.saved:
            setattr(mod, name, value)
        return False


class plain_serving(plain_path):
    """`plain_path` plus the paged walks and the int8 write: within it a
    unified step, or a legacy decode step, on the card runs the plain
    versions (`update_and_attend`'s ungrouped branches) and launches no
    kernel. With `short_window`, a planted fault: every walk's query
    sees one key fewer (its window ends at pos - 1 + i, pos 0 kept)."""

    def __init__(self, short_window: bool = False):
        super().__init__()
        self.short_window = short_window

    def __enter__(self):
        super().__enter__()
        from paddle_tpu_torch.nlp import generation
        from paddle_tpu_torch.ops.cuda import paged_attention as tpa

        def q8_pair(k_pool, v_pool, k_scale, v_scale, k_upd, v_upd, pos,
                    table):
            tpa.paged_scatter_q8_reference(k_pool, k_scale, k_upd, pos, table)
            tpa.paged_scatter_q8_reference(v_pool, v_scale, v_upd, pos, table)
            return k_pool, v_pool, k_scale, v_scale

        def decode(q, k_pool, v_pool, table, pos, mask=None):
            if mask is not None:
                mask = tpa._mask_to_additive(mask, q.shape[0], q.shape[2],
                                             table.shape[1] * k_pool.shape[1])
            return tpa.paged_attention_reference(q, k_pool, v_pool, table,
                                                 pos, mask)

        def walk(fn, at):
            """`fn`, whose argument `at` is pos, or with `short_window`
            the planted fault."""
            if not self.short_window:
                return fn
            return lambda *a, **kw: fn(*a[:at], (a[at] - 1).clamp(min=0),
                                       *a[at + 1:], **kw)

        for name, fn in (
                ("ragged_paged_attention",
                 walk(tpa.ragged_attention_reference, 4)),
                ("ragged_paged_attention_q8",
                 walk(tpa.ragged_attention_reference_q8, 6)),
                ("paged_decode_attention", walk(decode, 4)),
                ("paged_scatter_q8_pair", q8_pair)):
            self.saved.append((generation, name, getattr(generation, name)))
            setattr(generation, name, fn)
        return self


def held_step(dev, cfg, state, ids, labels, tln, tfa, model_cls=None,
              fault_module=None) -> dict:
    """Loss and gradients of one step in f32, through the kernels and
    through the plain versions, on the card; and the bf16 kernel loss
    against the f32 plain loss. `model_cls` defaults to GPT; with
    `fault_module(model)`, the module whose attention `plain_path`
    faults, a third plain pass with that planted fault, which the same
    rule must catch (reported beside the held figures)."""
    from paddle_tpu_torch.nlp import GPTForCausalLM

    def loss_and_grads(model):
        loss = model(ids, labels=labels)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    def worst(grads, ref):
        return max(((grads[n] - g).abs().max().item() /
                    max(g.abs().max().item(), 1e-30), n)
                   for n, g in ref.items())

    model = (model_cls or GPTForCausalLM)(cfg, device=dev,
                                          dtype=torch.float32, seed=SEED)
    model.load_state_dict(state)
    loss_k, grads_k = loss_and_grads(model)
    before = launch_counts(tln, tfa)
    with plain_path():
        loss_p, grads_p = loss_and_grads(model)
    if launch_counts(tln, tfa) != before:
        raise AssertionError("the plain path launched a kernel")
    worst_k = worst(grads_k, grads_p)
    fault = None
    if fault_module is not None:
        with plain_path(fault_module(model)):
            loss_f, grads_f = loss_and_grads(model)
        fw = worst(grads_f, grads_p)
        del grads_f
        fault = {"loss": loss_f,
                 "loss_rel_err": abs(loss_f - loss_p) / abs(loss_p),
                 "grad_worst_rel": fw[0], "grad_worst_param": fw[1]}
        fault["caught"] = not (fault["loss_rel_err"] <= HELD_LOSS_RTOL
                               and fw[0] <= HELD_GRAD_TOL)
    del grads_k, grads_p
    with torch.no_grad():
        loss_b = model.to(torch.bfloat16)(ids, labels=labels).item()
    out = {"loss_kernel_f32": loss_k, "loss_plain_f32": loss_p,
           "loss_kernel_bf16": loss_b, "grad_worst_rel": worst_k[0],
           "grad_worst_param": worst_k[1]}
    log(f"  held step [{ids.shape[0]}, {ids.shape[1]}]: f32 loss kernel "
        f"{loss_k:.6f} vs plain {loss_p:.6f} (rtol {HELD_LOSS_RTOL}); "
        f"worst gradient error {worst_k[0]:.3e} of its max in {worst_k[1]} "
        f"(tolerance {HELD_GRAD_TOL}); bf16 kernel loss {loss_b:.4f} vs "
        f"f32 plain (tolerance {HELD_BF16_LOSS_TOL})")
    if fault is not None:
        out["planted_fault"] = fault
        log(f"  planted fault (each query's own key masked in one layer): "
            f"loss {fault['loss']:.6f}, rel err {fault['loss_rel_err']:.3e}"
            f", worst gradient error {fault['grad_worst_rel']:.3e} in "
            f"{fault['grad_worst_param']}: caught {fault['caught']}")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <=
            HELD_LOSS_RTOL * abs(loss_p)):
        raise AssertionError("held f32 loss: kernel path != plain path")
    if not worst_k[0] <= HELD_GRAD_TOL:
        raise AssertionError(f"held gradient of {worst_k[1]} disagrees")
    if not abs(loss_b - loss_p) <= HELD_BF16_LOSS_TOL:
        raise AssertionError("held bf16 loss disagrees with the f32 plain")
    if fault is not None and not fault["caught"]:
        raise AssertionError("the held step's rule missed the planted fault")
    return out


# -- phase 6: head dims off and on the flash kernels' set ---------------------
def head_dim_phase(dev, tln, tfa, tpa, d: int) -> dict:
    """A 2-layer GPT at head dim `d` (HEAD_DIM_GPTS), bf16, random weights
    from the seed: the legacy step and the gather arm serve 8 of phase 3's
    prompts (16 new tokens each), `generate()` decodes [4, 64] + 16 tokens
    and one bench-style train step runs on [2, 1024]. At head dim 256 K3
    runs on the legacy chunks, the gather arm and generate() and K3-K5 in
    the train step; at 32 the route is the plain `_sdpa_ref` and no flash
    kernel launches. The prefill logits of a forward are held against a
    plain f32 rerun on the CPU (0.1). Returns the route and the stats."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn.functional.attention import uses_flash_kernel
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = GPTConfig(**HEAD_DIM_GPTS[d], hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    flash = uses_flash_kernel(d)
    route = "flash attention (K3-K5)" if flash else "_sdpa_ref (plain)"
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                           seed=SEED).eval()
    prompts = make_traffic()[:8]
    stats = {"route": route}
    reset_counts(tln, tfa, tpa)
    for name, opts in (("legacy", dict(unified=False)),
                       ("gather", dict(attn_impl="gather"))):
        eng = ServingEngine(model, device=dev, seed=SEED, **opts, **ENGINE)
        t0 = time.perf_counter()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=16))
        torch.cuda.synchronize()
        stats[name + "_wall_s"] = time.perf_counter() - t0
        if any(len(r.token_ids) != 16 for r in res):
            raise AssertionError(f"head dim {d} {name}: a request did not "
                                 "finish")
    rs = np.random.RandomState(SEED + 4)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 64))).to(dev)
    out = model.generate(ids, max_new_tokens=16)
    serving = dict(launch_counts_serving(tln, tpa, tfa))
    with torch.no_grad():
        logits = model(ids[:1]).float()
        plain = copy.deepcopy(model).float().cpu()(ids[:1].cpu()).float()
    err = (logits.cpu() - plain).abs().max().item()
    model.train()
    opt = optimizer.AdamW(learning_rate=TRAIN["lr"],
                          parameters=model.named_parameters(),
                          weight_decay=TRAIN["weight_decay"])
    step = jit.compile_train_step(
        lambda i, lab: model(i, labels=lab), model, opt)
    tr = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 1024))).to(dev)
    reset_counts(tln, tfa, tpa)
    loss = step(tr, tr).item()
    torch.cuda.synchronize()
    train = launch_counts(tln, tfa)
    n_layers = cfg.num_hidden_layers
    want_train = {"K1": 2 * n_layers + 1, "K2": 2 * n_layers + 1,
                  "K3": n_layers if flash else 0,
                  "K4": n_layers if flash else 0,
                  "K5": n_layers if flash else 0}
    stats.update(serving_launches={k: n for k, n in serving.items() if n},
                 train_launches=train, train_loss=loss,
                 prefill_logits_max_abs_err=err)
    log(f"  head dim {d} ({cfg.num_attention_heads} heads of {d}, 2 layers, "
        f"bf16): route {route}; legacy, gather arm and generate() launches "
        f"{stats['serving_launches']}; train step launches {train}, loss "
        f"{loss:.4f}; prefill logits vs plain f32 rerun max_abs_err="
        f"{err:.4f} (tolerance {HELD_LOGITS_TOL})")
    if (serving["K3"] > 0) is not flash or train != want_train:
        raise AssertionError(f"head dim {d} took the wrong route: "
                             f"{serving}, {train}")
    if out.shape != (4, 80) or not math.isfinite(loss) or \
            err > HELD_LOGITS_TOL:
        raise AssertionError(f"head dim {d}: wrong output")
    return stats


# phase 7: one decoder layer of GPT-3 13B's width (Brown et al. 2020,
# Table 2.1: hidden 5120, 40 heads of 128, 2048 positions), cut in depth
# only, bf16: its LayerNorms take the wide lanes of K1 and K2
GPT3_WIDTH = dict(vocab_size=50304, hidden_size=5120, num_hidden_layers=1,
                  num_attention_heads=40, max_position_embeddings=2048)
GPT3_TRAIN = dict(batch=2, seq=1024, held_batch=1)


def gpt3_width_phase(dev, tln, tfa) -> tuple:
    """A 1-layer GPT at GPT3_WIDTH in bf16, random weights from the
    seed: two bench-style train steps on [2, 1024] through
    `jit.compile_train_step` (K1 and K2 through their wide lanes, 3 each a
    step, and K3-K5 once each; the first loss near what random weights
    give), then the held step on [1, 1024]: the kernel path's f32 loss and gradients
    against the plain path's on the card. Returns (the second step's
    launches, stats)."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**GPT3_WIDTH, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    rows = GPT3_TRAIN["batch"] * GPT3_TRAIN["seq"]
    lanes = (tln.layer_norm_plan(rows, cfg.hidden_size, torch.bfloat16, dev),
             tln.layer_norm_bwd_plan(rows, cfg.hidden_size, torch.bfloat16,
                                     dev))
    if not all(p["wide"] for p in lanes):
        raise AssertionError(f"GPT-3 width: LayerNorm not in the wide lanes "
                             f"{lanes}")
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    opt = optimizer.AdamW(learning_rate=TRAIN["lr"],
                          parameters=model.named_parameters(),
                          weight_decay=TRAIN["weight_decay"])
    step = jit.compile_train_step(
        lambda ids, labels: model(ids, labels=labels), model, opt)
    rs = np.random.RandomState(SEED + 7)
    shape = (GPT3_TRAIN["batch"], GPT3_TRAIN["seq"])
    ids, labels = (torch.from_numpy(rs.randint(0, cfg.vocab_size, shape)
                                    ).to(dev) for _ in range(2))
    first = step(ids, labels).item()
    torch.cuda.synchronize()
    reset_counts(tln, tfa, None)
    t0 = time.perf_counter()
    loss = step(ids, labels).item()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(tln, tfa)
    want = {"K1": 3, "K2": 3, "K3": 1, "K4": 1, "K5": 1}
    # random weights: logits of variance hidden x range^2 about a
    # uniform guess, so the first loss is near ln V + that / 2 (11.85 at
    # this width; GPT-124M's 10.98, its first loss)
    lnv = math.log(cfg.vocab_size) + \
        cfg.hidden_size * cfg.initializer_range ** 2 / 2
    log(f"  GPT-3 13B width, 1 layer, bf16, [{shape[0]}, {shape[1]}]: "
        f"losses {first:.4f}, {loss:.4f}; step {wall * 1e3:.2f} ms; "
        f"launches {launches} (want {want}); LayerNorm lanes {lanes}")
    if launches != want:
        raise AssertionError(f"GPT-3 width: launches {launches} != {want}")
    if not (math.isfinite(loss) and abs(first - lnv) <= 0.5):
        raise AssertionError(f"GPT-3 width: loss {first} not near {lnv:.3f}")
    state = {k: v.float() for k, v in model.state_dict().items()}
    del model, opt, step
    torch.cuda.empty_cache()
    n = GPT3_TRAIN["held_batch"]
    held = held_step(dev, cfg, state, ids[:n], labels[:n], tln, tfa)
    return launches, {"losses": [first, loss], "step_ms": wall * 1e3,
                      "lanes": lanes, "held": held}


# phase 9: Llama trained at Llama-7B's widths (`LlamaConfig()`: vocab
# 32000, hidden 4096, 32 heads of 128, intermediate 11008) with 2048
# positions and recompute, as scripts/scale_compile_check.py:100 builds
# it, cut to 4 of its 32 layers (full depth needs ~81 GB before
# activations: 6.7e9 parameters x 12 bytes); AdamW under a warm-up and
# cosine schedule with global-norm clipping, as a pretraining run sets it
LLAMA_TRAIN = dict(num_hidden_layers=4, max_position_embeddings=2048,
                   use_recompute=True)
LLAMA_TRAIN_RUN = dict(batch=2, seq=2048, steps=3, merge_batch=4,
                       accumulate=2, held_batch=1, lr=1e-4, t_max=10,
                       warmup=2, weight_decay=0.01, clip=1.0)
# the GQA arm: Llama-3-8B's widths (LLAMA3_GQA) cut to 2 layers, trained
# with recompute on [1, 2048]
LLAMA3_GQA_TRAIN = dict(LLAMA3_GQA, num_hidden_layers=2,
                        max_position_embeddings=2048, use_recompute=True)
# K3-K5 in phase 2 at one row of phase 9's step, [B, L, H, D]
LLAMA_TRAIN_FLASH = (1, 2048, 32, 128)


def llama_optimizer(model):
    """AdamW(LinearWarmup(CosineAnnealingDecay(lr, T_max), warmup, 0 ->
    lr), weight_decay, grad_clip=ClipGradByGlobalNorm(clip)) over the
    model's named parameters, and the scheduler."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    run, lr = LLAMA_TRAIN_RUN, optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(run["lr"],
                                                    T_max=run["t_max"]),
                            warmup_steps=run["warmup"], start_lr=0.0,
                            end_lr=run["lr"])
    opt = optimizer.AdamW(sched, parameters=model.named_parameters(),
                          weight_decay=run["weight_decay"],
                          grad_clip=ClipGradByGlobalNorm(run["clip"]))
    return opt, sched


def state_bytes(n_params: int) -> dict:
    """What the train step holds a parameter, bf16 weights and AdamW
    without multi_precision (no master weights): weights and gradients
    (2 bytes each), the clip's scaled copy of the gradients (2), the f32
    moments (8), and in the update (`optimizer/adam.py`) Adam's f32 copy
    of every gradient (4) and, at most, 8 bytes of f32 lists at once
    (that copy with one new moment list, then the denom and step lists)."""
    return {"parameters": n_params, "weights": 2 * n_params,
            "gradients": 2 * n_params, "clipped_gradients": 2 * n_params,
            "moments": 8 * n_params, "adam_f32_gradient_copy": 4 * n_params,
            "adam_update_peak": 8 * n_params, "master_weights": 0}


def saved_activation_bytes(cfg, tokens: int) -> dict:
    """The reckoning of what the decoder layers keep for the backward,
    bf16, by the port's ops. A token a layer: each of the two RMSNorms
    (`nn.functional.rms_norm`) keeps its f32 input and f32 normalised x
    (8h) and rsqrt (4) and its bf16 output, the projections' input (2h);
    rope keeps only its shared cos and sin tables; K3 keeps q, k and v as
    it sees them (k and v repeated over the groups: 6h) and o, o_proj's
    input (2h), and lse (4 H); SwiGLU keeps gate, silu(gate), up and
    their product (8i): 28h + 8i + 4H + 8 bytes. With recompute a layer
    keeps only its input (2h)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_token = 28 * h + 8 * i + 4 * cfg.num_attention_heads + 8
    layers = cfg.num_hidden_layers
    return {"per_token_layer": per_token,
            "no_recompute": per_token * tokens * layers,
            "recompute": 2 * h * tokens * layers,
            "freed": (per_token - 2 * h) * tokens * layers}


def activation_memory(model, ids, labels) -> int:
    """Bytes allocated by a training forward with labels, taken after the
    loss and before any backward (the loss is then dropped)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss = model(ids, labels=labels)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    if not torch.isfinite(loss):
        raise AssertionError(f"training forward: loss {loss.item()}")
    del loss
    return held


def train_flops(cfg, n_params: int, seq: int) -> tuple:
    """bench.py's model FLOPs a token, 6 N + 12 layers h s, and with
    recompute the hardware's: its rerun of each layer's forward adds 2 N
    of the layers' weights and 4 layers h s (the embedding, the final
    norm and the head are not rerun)."""
    layers, h = cfg.num_hidden_layers, cfg.hidden_size
    model = 6 * n_params + 12 * layers * h * seq
    layer_params = n_params - 2 * cfg.vocab_size * h - h
    rerun = 2 * layer_params + 4 * layers * h * seq
    return model, model + (rerun if cfg.use_recompute else 0)


def timed_step(step, batch, tln, tfa) -> dict:
    """One train step from launch counts at 0 and a fresh peak: the loss,
    the step's host time to a device sync, its launches and the peak of
    allocated memory over the step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tln, tfa, None)
    t0 = time.perf_counter()
    loss = step(*batch).item()
    torch.cuda.synchronize()
    return {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
            "launches": launch_counts(tln, tfa),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def llama_train_phase(dev, tln, tfa) -> tuple:
    """Phase 9: Llama trained at Llama-7B's widths (4 layers, 2048
    positions, recompute; bf16, random weights from SEED) through
    `jit.compile_train_step` with `llama_optimizer`. Arm A: three steps on
    [2, 2048], the caller stepping the scheduler (the lr each step reads
    is the scheduler's; K3 8, K4 4, K5 4 a step and no K1 or K2; the first
    loss near ln V + h range^2 / 2), then a profiled step. Arm B: the same
    model without recompute, its training forward's memory against arm
    A's (the difference at least half of `saved_activation_bytes`'s
    freed figure) and one step (K3, K4, K5 4 each). Arm C: one
    accumulate_steps=2 step on [4, 2048] (K3 16, K4 8, K5 8; the loss the
    mean of the micro-batch losses). The held step: arm A's weights in
    f32 on a fresh [1, 2048] batch (four steps on one batch memorise
    it), kernel path against plain path by phase 7's rule, with a
    planted fault that rule must catch. The GQA arm: Llama-3-8B's
    widths, 2 layers, one recompute step on [1, 2048] (K3 4, K4 2, K5 2),
    its K/V gradients through `repeat_interleave`. Each arm's model,
    optimizer and step are freed before the next. Returns the launches
    of each arm's (last) step, by path, and the stats."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    run = LLAMA_TRAIN_RUN
    t_phase = time.perf_counter()
    by_path, stats = {}, {}
    rs = np.random.RandomState(SEED + 9)

    def batch(cfg, b):
        return tuple(torch.from_numpy(rs.randint(
            0, cfg.vocab_size, (b, run["seq"]))).to(dev) for _ in range(2))

    def build(cfg):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=SEED).train()
        return model, sum(p.numel() for p in model.parameters())

    def near_random(cfg, loss, tag):
        want = math.log(cfg.vocab_size) + \
            cfg.hidden_size * cfg.initializer_range ** 2 / 2
        if not (math.isfinite(loss) and abs(loss - want) <= 0.5):
            raise AssertionError(f"{tag}: first loss {loss} not near "
                                 f"{want:.3f}")
        return want

    def check_launches(tag, got, k3, k45):
        want = {"K1": 0, "K2": 0, "K3": k3, "K4": k45, "K5": k45}
        if got != want:
            raise AssertionError(f"{tag}: launches {got} != {want}")

    def rates(cfg, n_params, rec, tokens):
        model_f, hw_f = train_flops(cfg, n_params, run["seq"])
        tok_s = tokens / (rec["ms"] / 1e3)
        return {"tokens_per_s": tok_s, "mfu": tok_s * model_f / BF16_FLOPS,
                "hfu": tok_s * hw_f / BF16_FLOPS}

    def gib(n):
        return f"{n / 2 ** 30:.2f} GiB"

    # what earlier phases left in reference cycles would count in the
    # first arm's peak
    gc.collect()
    torch.cuda.empty_cache()
    stats["allocated_before"] = torch.cuda.memory_allocated()

    # -- arm A: recompute, three scheduled steps ----------------------------
    cfg = LlamaConfig(**LLAMA_TRAIN)
    ids, labels = batch(cfg, run["batch"])
    model, n_params = build(cfg)
    mem = state_bytes(n_params)
    acts = saved_activation_bytes(cfg, run["batch"] * run["seq"])
    log(f"  Llama-7B widths, {cfg.num_hidden_layers} layers: {n_params} "
        f"parameters ({gib(stats['allocated_before'])} allocated before "
        f"the phase); a step holds " + ", ".join(
            f"{k} {gib(v)}" for k, v in mem.items() if k != "parameters") +
        f"; saved activations by reckoning ({acts['per_token_layer']} bytes "
        f"a token a layer): {gib(acts['no_recompute'])} without recompute, "
        f"{gib(acts['recompute'])} with it")
    act_a = activation_memory(model, ids, labels)
    opt, sched = llama_optimizer(model)
    reads = []
    get_lr = opt.get_lr
    opt.get_lr = lambda: reads.append(get_lr()) or reads[-1]
    step = jit.compile_train_step(
        lambda i, lab: model(i, labels=lab), model, opt)
    steps = []
    for _ in range(run["steps"]):
        want_lr = sched()
        reads.clear()
        steps.append(dict(timed_step(step, (ids, labels), tln, tfa),
                          lr=want_lr, lr_read=sorted(set(reads))))
        if steps[-1]["lr_read"] != [want_lr]:
            raise AssertionError(f"arm A: the step read lr {reads}, the "
                                 f"scheduler's is {want_lr}")
        check_launches("arm A", steps[-1]["launches"], 8, 4)
        sched.step()
    losses = [r["loss"] for r in steps]
    want_first = near_random(cfg, losses[0], "arm A")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"arm A: losses {losses}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    sched.step()
    tokens = run["batch"] * run["seq"]
    arm_a = {"losses": losses, "first_loss_want": want_first,
             "steps": steps, "activation_bytes": act_a,
             **rates(cfg, n_params, steps[-1], tokens),
             "profile": device_busy(prof, prof_us)}
    log(f"  [arm A] recompute, [{run['batch']}, {run['seq']}]: losses "
        f"{losses} (first near {want_first:.3f}), lr "
        f"{[r['lr'] for r in steps]}, step ms "
        f"{[round(r['ms'], 2) for r in steps]}, launches a step "
        f"{steps[-1]['launches']}; {arm_a['tokens_per_s']:.1f} tokens/s, MFU "
        f"{arm_a['mfu']:.4f}, HFU {arm_a['hfu']:.4f} (bench.py's 6N + 12 L h "
        f"s a token; HFU adds the recompute's rerun, 2N of the layers + 4 L "
        f"h s); training forward holds {gib(act_a)}, peak over a step "
        f"{gib(steps[-1]['peak_bytes'])}")
    by_path["llama_training"] = steps[-1]["launches"]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # get_lr is bound to opt: dropping it too frees the moments
    del model, opt, step, prof, get_lr
    torch.cuda.empty_cache()

    # -- the held step, on a fresh batch: arm A's own it has memorised --------
    stats["held"] = held_step(
        dev, cfg, state, *batch(cfg, run["held_batch"]), tln, tfa,
        LlamaForCausalLM, fault_module=lambda m: m.llama.layers[0].self_attn)
    del state
    torch.cuda.empty_cache()

    # -- arm B: no recompute --------------------------------------------------
    cfg_b = LlamaConfig(**dict(LLAMA_TRAIN, use_recompute=False))
    model, _ = build(cfg_b)
    act_b = activation_memory(model, ids, labels)
    opt, _ = llama_optimizer(model)
    step = jit.compile_train_step(
        lambda i, lab: model(i, labels=lab), model, opt)
    rec_b = timed_step(step, (ids, labels), tln, tfa)
    check_launches("arm B", rec_b["launches"], 4, 4)
    near_random(cfg_b, rec_b["loss"], "arm B")
    by_path["llama_training_no_recompute"] = rec_b["launches"]
    freed = act_b - act_a
    arm_b = {"loss": rec_b["loss"], "ms": rec_b["ms"],
             "activation_bytes": act_b, "freed_by_recompute": freed,
             "freed_by_reckoning": acts["freed"],
             "peak_bytes": rec_b["peak_bytes"]}
    log(f"  [arm B] no recompute: loss {rec_b['loss']:.4f}, step "
        f"{rec_b['ms']:.2f} ms (first step), launches {rec_b['launches']}; "
        f"training forward holds {gib(act_b)} against arm A's {gib(act_a)}: "
        f"recompute frees {gib(freed)}, by reckoning {gib(acts['freed'])} "
        f"(gate: at least half); peak over the step "
        f"{gib(rec_b['peak_bytes'])}")
    if not freed >= acts["freed"] / 2:
        raise AssertionError("recompute did not free the saved activations")
    del model, opt, step
    torch.cuda.empty_cache()

    # -- arm C: gradient merge ------------------------------------------------
    model, _ = build(cfg)
    opt, _ = llama_optimizer(model)
    step = jit.compile_train_step(
        lambda i, lab: model(i, labels=lab), model, opt,
        accumulate_steps=run["accumulate"])
    merged = batch(cfg, run["merge_batch"])
    rec_c = timed_step(step, merged, tln, tfa)
    micro = [x.item() for x in step.micro_losses]
    check_launches("arm C", rec_c["launches"], 16, 8)
    if len(micro) != run["accumulate"] or \
            rec_c["loss"] != torch.stack(step.micro_losses).mean().item():
        raise AssertionError(f"arm C: loss {rec_c['loss']} is not the mean "
                             f"of {micro}")
    near_random(cfg, rec_c["loss"], "arm C")
    by_path["llama_training_accumulate"] = rec_c["launches"]
    arm_c = {"loss": rec_c["loss"], "micro_losses": micro,
             "ms": rec_c["ms"], "peak_bytes": rec_c["peak_bytes"],
             **rates(cfg, n_params, rec_c, run["merge_batch"] * run["seq"])}
    log(f"  [arm C] accumulate_steps={run['accumulate']} on "
        f"[{run['merge_batch']}, {run['seq']}]: loss {rec_c['loss']:.4f} = "
        f"mean of {micro}, step {rec_c['ms']:.2f} ms (first step), "
        f"{arm_c['tokens_per_s']:.1f} tokens/s, MFU {arm_c['mfu']:.4f}, "
        f"launches {rec_c['launches']}, peak {gib(rec_c['peak_bytes'])}")
    del model, opt, step
    torch.cuda.empty_cache()

    # -- the GQA arm ----------------------------------------------------------
    cfg_g = LlamaConfig(**LLAMA3_GQA_TRAIN)
    model, n_g = build(cfg_g)
    g_ids, g_labels = batch(cfg_g, 1)
    loss = model(g_ids, labels=g_labels)
    loss.backward()
    kv = {n: p.grad.float().abs().max().item()
          for n, p in model.named_parameters()
          if ".k_proj.weight" in n or ".v_proj.weight" in n}
    model.zero_grad(set_to_none=True)
    del loss
    if not all(math.isfinite(g) and g > 0 for g in kv.values()):
        raise AssertionError(f"GQA arm: K/V gradients {kv}")
    opt, _ = llama_optimizer(model)
    step = jit.compile_train_step(
        lambda i, lab: model(i, labels=lab), model, opt)
    rec_g = timed_step(step, (g_ids, g_labels), tln, tfa)
    check_launches("GQA arm", rec_g["launches"], 4, 2)
    want_g = near_random(cfg_g, rec_g["loss"], "GQA arm")
    by_path["llama3_gqa_training"] = rec_g["launches"]
    gqa = {"parameters": n_g, "loss": rec_g["loss"],
           "first_loss_want": want_g, "ms": rec_g["ms"],
           "peak_bytes": rec_g["peak_bytes"],
           "kv_grad_max_abs": kv, "state_bytes": state_bytes(n_g)}
    log(f"  [GQA arm] Llama-3-8B widths, 2 layers, rep "
        f"{cfg_g.num_attention_heads // cfg_g.num_key_value_heads}, {n_g} "
        f"parameters, [1, {run['seq']}]: loss {rec_g['loss']:.4f} (near "
        f"{want_g:.3f}), step {rec_g['ms']:.2f} ms (first step), launches "
        f"{rec_g['launches']}, peak {gib(rec_g['peak_bytes'])}; K/V "
        f"gradients' max |g| {min(kv.values()):.3e}-{max(kv.values()):.3e}")
    del model, opt, step
    torch.cuda.empty_cache()
    stats.update(arm_a=arm_a, arm_b=arm_b, arm_c=arm_c, gqa=gqa,
                 state_bytes=mem, saved_activations=acts,
                 phase_s=time.perf_counter() - t_phase)
    log(f"  phase 9: {stats['phase_s']:.1f} s")
    return by_path, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa
    from paddle_tpu_torch.ops.cuda import layer_norm as tln
    from paddle_tpu_torch.ops.cuda import paged_attention as tpa

    t_start = time.perf_counter()
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
    build_times = {}
    build_logs = _build.build(times=build_times)
    ptxas = {}    # K6's, K9's, K10's and K11's instantiations, by `parse`
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(build_logs)}; card: {smi}")
    log("  each compile, seconds from the start to its end: " + ", ".join(
        f"{job} {secs:.1f}" for job, secs in sorted(build_times.items(),
                                                     key=lambda x: x[1])))
    for name, text in build_logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = re.findall(r"(\d+) bytes spill stores", text)
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, {sum(int(n) > 0 for n in spills)} with spill stores")
        if name == "paged_scatter" and text:
            for kernel, n_regs, spill in ptxas_rows(text,
                                                    "scatter_tile_kernel"):
                if spill:
                    log(f"    {kernel[:60]}: {n_regs} registers, {spill} "
                        "bytes of spill stores")
        if name == "layer_norm" and text:
            rows = ln_ptxas(text)
            for kernel, n_regs, spill in rows:
                log(f"    {kernel}: {n_regs} registers, {spill} bytes of "
                    "spill stores")
            ptxas["K1/K2"] = {
                "instantiations": len(rows),
                "max_registers": max(r[1] for r in rows),
                "spilling": [r[0] for r in rows if r[2]]}
        if name == "flash_attention":
            for kernel, n_regs, spill in tensor_core_ptxas(text):
                log(f"    {kernel}: {n_regs} registers at launch, {spill} "
                    "bytes of spill stores")
        parse = {"grouped_paged_attention": (
                     "K10 ring", lambda t: ring_ptxas(t, "K10")),
                 "ragged_paged_attention": (
                     "K6 ring", lambda t: ring_ptxas(t, "K6")),
                 "paged_decode_attention": (
                     "K9", lambda t: ring_ptxas(t, "K9")),
                 "lora_paged": ("K11", lora_ptxas)}.get(name)
        if parse and text:
            rows = parse[1](text)
            for kernel, n_regs, spill in rows:
                # the serving step's
                if "bf16, D 64, ps 16" in kernel or kernel.startswith("K11"):
                    log(f"    {kernel}: {n_regs} registers, {spill} bytes "
                        "of spill stores")
            spilled = [r[0] for r in rows if r[2]]
            log(f"    {parse[0]}: {len(rows)} instantiations, at most "
                f"{max(r[1] for r in rows)} registers, {len(spilled)} with "
                f"spill stores {spilled}")
            ptxas[parse[0]] = {
                "instantiations": len(rows),
                "max_registers": max(r[1] for r in rows),
                "spilling": spilled,
                "serving": {r[0]: [r[1], r[2]] for r in rows
                            if "bf16, D 64, ps 16" in r[0]
                            or r[0].startswith("K11")}}

    log("phase 2 kernels vs plain versions:")
    timer = DeviceTimer()
    kernels = {"K1": check_layer_norm(dev, tln, timer),
               "K2": check_layer_norm_bwd(dev, tln, timer)}
    kernels["K1"]["f11"], kernels["K2"]["f11"] = check_layer_norm_f11(
        dev, tln, timer)
    kernels.update(zip(("K3", "K4", "K5"),
                       check_flash_attention(dev, tfa, timer)))
    # head dim 256: the shapes of phase 6's GPT step; one row of phase
    # 9's Llama step
    for tag, shape in (("head_dim_256", D256_FLASH),
                       ("llama_training", LLAMA_TRAIN_FLASH)):
        for key, rec in zip(("K3", "K4", "K5"), check_flash_attention(
                dev, tfa, timer, shape=shape)):
            kernels[key][tag] = {
                k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "backward_sum") if k in rec}
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    for lane in ("fp", "fp8", "q8"):
        kernels[WALKS["K6", lane][0]] = check_paged_attention(
            dev, tpa, timer, lane)
        (kernels[WALKS["K10a", lane][0]],
         kernels[WALKS["K10b", lane][0]]) = check_grouped_attention(
            dev, tpa, timer, lane)
    split = check_split_walks(dev, tpa, timer)
    kernels["K8"], kernels["K8-q8"], kernels["K8-float"] = \
        check_paged_scatter(dev, tpa, timer)
    for lane in ("fp", "fp8"):
        kernels["K9" if lane == "fp" else "K9-fp8"] = check_paged_decode(
            dev, tpa, timer, lane)
    kernels["K3"]["max_abs_err_serving_shapes"] = check_flash_serving(
        dev, tfa)
    masked = check_paged_attention_masked(dev, tpa, timer)
    kernels["K6"]["user_mask"] = masked["K6"]
    kernels["K7"]["user_mask"] = masked["K7"]
    # F10: each walk's records at the shapes whose rows it splits (K10's
    # times ride on K6's and K7's, whose bits it equals there)
    for key in ("K6", "K6-fp8", "K7", "K9", "K9-fp8"):
        kernels[key]["split_rows"] = {case: rec for case, rec in
                                      split.items()
                                      if case.split()[0] == key}
    kernels["K11"] = check_lora_paged(dev, tpa, timer)
    for key, lib in (("K9", "K9"), ("K9-fp8", "K9"), ("K11", "K11"),
                     ("K6", "K6 ring"), ("K6-fp8", "K6 ring"),
                     ("K7", "K6 ring"), ("K1", "K1/K2"), ("K2", "K1/K2")):
        kernels[key]["ptxas"] = ptxas.get(lib)
    kernels["K12"] = check_greedy_argmax(dev, tpa, timer)
    kernels["K12"]["grammar_biased"] = check_greedy_argmax_biased(dev, tpa)
    torch.cuda.empty_cache()

    log("phase 3 serve GPT-124M (bf16, random weights):")
    by_path, serving_stats, model, fp_tokens = serving(dev, tln, tpa)
    log(f"  serving: {json.dumps(serving_stats)}")
    quant_paths, serving_stats["quantized"], quant_tokens = serving_quantized(
        dev, tln, tpa, model, fp_tokens, serving_stats["defaults"][0])
    by_path.update(quant_paths)
    log(f"  serving, quantized KV: "
        f"{json.dumps(serving_stats['quantized'])}")
    mega_paths, serving_stats["megakernel"] = serving_megakernel(
        dev, tln, tpa, model, fp_tokens, quant_tokens["int8"])
    by_path.update(mega_paths)
    log(f"  serving, megakernel and adapter arms: "
        f"{json.dumps(serving_stats['megakernel'])}")
    for kv in ("fp", "int8"):
        log(f"  preemption ({kv}): {json.dumps(preemption(dev, model, kv))}")
    legacy_paths, serving_stats["legacy"] = serving_legacy(
        dev, tln, tpa, model, fp_tokens)
    by_path.update(legacy_paths)
    log(f"  serving, legacy and gather arms: "
        f"{json.dumps(serving_stats['legacy'])}")
    del model
    torch.cuda.empty_cache()

    log("phase 4 train GPT-124M (bf16, random weights, bench.py's step):")
    by_path["training"], training = train(dev, tln, tfa, tpa)
    log(f"  training: {json.dumps(training)}")
    torch.cuda.empty_cache()

    log("phase 5 GPTForCausalLM.generate on GPT-124M (bf16, random "
        "weights):")
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                           dtype=torch.bfloat16, seed=SEED).eval()
    gen_paths, generation = generate_phase(dev, tln, tpa, model)
    by_path.update(gen_paths)
    log(f"  generate: {json.dumps(generation)}")
    del model
    torch.cuda.empty_cache()

    log("phase 6 GPT at head dims 256 and 32 (2 layers, bf16, random "
        "weights):")
    head_dims = {d: head_dim_phase(dev, tln, tfa, tpa, d)
                 for d in HEAD_DIM_GPTS}
    log(f"  head dims: {json.dumps(head_dims)}")
    torch.cuda.empty_cache()

    log("phase 7 a GPT-3 13B-width layer (1 layer, bf16, random weights):")
    by_path["training_gpt3_width"], gpt3 = gpt3_width_phase(dev, tln, tfa)
    log(f"  GPT-3 width: {json.dumps(gpt3)}")
    torch.cuda.empty_cache()

    log("phase 8 Llama-7B and a Llama-3-8B-width GQA arm (bf16, random "
        "weights):")
    llama_paths, llama = llama_phase(dev, tln, tpa)
    by_path.update(llama_paths)
    log(f"  llama: {json.dumps(llama)}")
    torch.cuda.empty_cache()

    log("phase 9 train Llama at Llama-7B's widths (4 layers, recompute) and "
        "a Llama-3-8B-width GQA arm (bf16, random weights):")
    train_paths, llama_train = llama_train_phase(dev, tln, tfa)
    by_path.update(train_paths)
    log(f"  llama training: {json.dumps(llama_train)}")
    torch.cuda.empty_cache()

    log("phase 10 speculative serving on GPT-124M (bf16, random weights; "
        "the Llama-7B part ran in phase 8):")
    t_spec = time.perf_counter()
    from paddle_tpu_torch.serving import make_draft_model
    full = GPTForCausalLM(GPTConfig(**GPT124M), device=dev,
                          dtype=torch.bfloat16, seed=SEED).eval()
    model = make_draft_model(full, SPEC_GPT_LAYERS)
    del full
    spec_paths, spec_gpt = spec_phase_gpt(dev, tln, tpa, model)
    by_path.update(spec_paths)
    del model
    torch.cuda.empty_cache()
    log(f"  phase 10, GPT-124M part: {time.perf_counter() - t_spec:.1f} s")
    log(f"  speculative serving: {json.dumps(spec_gpt)}")
    log(f"  speculative serving, Llama-7B: {json.dumps(llama['spec'])}")

    log("phase 11 obs on against off, poison quarantine, the cost census "
        "and the engine driver on GPT-124M (bf16, random weights; the "
        "Llama-7B quarantine arm ran in phase 8):")
    obs_paths, serving_obs = phase11(dev, tln, tpa)
    by_path.update(obs_paths)
    log(f"  phase 11: {json.dumps(serving_obs)}")
    log(f"  phase 11, Llama-7B quarantine: {json.dumps(llama['quarantine'])}")

    log("phase 12 grammar-constrained decoding, embeddings, session pins and"
        " the KV fabric on GPT-124M (bf16, random weights; the Llama-7B part"
        " ran in phase 8):")
    p12_paths, phase12_stats = phase12(dev, tln, tpa)
    by_path.update(p12_paths)
    log(f"  phase 12: {json.dumps(phase12_stats)}")
    log(f"  phase 12, Llama-7B: {json.dumps(llama['phase12'])}")

    log("phase 13 the HTTP front end, the router and the control plane in "
        "front of GPT-124M engines (bf16, random weights; two replicas "
        "behind serve() on 127.0.0.1):")
    p13_paths, phase13_stats = phase13(dev, tln, tpa)
    by_path.update(p13_paths)
    log(f"  phase 13: {json.dumps(phase13_stats)}")
    # each kernel's launches on each path, counted from 0 just before the
    # path ran; `launches` is those of the path whose shapes the record
    # was measured at
    for name, rec in kernels.items():
        rec["launches_by_path"] = {path: counts.get(name, 0)
                                   for path, counts in by_path.items()}
        rec["launches"] = rec["launches_by_path"][rec["path"]]
        if "llama_training" in rec:
            rec["llama_training"]["launches"] = \
                by_path["llama_training"][name]

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
        f"build included")
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
