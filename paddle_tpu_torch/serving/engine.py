"""ServingEngine: continuous batching over a paged KV pool.

Counterpart of `paddle_tpu/serving/engine.py` on its unified path
(`_build_unified` :1077, driven by `_unified_step` :2534) and its legacy
alternating path (`_advance_prefills` :2183, `_decode` :2254), with the
JAX engine's defaults: `ServingEngine(model)` means the same engine in both
packages — prefix cache, grouped walk, preemption and a host tier of
`num_pages - 1` pages all on. The engine owns, per layer, one shared K/V
pool [num_pages, page_size, H_kv, D] (zero-initialised: trash-page keys
are masked, never skipped, so they must be finite), a page table
[num_slots, max_pages] and one write position per slot. A request
admitted into a slot allocates the pages its prompt plus output budget
needs.

The unified step (`unified=None`/on, gate `PADDLE_TPU_UNIFIED_STEP=on|off`)
runs ONE fixed-shape [num_slots, chunk_len] forward in which
each row carries its own live query count `q_len`: decoding rows feed
the token sampled from their held logits at q_len 1, mid-prefill rows
feed up to chunk_len prompt tokens, idle rows ride dead at q_len 0
(`Scheduler.pack_tokens` decides the packing under `token_budget`).
Every LayerNorm is the fused kernel (K1), 2 * n_layers + 1 launches per
step. Attention is the grouped walk (K10, `grouped=None`/on, gate
`PADDLE_TPU_GROUPED_ATTN=on|off`): each step the host partitions the
live rows into groups whose page tables share physical pages
(`shared_prefix_groups`) and uploads them with the step's other
operands, and both phases launch once per layer — n_layers launches of
each. With `grouped=False` attention is ragged paged attention (K6),
n_layers launches. The output is the same bit for bit; only the page
reads differ, and `count_page_block_reads` feeds the modeled reads of
both walks into the metrics. The step runs eagerly; capturing it in a
CUDA graph is later work.

The legacy alternating step (`unified=False`, or
PADDLE_TPU_UNIFIED_STEP=off) is the JAX engine's A/B control: each round
first runs ONE prefill chunk for every mid-prefill slot, a batch-1
forward of `chunk_bucket` tokens (full `chunk_len` chunks, then one
power-of-two tail bucket of at least `MIN_CHUNK`; the padding's K/V
lands past the prompt or on the trash page) that holds the logits of
its last real token, then ONE decode forward over every slot: rows in
DECODE feed the token sampled from their held logits, every other row
feeds token 0 through a page table that points it at the trash page,
and only DECODE rows advance. Per layer a chunk runs K1 twice and
attends the gathered pages through flash attention (K3) under the
window mask; the decode forward attends through paged decode attention
(K9; K7 at q_len 1 over int8 pools, whose writes are K8-q8; e4m3 pools
take K9's fp8 lane and K8). No program is built per bucket: the distinct
buckets run are kept in `prefill_buckets`. Prefix cache, copy-on-write,
preemption with the host tier, the quantized pools and `drain()` work
there as on the unified step.

`attn_impl` ("kernel" default, or "gather"; gate PADDLE_TPU_PAGED_ATTN)
switches every paged attend to the gather branch: the rows' pages are
gathered into the dense view and attended through K3 under the window
mask. The grouped walk exists only on the unified kernel path: with
`unified=False` or `attn_impl="gather"` it is dropped silently, as in the
JAX engine.

The radix prefix cache (`serving.prefix`, on by default) attaches
cached prefix pages at admission; a mid-page match is copied into a
private page first (copy-on-write), so a shared page is never written
through. Greedy decoding is a first-occurrence argmax over the held
logits; sampled rows use the engine's seeded `torch.Generator`.

Overload (`preempt=None`/on, gate `PADDLE_TPU_PREEMPT=on|off`): when the
ordered queue's head is still blocked after admission and a resident of
a strictly lower priority class exists, that resident is PREEMPTED — its
emitted tokens banked, its private committed KV pages copied to the host
tier (`host_pages`, default num_pages - 1; 0 disables it), its shared
prefix pages released, its slot freed — and requeued by its original
key. It resumes through swap-in: its committed sequence is matched
against the radix tree again, the host pages restored into fresh device
pages, and one re-prefilled token regenerates its held logits, so its
greedy tokens are those of a run that never preempted it. Where the
host tier is full the tail recomputes instead. The same host tier takes
parked prefix-cache pages under page pressure (spill) and restores them
on a later match. Swaps are plain tensor copies of whole pages of every
layer's pools.

Quantized KV (`kv_dtype=None`/"fp", gate `PADDLE_TPU_KV_DTYPE=fp|int8|fp8`,
read at construction, as in the JAX engine): "int8" keeps each layer's
K and V as int8 code pools plus f32 rowwise scale pools
[num_pages, page_size, H_kv] (written by K8-q8, read by K7 and K10's q8
lane), "fp8" as float8 e4m3 pools (written by K8, read by the fp8 lanes
of K6 and K10). A page costs `page_bytes` (the JAX formula): at page 16
an int8 page 68/128 and an fp8 page 64/128 of a bf16 page, so the same
memory holds about twice the residents. Every whole-page move — COW,
swap-out and swap-in, prefix spill and restore — carries a page's codes
and scales as one unit, and moves e4m3 pages through their bytes.

Multi-tenant LoRA adapters (`adapters=True` or an `AdapterStore`, gate
`PADDLE_TPU_ADAPTERS=on|off`, default off; unified step only, as in the
JAX engine): registered adapters live in a paged adapter pool
(`serving.adapters`, `adapter_pages` pages plus the zero page, ranks
padded to the largest of `adapter_ranks`). A request names its adapter
by `SamplingParams.adapter_id`; admission acquires the adapter first
(upload, or restore from the adapter host tier, under LRU spill and
eviction) and releases it at retirement and at preemption (resume
acquires again). Each slot carries its adapter page and scale as step
operands, and each layer adds the rows' low-rank deltas to its q/k/v/o
projections: gathered per row through `lora_delta`, or with the
megakernel through K11 from the whole pools. The prefix cache keeps one
namespace per adapter.

The decode megakernel (`megakernel=True`, gate
`PADDLE_TPU_MEGAKERNEL=on|off`, default off; on only for the unified
kernel step, dropped silently elsewhere as in the JAX engine): every
layer's write and walk (and, with adapters, the q/k/v deltas) go through
`megakernel_decode[_q8]` — K11, then K8 (K8-q8), then K6/K7/K10 — and
the greedy argmax of the sampling epilogue is K12. Tokens are the same
with the gate on or off: K8's float write equals `index_copy_` and K12
equals `torch.argmax` bit for bit. With speculative decoding on, the
acceptance epilogue is `spec_verify_accept`, K12 over every verify
column.

Speculative decoding (`spec=`, gate PADDLE_TPU_SPEC_DECODE=off|ngram[:k]|
model[:k], default off; `serving.spec`; the unified step only): each
greedy request gets a drafter at admission, an n-gram prompt lookup or,
in the model tier, the engine's resident draft model (`serving.draft`,
its own float page pool of `draft_pages` pages). Each step a decoding
row carries up to `k` drafted tokens behind its sampled one, at q_len
1 + drafts (capped by the step width and the request's remaining
budget, so every transient write stays in its reserved pages; drafts
take only the budget decode and prefill leave). The verify forward runs
the LM head over the columns the step reads (a decode row's live
columns, a prefill row's last); `accept`, the longest prefix of drafts
equal to the model's own argmax chain, comes back in the sync that
brings the sampled tokens, the row's position advances by 1 + accept
(rejected drafts' K/V stays past it, overwritten before it is read) and
its held logits come from column `accept`. The host emits each burst
token by token, so EOS or max_new_tokens ends it where one-at-a-time
decoding would; greedy tokens are those of a spec-off engine. Sampled
rows never draft.

Observability (`serving.obs`, `obs=None`/on, gate PADDLE_TPU_OBS=on|off,
default on): a request tracer records each request's timeline (submit,
admit, swap_in, prefill_chunk, decode, first_token, preempt and its
terminal event, each with the step index, slot, pages and cause) and a
flight recorder keeps one record a step (`flight_steps=`, gate
PADDLE_TPU_FLIGHT_STEPS, default 1024) and freezes its ring into an
incident on a raising round, a poison quarantine, a deadline fail-fast
or replica death. The SLO tracker (`serving.slo`, `slo=None`/on, gate
PADDLE_TPU_SLO, default on with the generous defaults) rides the
metrics' TTFT, inter-token and goodput observations and notes its
state transitions in the flight ring. The cost census (`cost_census=`,
gate PADDLE_TPU_COST_CENSUS=off|model|lowered|xla, default "model") is
captured once: "model" after the first round, "lowered"/"xla" at the
first `cost_census()` read, by counting one forward of the unified step
at its full shape aimed at the trash page (see `serving.slo`; that one
forward is the only launch the layers make). An EngineDriver captures
that forward on its pump thread before its first step, so no other
thread's read runs it. Otherwise all three are
host bookkeeping built from values a step already holds on the host: no
launch, no device read and no synchronisation, and the tokens are the
same with them on or off. Each request also
holds a host span (`profiler.RecordEvent`, begun at admission and ended
at retirement or preemption, also when teardown raises); the step's,
chunks' and page copies' spans enter `torch.profiler.record_function`.

Poison quarantine: `step_fault_hook`, when set (the fault injector's
`on_engine_step`), is called with a round's participant request ids
before the round's first launch and before any pool write, position
move or held-logit write (a legacy round calls it per prefill chunk and
before its decode step). A round that raises goes through
`_quarantine_poison`: the resident slots are bisected by probe rounds
that run with half the candidates suppressed (at q_len 0 on the unified
step, with no drafts proposed or granted; skipped by the legacy
prefill chunks and inactive in its decode step), a probe that raises
exonerating the suppressed half and one that succeeds convicting it
while the innocents it ran make progress. A verdict that a round
without the suspect succeeds fails that request alone ("poisoned",
`PoisonedRequest`); a fault that tracks no single request propagates as
replica death. Quarantine covers faults raised on the host before a
launch, the shape `FaultInjector.poison` injects: a CUDA error leaves
the context unusable, so one propagates as replica death without a
probe. (The model tier's draft proposals run before the hook, as in
the JAX engine; their draft-pool writes lie past the committed stream
and the next round's clamp rolls them back.) `heartbeat_hook`, when set
(the driver's), is called at every step boundary and around each
round's launches, with `step_tokens_inflight` the tokens of the launch
in flight.

Grammar-constrained decoding (`grammar=`, gate PADDLE_TPU_GRAMMAR=on|off,
default off; `serving.grammar`; the unified step only): a request whose
`SamplingParams.grammar` is set gets an automaton at admission (it
replays `grammar_prefix` prompt tokens and the emitted ones, so a
preempted stream resumes constrained). Each step every constrained
decode row's allow-set becomes one [V] f32 bias row (0 or -1e30;
budget-aware, EOS allowed in accepting states only and forced when
nothing else is), added to that row's held logits before the sample: the
argmax (K12 under the megakernel) and the sampled chain see the biased
logits, the held logits stay the model's. Only constrained rows are
uploaded, and a step without one adds nothing (x + 0.0 changes no
argmax). With speculative decoding a fork of the automaton walks each
row's drafts, each verify column gets its own bias row, and a draft the
grammar forbids loses the argmax match and is rejected.

The embeddings lane (`SamplingParams.embed`, the unified step only): an
embed request prefills its prompt like any other, reserving no output
pages, and at the end of its prompt retires with the pooled last hidden
state: its last prompt token is fed again at position plen - 1 through
the model's backbone over its own pages, a q_len-1 read (K9, K7 over
int8 pools; its write `index_copy_` over float pools, the K8 pair over
e4m3 ones, the K8-q8 pair over int8 ones). The pools are
written in place, so the page that write lands in is saved before the
read and restored after it: the epilogue leaves every byte of the pool
as it found it.

Sessions (`SamplingParams.session`): a normally finished session
request's inserted chain is pinned in the prefix cache for
`session_ttl_s` seconds of the engine's clock (default 30), so the next
turn hits warm pages under eviction pressure.

The KV fabric's engine side (`serving.fabric`): `export_prefix_frame`
reads the committed chain covering a token span (device pages through
the swap-out copy, spilled pages from the host tier) into a PKVF frame,
byte for byte the JAX engine's for the same pages; `import_prefix_frame`
checks the frame's geometry whole, then grafts it into the tree (pages
allocated by spilling, never evicting); `export_prefix_state` and
`import_prefix_state` carry the whole tree for a warm restart.

Gates are resolved at construction as the JAX engine resolves them
(`prefix_cache=None` follows PADDLE_TPU_PREFIX_CACHE, default on). The
gate of the feature not ported yet — `mesh` (PADDLE_TPU_MESH) — is
parsed with the JAX package's rules (a bad spelling raises ValueError)
and raises NotImplementedError, naming the ROADMAP item, when a keyword
or an environment variable turns it on.
"""
from __future__ import annotations

import itertools
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, make_generator, resolve_device
from ..nlp.generation import (_categorical, _top_p_filter, _unpack_caches,
                              resolve_paged_attn_impl)
from ..ops.cuda.paged_attention import (FP8_DTYPE, _as_bytes,
                                        count_page_block_reads,
                                        decode_greedy_argmax,
                                        resolve_megakernel_flag,
                                        spec_verify_accept)
from .adapters import BASE_ADAPTER, AdapterStore, resolve_adapters_flag
from .draft import DraftConfig, DraftEngine, make_draft_model
from ..profiler import RecordEvent
from .errors import DeadlineExceeded, EngineClosed, PoisonedRequest
from .fabric import decode_frame, encode_frame, frame_header
from .grammar import NEG_BIAS, TokenGrammar, resolve_grammar_flag
from .metrics import ServingMetrics
from .obs import EngineObs, resolve_obs_flag
from .paging import (HostPagePool, PagePool, TRASH_PAGE, chunk_bucket,
                     pages_needed)
from .prefix import (RadixPrefixCache, resolve_prefix_cache_flag,
                     shared_prefix_groups)
from .request import Request, RequestOutput, RequestState, SamplingParams
from .scheduler import Scheduler
from .slo import (SLOTracker, capture_cost_census, model_cost_census,
                  resolve_cost_census, resolve_slo_config)
from .spec import Drafter, ModelDrafter, resolve_spec_config

__all__ = ["ServingEngine", "unified_forward", "verify_forward",
           "legacy_forward", "embed_forward",
           "resolve_grouped_flag", "resolve_preempt_flag",
           "resolve_unified_flag", "resolve_kv_dtype", "KV_DTYPE_MODES",
           "resolve_unported_gates"]

KV_DTYPE_MODES = ("fp", "int8", "fp8")
# finish reason -> the terminal timeline event (the rest keep their name)
_TERMINAL_EVENT = {"stop": "finish", "length": "finish",
                   "deadline": "deadline", "poisoned": "poison",
                   "replica_failure": "replica_death"}
_ROADMAP_SERVING = "ROADMAP.md, queue 1, item 6"
_MESH_RE = re.compile(r"^dp(\d+)x?mp(\d+)$")


def _mesh_on(override) -> bool:
    """PADDLE_TPU_MESH / mesh= (the JAX `resolve_serving_mesh`): '' or
    'off' (the default) or False is single-device; a 'dpXmpY' spec, a
    (dp, mp) pair or a mesh object turns tensor parallelism on."""
    if override is False:
        return False
    spec = override if override is not None else \
        os.environ.get("PADDLE_TPU_MESH", "off")
    if not isinstance(spec, str):
        return True
    spec = spec.strip()
    if override is None and spec in ("", "off"):
        return False
    m = _MESH_RE.match(spec.lower())
    if m is None or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise ValueError(f"mesh spec must look like 'dp2mp4' "
                         f"(PADDLE_TPU_MESH / ServingEngine(mesh=...)), got "
                         f"{spec!r}")
    return True


# gate -> (its resolver, what it serves)
_UNPORTED_GATES = {
    "mesh": (_mesh_on, "tensor-parallel serving (PADDLE_TPU_MESH)"),
}


def resolve_unported_gates(**overrides):
    """Resolve the JAX engine's gates of features the port lacks (mesh),
    each from its keyword or,
    when that is None, its environment variable, by the JAX rules: a bad
    spelling raises ValueError, and a gate that comes out on raises
    NotImplementedError naming the ROADMAP item."""
    for name, (resolve, what) in _UNPORTED_GATES.items():
        value = overrides.get(name)
        if resolve(value):
            source = (f"ServingEngine({name}={value!r})" if value is not None
                      else "its environment variable")
            raise NotImplementedError(
                f"{what} is not ported yet ({_ROADMAP_SERVING}); "
                f"{source} turns it on")


def _resolve_on_off(override, env: str) -> bool:
    if override is not None:
        return bool(override)
    v = os.environ.get(env, "on")
    if v not in ("on", "off"):
        raise ValueError(f"{env} must be one of ('on', 'off'), got {v!r}")
    return v == "on"


def resolve_grouped_flag(override=None) -> bool:
    """Whether the unified step runs the grouped (prefix-sharing) page
    walk, K10 (default on): an explicit override wins, otherwise
    PADDLE_TPU_GROUPED_ATTN=on|off, read at engine construction. Outputs
    are bit-identical either way; groups are per-step operand data."""
    return _resolve_on_off(override, "PADDLE_TPU_GROUPED_ATTN")


def resolve_unified_flag(override=None) -> bool:
    """Whether the engine runs the unified ragged step (default on) or
    the legacy alternating prefill-chunk / decode step: an explicit
    override wins, otherwise PADDLE_TPU_UNIFIED_STEP=on|off, read at
    engine construction."""
    return _resolve_on_off(override, "PADDLE_TPU_UNIFIED_STEP")


def resolve_preempt_flag(override=None) -> bool:
    """Whether overload preempts a strictly lower-priority resident
    instead of only holding the queue head back (default on): an
    explicit override wins, otherwise PADDLE_TPU_PREEMPT=on|off, read at
    engine construction."""
    return _resolve_on_off(override, "PADDLE_TPU_PREEMPT")


def resolve_kv_dtype(override=None) -> str:
    """Which dtype the paged KV pools hold: "fp" (the model's float
    dtype, the default), "int8" (rowwise-quantized code pools plus f32
    scale pools) or "fp8" (float8 e4m3 pools, no scales; writes clip to
    +-448 and round to nearest even). Quantization is lossy: int8 and
    fp8 tokens need not equal fp's, but every serving feature stays
    deterministic at either. An explicit override wins; otherwise
    PADDLE_TPU_KV_DTYPE=fp|int8|fp8, read at engine construction.
    Anything else raises ValueError."""
    v = override or os.environ.get("PADDLE_TPU_KV_DTYPE", "fp")
    if v not in KV_DTYPE_MODES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPE_MODES} "
            f"(PADDLE_TPU_KV_DTYPE / ServingEngine(kv_dtype=...)), "
            f"got {v!r}")
    return v


def _device_fault(exc: BaseException) -> bool:
    """A CUDA error (a refused or failed launch, a sticky fault of the
    context) rather than a fault raised on the host before a launch:
    never poison, since the context may be unusable."""
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(exc, accel))
            or "CUDA error" in str(exc))


class _SwapHandle:
    """A preempted request's claim on the host tier: `host_slots[j]`
    holds the KV of the page at page-table index `base + j`; `kv_len` is
    how many leading positions of the committed sequence hold valid KV.
    `restores`/`drops` are filled by the resume reservation (which host
    pages swap back in, and which a fresh prefix match made redundant)."""

    __slots__ = ("host_slots", "base", "kv_len", "restores", "drops")

    def __init__(self, host_slots, base, kv_len):
        self.host_slots = list(host_slots)
        self.base = int(base)
        self.kv_len = int(kv_len)
        self.restores = []      # [(host_slot, dst_page), ...]
        self.drops = []         # host slots made redundant by a match


def _sample_rows(logits: torch.Tensor, generator: torch.Generator,
                 temps: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, greedy: torch.Tensor,
                 argmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling over f32 logits [S, V] (the JAX engine's
    `_sample_rows`): greedy rows take the first-occurrence argmax of the
    raw logits (`argmax` when given: the megakernel's K12 result); the
    others apply their own temperature, top-k (0 = off) and top-p
    (1.0 = off), then draw with the Gumbel-max trick from
    `generator`."""
    v = logits.shape[-1]
    g = torch.argmax(logits, dim=-1) if argmax is None else argmax.long()
    l = logits / temps[:, None]
    sorted_desc = torch.sort(l, dim=-1, descending=True).values
    kidx = (torch.clamp(top_k, 1, v) - 1).to(torch.int64)
    kth = torch.gather(sorted_desc, 1, kidx[:, None])
    l = torch.where((top_k > 0)[:, None] & (l < kth),
                    torch.full_like(l, -1e30), l)
    l = torch.where((top_p < 1.0)[:, None], _top_p_filter(l, top_p[:, None]),
                    l)
    return torch.where(greedy, g, _categorical(l, generator))


def model_backbone(model):
    """The hidden-state trunk under a causal-LM wrapper (GPT's `.gpt`,
    Llama's `.llama`), else the model itself (the JAX engine's
    `_model_backbone`). The LM head stays `model.lm_head`."""
    for attr in ("gpt", "llama", "transformer", "backbone"):
        core = getattr(model, attr, None)
        if core is not None and callable(core):
            return core
    return model


def _backbone(model, pools, tokens, pos, page_table, q_len, group,
              attn_impl, lora, megakernel) -> torch.Tensor:
    """The unified step's trunk: tokens [S, W] through the model's
    backbone over the per-layer pools (written in place); the hidden
    states [S, W, h]. See `unified_forward` for the operands."""
    lora_layers = lora_paged = None
    if lora is not None:
        apools, apage, ascale = lora
        if megakernel:
            lora_paged = [tuple(layer) + (apage, ascale) for layer in apools]
        else:
            idx = apage.long()
            lora_layers = [tuple(t[idx] for t in layer) + (ascale,)
                           for layer in apools]
    caches = _unpack_caches(pools, pos, page_table, q_len, group, attn_impl,
                            lora_layers, lora_paged, megakernel)
    h, _ = model_backbone(model)(tokens, caches=caches)
    return h


def unified_forward(model, pools, tokens: torch.Tensor, pos: torch.Tensor,
                    page_table: torch.Tensor, q_len: torch.Tensor,
                    is_decode: torch.Tensor, last_logits: torch.Tensor,
                    group=None, attn_impl: Optional[str] = None, lora=None,
                    megakernel: bool = False) -> torch.Tensor:
    """The model half of one unified step: run tokens [S, W] through the
    model over the per-layer (k, v) `pools` (written in place) and
    return the new held logits [S, V] f32 — a decode row's from its
    column 0, a prefill row's from its last live column, a dead row's
    unchanged. Only those rows go through the LM head. `group`, the
    step's (group_id, group_leader, group_cnt), routes attention through
    the grouped walk; `attn_impl` pins the paged attend ("kernel" or
    "gather"). `lora`, (per-layer adapter pools, apage [S] int32, ascale
    [S] f32), adds the rows' LoRA deltas: each layer's pairs gathered
    per row, or with `megakernel` the whole pools handed to the fused op
    (K11); `megakernel` routes every layer's write and walk through it."""
    h = _backbone(model, pools, tokens, pos, page_table, q_len, group,
                  attn_impl, lora, megakernel)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last = torch.where(is_decode, torch.zeros_like(q_len),
                       torch.clamp(q_len - 1, min=0)).to(torch.int64)
    row_last = model.lm_head(h[rows, last]).float()
    return torch.where((q_len > 0)[:, None], row_last, last_logits)


def verify_forward(model, pools, tokens: torch.Tensor, pos: torch.Tensor,
                   page_table: torch.Tensor, q_len: torch.Tensor,
                   is_decode: torch.Tensor, last_logits: torch.Tensor,
                   head: tuple, group=None, attn_impl: Optional[str] = None,
                   lora=None, megakernel: bool = False,
                   vbias: Optional[tuple] = None) -> tuple:
    """The model half of a speculative unified step (the JAX step's
    verify epilogue): `unified_forward`'s trunk, then the LM head over
    the columns the step reads, `head` = (rows [n], cols [n], first [S])
    int64: each decode row's live columns (its sampled token and its
    drafts), each prefill row's last column, and each row's first entry
    among them. Greedy acceptance: draft column i + 1 is accepted while
    it equals the argmax of column i, and `accept` [S] int32 is the
    length of that prefix (0 for rows that do not decode) — by the plain
    expressions, or under `megakernel` by `spec_verify_accept`, K12 over
    every column of the [S, W, V] verify logits. `vbias`, (entries [k]
    int64 into the head's columns, bias [k, V] f32), is the grammar's:
    added to those columns' logits before the argmax and the acceptance
    (a draft the grammar forbids cannot match), never to the held
    logits. Returns (held logits [S, V] f32: a decode row's from column
    `accept`, a prefill row's from its last, a dead row's unchanged;
    accept)."""
    h = _backbone(model, pools, tokens, pos, page_table, q_len, group,
                  attn_impl, lora, megakernel)
    rows, cols, first = head
    logits = model.lm_head(h[rows, cols]).float()            # [n, V]
    biased = logits
    if vbias is not None:
        biased = logits.clone()
        biased[vbias[0]] += vbias[1]
    s, w = tokens.shape
    if megakernel:
        verify = logits.new_zeros((s, w, logits.shape[-1]))
        verify[rows, cols] = biased
        accept = spec_verify_accept(verify, tokens, q_len, is_decode)
    else:
        preds = torch.zeros_like(tokens)
        preds[rows, cols] = torch.argmax(biased, dim=-1).to(tokens.dtype)
        match = tokens[:, 1:] == preds[:, :-1]
        dcol = torch.arange(w - 1, device=tokens.device)[None, :]
        valid = dcol < (q_len.to(torch.int64) - 1)[:, None]
        accept = torch.cumprod((match & valid).to(torch.int32), dim=1).sum(
            dim=1).to(torch.int32)
        accept = torch.where(is_decode, accept, torch.zeros_like(accept))
    sel = first + torch.where(is_decode, accept.to(torch.int64), 0)
    held = torch.where((q_len > 0)[:, None], logits[sel], last_logits)
    return held, accept


def embed_forward(model, pools, tokens: torch.Tensor, pos: torch.Tensor,
                  page_table: torch.Tensor,
                  attn_impl: Optional[str] = None) -> torch.Tensor:
    """The embeddings lane's epilogue: tokens [B, 1], each row's last
    prompt token, at positions pos [B] int32 through the model's backbone
    over the per-layer pools (its K/V written in place at pos, then read
    with the row's prefix: K9, or K7 over int8 pools) via page_table
    [B, mp]; the f32 final hidden states [B, h]."""
    caches = _unpack_caches(pools, pos, page_table, attn_impl=attn_impl)
    h, _ = model_backbone(model)(tokens, caches=caches)
    return h[:, -1].float()


def legacy_forward(model, pools, tokens: torch.Tensor, pos: torch.Tensor,
                   page_table: torch.Tensor, last: torch.Tensor,
                   attn_impl: Optional[str] = None) -> torch.Tensor:
    """The model half of one legacy program: run tokens [B, l] through
    the model over the per-layer pools (written in place) at per-row
    positions pos [B] int32 through page_table [B, mp], and return the
    logits of column last[b] of each row, f32 [B, V]. A prefill chunk is
    B = 1 (the slot's table row) with last = its last real token; the
    decode step is every slot at l = 1."""
    caches = _unpack_caches(pools, pos, page_table, attn_impl=attn_impl)
    h, _ = model_backbone(model)(tokens, caches=caches)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return model.lm_head(h[rows, last]).float()


class ServingEngine:
    """Online inference engine: submit requests at any time, pump
    `step()` (or call `run()`/`generate()`); requests join free slots
    when their page budget fits the pool (or by preempting a less
    important resident), prefill chunk by chunk, decode together in the
    one unified step (or alternate prefill chunks with one decode step,
    `unified=False`), and retire on EOS, max-tokens, timeout, placement
    deadline or cancellation. `drain()` shuts down gracefully,
    `abort_all()` at once; `debug_state()` reads the live state.

    As in the JAX engine, `cache_spec` (n_layers, n_kv_heads, head_dim)
    defaults to the model's `_decode_cache_spec()`, a given `scheduler`
    (of `num_slots` slots) and `metrics` are the ones the engine uses,
    and `token_budget` caps the tokens one unified step packs (default
    `num_slots * chunk_len`, the full step shape)."""

    MIN_CHUNK = 8     # the smallest chunk (and legacy prefill bucket)

    def __init__(self, model, cache_spec=None, *, num_slots: int = 8,
                 max_len: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None, chunk_len: int = 32,
                 scheduler: Optional[Scheduler] = None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache=None, device: DeviceLike = None,
                 seed: int = 0, clock=time.monotonic, grouped=None,
                 preempt=None, host_pages: Optional[int] = None,
                 unified=None, attn_impl: Optional[str] = None,
                 kv_dtype=None, spec=None, grammar=None, adapters=None,
                 adapter_pages: Optional[int] = None,
                 adapter_ranks: Optional[Sequence[int]] = None,
                 mesh=None, megakernel=None, obs=None,
                 flight_steps: Optional[int] = None, slo=None,
                 cost_census=None, draft_pages: Optional[int] = None,
                 session_ttl_s: float = 30.0):
        resolve_unported_gates(mesh=mesh)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        if cache_spec is None:
            if not hasattr(model, "_decode_cache_spec"):
                raise ValueError(
                    "cache_spec not given and the model has no "
                    "_decode_cache_spec(); pass (n_layers, n_kv_heads, "
                    "head_dim) explicitly")
            cache_spec = model._decode_cache_spec()
        self.model = model
        self.n_layers, self.n_kv, self.head_dim = cache_spec
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        max_pos = getattr(getattr(model, "config", None),
                          "max_position_embeddings", None)
        if max_pos is not None and self.max_len > max_pos:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"{max_pos} positions")
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.max_pages = -(-self.max_len // self.page_size)
        # default pool: every slot can hold max_len (+ the trash page)
        self.num_pages = (self.num_slots * self.max_pages + 1
                          if num_pages is None else int(num_pages))
        self.chunk_len = int(chunk_len)
        if self.chunk_len < self.MIN_CHUNK:
            raise ValueError(f"chunk_len must be >= {self.MIN_CHUNK}")
        self.unified = resolve_unified_flag(unified)
        self.attn_impl = resolve_paged_attn_impl(attn_impl)
        # speculative decoding: a SpecConfig, or None when off. The verify
        # row is a unified-step row, so the legacy step refuses it
        self.spec = resolve_spec_config(spec)
        if self.spec is not None and not self.unified:
            raise ValueError(
                "speculative decoding requires the unified ragged "
                "step: the verify pass rides the per-row q_len>1 "
                "path (set unified=True / PADDLE_TPU_UNIFIED_STEP=on "
                "or turn PADDLE_TPU_SPEC_DECODE off)")
        # per-request drafters, made at admission for greedy requests and
        # dropped at retirement and preemption (request_id -> Drafter)
        self._drafters: Dict[str, Drafter] = {}
        # grammar-constrained decoding: the per-row bias rides the unified
        # step's sample, so the legacy step refuses the gate
        self.grammar_on = resolve_grammar_flag(grammar)
        if self.grammar_on and not self.unified:
            raise ValueError(
                "grammar-constrained decoding requires the unified "
                "ragged step: the mask operand rides the ONE compiled "
                "program (set unified=True / PADDLE_TPU_UNIFIED_STEP=on "
                "or turn PADDLE_TPU_GRAMMAR off)")
        # per-request automata, made at admission for constrained
        # requests and dropped at retirement and preemption
        self._grammars: Dict[str, TokenGrammar] = {}
        # host-to-device bytes of the last step's grammar biases, and the
        # sample's bias operand of the step in flight (None: no row)
        self.grammar_bias_bytes = 0
        self._gsamp: Optional[tuple] = None
        # how long a finished `session=` request's prefix pages stay
        # pinned above LRU (seconds of the engine's clock)
        self.session_ttl_s = float(session_ttl_s)
        # the tokens one unified step packs: decode rows always get
        # theirs, prefill grants share what is left. The default is the
        # full [num_slots, chunk_len] shape
        self.token_budget = (self.num_slots * self.chunk_len
                             if token_budget is None else int(token_budget))
        if self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.scheduler = scheduler or Scheduler(self.num_slots,
                                                max_queue=max_queue)
        if self.scheduler.num_slots != self.num_slots:
            raise ValueError("scheduler.num_slots != engine num_slots")
        # only the unified kernel step has a grouped walk: elsewhere the
        # flag drops silently (the JAX engine's rule)
        self.grouped = (resolve_grouped_flag(grouped) and self.unified
                        and self.attn_impl == "kernel")
        self.preempt = resolve_preempt_flag(preempt)
        # the decode megakernel: the unified kernel step only, dropped
        # silently elsewhere (the JAX engine's rule)
        self.megakernel = (resolve_megakernel_flag(megakernel)
                           and self.unified and self.attn_impl == "kernel")
        self.metrics = metrics or ServingMetrics()
        self.metrics.grouped = self.grouped
        self.metrics.megakernel = self.megakernel
        self.metrics.unified = self.unified
        self.metrics.spec = None if self.spec is None else self.spec.mode
        self.metrics.attn_impl = self.attn_impl
        # the distinct prefill buckets the legacy step has run
        self.prefill_buckets = set()
        self._clock = clock
        self._id_counter = itertools.count()
        self._requests: Dict[str, Request] = {}
        self._generator = make_generator(seed, self.device)
        # device state: per-layer (k, v, k_scale | None, v_scale | None)
        # pools, per-slot held logits. Every pool is zero-initialised,
        # scale pools too: the trash page dequantizes to exactly 0
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self._pools = [self._new_pools() for _ in range(self.n_layers)]
        # the tensors a whole-page move carries, as per-layer (k, v)
        # pairs of one shape: the pools (e4m3 ones as their bytes) and,
        # for int8, the scale pools — a page and its scales are one unit
        self._planes = [[(_as_bytes(k), _as_bytes(v))
                         for k, v, _, _ in self._pools]]
        if self.kv_dtype == "int8":
            self._planes.append([(ks, vs) for _, _, ks, vs in self._pools])
        # device bytes one page costs across all layers, K and V (codes
        # and scales for int8; fp8 one byte an element): the JAX engine's
        # formula, the unit of the byte gauges
        kv_item = (1 if self.kv_dtype in ("int8", "fp8")
                   else model.dtype.itemsize)
        scale_bytes = 4 if self.kv_dtype == "int8" else 0
        self.page_bytes = (self.n_layers * 2 * self.page_size * self.n_kv
                           * (self.head_dim * kv_item + scale_bytes))
        self.metrics.kv_dtype = self.kv_dtype
        self.metrics.pool_bytes_per_page = self.page_bytes
        # one device: the JAX engine's values at mp = dp = 1
        self.metrics.pool_shard_bytes_per_page = self.page_bytes
        self.metrics.grammar = self.grammar_on
        self.metrics.step_capacity_tokens = self.num_slots * self.chunk_len
        self._last_logits = torch.zeros(
            (self.num_slots, model.config.vocab_size), dtype=torch.float32,
            device=self.device)
        # host state: positions, page tables, sampling vectors
        self._pos = np.zeros((self.num_slots,), np.int32)
        # multi-tenant adapters: a paged adapter pool beside the KV pool
        adapters_on = (isinstance(adapters, AdapterStore)
                       or resolve_adapters_flag(adapters))
        if adapters_on and not self.unified:
            raise ValueError(
                "multi-tenant adapters require the unified ragged step: "
                "the per-row LoRA delta rides the unified step (set "
                "unified=True / PADDLE_TPU_UNIFIED_STEP=on or drop "
                "adapters)")
        if isinstance(adapters, AdapterStore):
            self.adapters: Optional[AdapterStore] = adapters
        elif adapters_on:
            cfg = model.config
            self.adapters = AdapterStore(
                self.n_layers, cfg.hidden_size,
                cfg.num_attention_heads * self.head_dim,
                self.n_kv * self.head_dim,
                num_pages=(8 if adapter_pages is None
                           else int(adapter_pages)) + 1,
                rank_buckets=adapter_ranks or (2, 4, 8), dtype=model.dtype,
                device=self.device)
        else:
            self.adapters = None
        # per-slot adapter operands: pool page and LoRA scale (page 0 and
        # scale 0 for base-model and idle rows)
        self._apage = np.zeros((self.num_slots,), np.int32)
        self._ascale = np.zeros((self.num_slots,), np.float32)
        self._adp_dev: Optional[tuple] = None          # None = re-upload
        self.metrics.adapters_enabled = self.adapters is not None
        if self.adapters is not None:
            self.metrics.adapter_stats = self.adapters.stats()
        self.pool = PagePool(self.num_pages)
        self.prefix_cache = (RadixPrefixCache(self.pool, self.page_size,
                                              clock=clock)
                             if resolve_prefix_cache_flag(prefix_cache)
                             else None)
        # the host tier: preempted residents' KV and spilled prefix pages
        self.host_pages = (self.num_pages - 1 if host_pages is None
                           else int(host_pages))
        self.host_pool = HostPagePool(self.host_pages)
        self.metrics.host_pages_total = self.host_pages
        if self.prefix_cache is not None and self.host_pages > 0:
            self.prefix_cache.set_host_tier(self._host_store_page,
                                            self._host_load_page,
                                            self._host_drop_page)
        self._slot_pages: Dict[int, List[int]] = {}
        self._prefill_cursor: Dict[str, int] = {}
        # the draft-model tier: the draft model resident beside the target
        # with its own float page pool (`draft_pages` pages with the trash
        # page, default the target pool's count)
        self._draft: Optional[DraftEngine] = None
        if self.spec is not None and self.spec.mode == "model":
            dm = self.spec.draft_model
            if dm is None:
                dm = make_draft_model(model)
            if dm.device != self.device:
                raise ValueError(f"draft model is on {dm.device}, engine "
                                 f"on {self.device}")
            self._draft = DraftEngine(dm, DraftConfig(
                num_slots=self.num_slots, chunk_len=self.chunk_len,
                page_size=self.page_size,
                num_pages=(self.num_pages if draft_pages is None
                           else int(draft_pages)),
                max_pages=self.max_pages, attn_impl=self.attn_impl))
        self.metrics.spec_draft_model = self._draft is not None
        if self._draft is not None:
            self.metrics.draft_pool_pages_total = self._draft.num_pages - 1
        self._pt_host = np.full((self.num_slots, self.max_pages),
                                TRASH_PAGE, np.int32)
        self._pt_dev: Optional[torch.Tensor] = None   # None = re-upload
        self._vec_dev: Optional[tuple] = None          # None = re-upload
        self._all_greedy = True
        self._closed = False     # drain() flips it; add_request refuses
        # liveness hook (the driver's): called at every step boundary and
        # around each round's launches, with the tokens of the launch in
        # flight in `step_tokens_inflight` (0 between launches)
        self.heartbeat_hook = None
        self.step_tokens_inflight = 0
        # fault hook: called with a round's participant request ids before
        # the round's first launch; a raise aborts the round with nothing
        # mutated, and a hook that raises for one request id is a
        # poisoned request (see the module doc)
        self.step_fault_hook = None
        # per-request host spans, begun at admission (request id -> span)
        self._spans: Dict[str, RecordEvent] = {}
        # the request tracer and flight recorder (None with the gate off)
        self.obs = (EngineObs(flight_steps=flight_steps, clock=self._clock)
                    if resolve_obs_flag(obs) else None)
        slo_cfg = resolve_slo_config(slo)
        self.slo = (SLOTracker(slo_cfg, clock=self._clock,
                               on_transition=self._on_slo_transition,
                               track_adapters=self.adapters is not None)
                    if slo_cfg is not None else None)
        self.metrics.slo = self.slo
        # the cost census: captured at most once (`cost_census()`)
        self.census_mode = resolve_cost_census(cost_census)
        self._census: Optional[dict] = None
        self._census_captures = 0
        self._census_lock = threading.Lock()
        # the last unified step's modeled page-walk bytes (the census's
        # "page_walk" record) and the adapter bytes one row streams
        self._last_walk_bytes: Optional[dict] = None
        self._adapter_row_bytes = 0
        if self.adapters is not None:
            ad = self.adapters
            self._adapter_row_bytes = int(
                (ad.hidden * ad.rank + ad.rank * ad.q_out)
                * ad.dtype.itemsize)
        self.step_capacity_tokens = self.num_slots * self.chunk_len
        # the KV fabric's wire counters (the census's "fabric" record)
        self._fabric_pages_sent = 0
        self._fabric_bytes_sent = 0
        self._fabric_pages_recv = 0
        self._fabric_bytes_recv = 0
        self._step_idx = 0       # engine rounds run (debug_state's step)
        # the running round's token split and wall time, read by the
        # flight record
        self._round_stats = self._new_round_stats()

    def _new_pools(self) -> tuple:
        """One layer's zeroed (k, v, k_scale | None, v_scale | None)."""
        shape = (self.num_pages, self.page_size, self.n_kv, self.head_dim)
        zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=self.device)
        if self.kv_dtype == "int8":
            return (zeros(shape, torch.int8), zeros(shape, torch.int8),
                    zeros(shape[:3], torch.float32),
                    zeros(shape[:3], torch.float32))
        if self.kv_dtype == "fp8":
            return (zeros(shape, torch.uint8).view(FP8_DTYPE),
                    zeros(shape, torch.uint8).view(FP8_DTYPE), None, None)
        return (zeros(shape, self.model.dtype),
                zeros(shape, self.model.dtype), None, None)

    # -- observability -----------------------------------------------------
    @staticmethod
    def _new_round_stats() -> dict:
        return {"prefill_tokens": 0, "decode_tokens": 0, "draft_tokens": 0,
                "accepted_tokens": 0, "draft_seed_tokens": 0,
                "reads_saved": 0, "constrained_rows": 0,
                "grammar_rejected": 0, "wall_s": 0.0}

    def _obs_event(self, req: Request, kind: str, **detail):
        """Record one request-timeline event (a no-op with obs off)."""
        if self.obs is not None:
            detail.setdefault("slot", req.slot)
            self.obs.tracer.record(req.request_id, kind, t=self._clock(),
                                   step=self._step_idx, **detail)

    def _on_slo_transition(self, tr: dict):
        """An SLO series changed alert state: a note in the flight ring,
        so an incident dump shows the SLO burning among the steps."""
        if self.obs is not None:
            where = (tr["scope"] if not tr["label"]
                     else f"{tr['scope']}:{tr['label']}")
            self.obs.flight.note(
                f"slo:{tr['to']}",
                f"{tr['slo']}[{where}] {tr['from']}->{tr['to']} "
                f"burn fast={tr['fast_burn']} slow={tr['slow_burn']}")

    def _slo_snap(self) -> Optional[dict]:
        return None if self.slo is None else self.slo.snapshot()

    def _note(self, kind: str, detail: str):
        """A note in the flight ring (a no-op with obs off)."""
        if self.obs is not None:
            self.obs.flight.note(kind, detail)

    def _incident(self, kind: str, detail: str):
        if self.obs is not None:
            self.obs.flight.incident(kind, detail=detail,
                                     step=self._step_idx,
                                     slo=self._slo_snap())

    def _beat(self):
        hook = self.heartbeat_hook
        if hook is not None:
            hook()

    def _end_span(self, req: Request):
        span = self._spans.pop(req.request_id, None)
        if span is not None:
            span.end()

    def cost_census(self) -> Optional[dict]:
        """The step cost census (None with the gate off): FLOPs and bytes
        of the unified step's program capacity, captured at most once
        ("model" right after the first round; "lowered"/"xla" here, at
        the first read). The record also carries the KV fabric's wire
        counters and the last unified step's modeled page-walk bytes,
        refreshed on each read, and is pushed into the metrics
        snapshot."""
        if self.census_mode == "off":
            return None
        with self._census_lock:
            if self._census is None:
                self._capture_census()
            self._census["fabric"] = {
                "pages_sent": self._fabric_pages_sent,
                "bytes_sent": self._fabric_bytes_sent,
                "pages_recv": self._fabric_pages_recv,
                "bytes_recv": self._fabric_bytes_recv}
            if self._last_walk_bytes is not None:
                wb = self._last_walk_bytes
                tok = max(1, int(wb["tokens"]))
                self._census["page_walk"] = {
                    "megakernel": self.megakernel,
                    "modeled_step_bytes": {"unfused": wb["unfused"],
                                           "fused": wb["fused"]},
                    "modeled_bytes_per_token": {
                        "unfused": wb["unfused"] / tok,
                        "fused": wb["fused"] / tok},
                }
        self.metrics.cost_census = self._census
        return self._census

    @property
    def _census_counted(self) -> bool:
        """Whether the census is counted from a forward on the device
        ("lowered"/"xla" on the unified step) rather than modeled."""
        return self.unified and self.census_mode in ("lowered", "xla")

    def _capture_census(self):
        """Build the census record (callers hold _census_lock). Only the
        unified step has a counted forward; a legacy engine's record is
        the model's, as in the JAX engine."""
        tensors = list(self.model.parameters()) + list(self.model.buffers())
        n_params = sum(t.numel() for t in tensors)
        param_bytes = sum(t.numel() * t.element_size() for t in tensors)
        cfg = getattr(self.model, "config", None)
        fallback = model_cost_census(
            n_params=n_params, param_bytes=param_bytes,
            num_slots=self.num_slots, chunk_len=self.chunk_len,
            max_pages=self.max_pages, page_bytes=self.page_bytes,
            n_heads=int(getattr(cfg, "num_attention_heads", self.n_kv)),
            head_dim=self.head_dim, page_size=self.page_size)
        counted = self._census_counted
        self._census = capture_cost_census(
            self.census_mode, self._census_forward if counted else None,
            self._census_operands() if counted else None,
            capacity_tokens=self.step_capacity_tokens, fallback=fallback)
        self._census_captures += 1

    def _census_operands(self) -> tuple:
        """The unified step's operands at its full shape, every row
        prefilling chunk_len tokens at position 0 through a page table of
        trash pages, so the counted forward writes the trash page only."""
        S, W, dev = self.num_slots, self.chunk_len, self.device
        q_len = np.full((S,), W, np.int32)
        table = np.full((S, self.max_pages), TRASH_PAGE, np.int32)
        group = (None if not self.grouped else tuple(
            torch.from_numpy(np.stack(shared_prefix_groups(table, q_len)))
            .to(dev).unbind(0)))
        lora = None
        if self.adapters is not None:
            zero = torch.zeros((S,), dtype=torch.int32, device=dev)
            lora = (self.adapters.pools, zero, zero.float())
        return (torch.zeros((S, W), dtype=torch.int64, device=dev),
                torch.zeros((S,), dtype=torch.int32, device=dev),
                torch.from_numpy(table).to(dev),
                torch.from_numpy(q_len).to(dev),
                torch.zeros((S,), dtype=torch.bool, device=dev),
                group, lora)

    @torch.no_grad()
    def _census_forward(self, tokens, pos, page_table, q_len, is_decode,
                        group, lora):
        """One forward of the unified step for the census: its held
        logits are dropped, and no position, cursor or held logit
        moves."""
        unified_forward(self.model, self._pools, tokens, pos, page_table,
                        q_len, is_decode, self._last_logits, group,
                        self.attn_impl, lora, self.megakernel)

    # -- request intake ----------------------------------------------------
    @staticmethod
    def _budget_new(sampling: SamplingParams) -> int:
        """The output tokens a request reserves KV for: an embed request
        runs prefill only and retires at the end of its prompt, so it
        reserves none (max_new_tokens is ignored)."""
        return 0 if sampling.embed else sampling.max_new_tokens

    def add_request(self, prompt_ids, sampling: Optional[SamplingParams]
                    = None, request_id: Optional[str] = None,
                    on_token=None) -> Request:
        if self._closed:
            raise EngineClosed(
                "engine is draining/closed; no new requests admitted")
        sampling = sampling or SamplingParams()
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids).reshape(-1)
        if prompt.size >= self.max_len:
            raise ValueError(f"prompt length {prompt.size} >= engine "
                             f"max_len {self.max_len}")
        if prompt.size + self._budget_new(sampling) > self.max_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{sampling.max_new_tokens} exceeds engine max_len "
                f"{self.max_len}")
        if sampling.grammar is not None and not self.grammar_on:
            raise ValueError(
                "request carries a grammar constraint but this "
                "engine's grammar gate is off (enable it via "
                "ServingEngine(grammar=True) / PADDLE_TPU_GRAMMAR=on)")
        if sampling.embed and not self.unified:
            raise ValueError(
                "the embeddings lane rides the unified ragged step's "
                "prefill packing (set unified=True / "
                "PADDLE_TPU_UNIFIED_STEP=on)")
        need = pages_needed(prompt.size, self._budget_new(sampling),
                            self.page_size)
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.num_pages - 1} allocatable pages")
        aid = sampling.adapter_id
        if aid != BASE_ADAPTER:
            if self.adapters is None:
                raise ValueError(
                    f"request carries adapter_id {aid} but this engine has "
                    "no adapter subsystem (enable it via "
                    "ServingEngine(adapters=True) / PADDLE_TPU_ADAPTERS=on "
                    "and register the adapter first)")
            if not self.adapters.known(aid):
                raise ValueError(
                    f"unknown adapter_id {aid}: register the adapter on "
                    "this engine's AdapterStore before submitting requests "
                    "under it")
        if request_id is None:
            request_id = f"req-{next(self._id_counter)}"
        if request_id in self._requests:
            raise ValueError(f"duplicate request_id {request_id!r}")
        req = Request(request_id, prompt, sampling, on_token=on_token,
                      arrival_t=self._clock())
        self.scheduler.submit(req)
        self._requests[request_id] = req
        self.metrics.on_submit(req)
        if self.adapters is not None:
            self.metrics.on_adapter_request(aid)
        if sampling.grammar is not None:
            self.metrics.on_grammar_request()
        self._obs_event(req, "submit", prompt_len=int(prompt.size),
                        priority=int(sampling.priority),
                        queue_depth=self.scheduler.queue_depth)
        return req

    def cancel(self, request_id: str) -> bool:
        """Cancel a request: a queued or preempted one drops now (a
        preempted one's host pages with it), a running one is evicted at
        the next step boundary and its pages return."""
        req = self._requests.get(request_id)
        if req is None or req.finished:
            return False
        if req.state in (RequestState.QUEUED, RequestState.PREEMPTED):
            self.scheduler.drop_queued(req)
            self._finish_and_free(req, "cancelled", self._clock(), [])
            return True
        req.state = RequestState.CANCELLED
        return True

    # -- step boundary: retire / admit -------------------------------------
    def _free_slot(self, slot: int):
        self.scheduler.retire(slot)
        if self._draft is not None:
            # draft K/V is recomputable: every slot-freeing path drops
            # its pages outright (no host tier, no prefix cache)
            self._draft.release(slot)
        self._vec_dev = None
        self._pt_host[slot, :] = TRASH_PAGE
        self._pt_dev = None
        self._apage[slot] = 0
        self._ascale[slot] = 0.0
        self._adp_dev = None

    def _release_adapter(self, req: Request):
        """Drop the request's reference on its adapter's page (an
        adapter nobody uses parks hot)."""
        if req._adapter_held:
            self.adapters.release(req.sampling.adapter_id)
            req._adapter_held = False

    def _finish_and_free(self, req: Request, reason: str, now: float,
                         finished: List[RequestOutput]):
        self._obs_event(req, _TERMINAL_EVENT.get(reason, reason),
                        cause=reason, tokens=len(req.output_tokens))
        if req.slot is not None:
            slot = req.slot
            self._free_slot(slot)
            pages = self._slot_pages.pop(slot, None)
            if pages:
                self._retire_pages(req, reason, pages)
            req.pages = None
            req._prefix_grant = None
        self._release_adapter(req)
        self._release_swap(req)   # preempted and never resumed
        self._prefill_cursor.pop(req.request_id, None)
        self._drafters.pop(req.request_id, None)
        self._grammars.pop(req.request_id, None)
        self._end_span(req)
        self._requests.pop(req.request_id, None)
        req._finish(reason, now)
        self.metrics.on_finish(req, now)
        finished.append(req.output())

    def _retire_pages(self, req: Request, reason: str, pages: List[int]):
        """Without the prefix cache pages return to the pool; with it, a
        normally finished request's written pages are inserted into the
        radix tree and any other retirement drops its references."""
        if self.prefix_cache is None:
            self.pool.free(pages)
        elif reason in ("stop", "length"):
            # every emitted token's KV was written by the step that
            # sampled it, so prompt + output positions are valid
            seq = np.concatenate([req.prompt_ids.astype(np.int64),
                                  np.asarray(req.output_tokens, np.int64)])
            self.prefix_cache.insert(seq, pages, seq.size,
                                     adapter_id=req.sampling.adapter_id)
            # a session's chain is pinned above LRU for the TTL: its
            # next turn hits warm pages by contract
            if req.sampling.session:
                self.prefix_cache.pin(seq, self.session_ttl_s,
                                      adapter_id=req.sampling.adapter_id)
        else:
            self.prefix_cache.release(pages)

    def _evict(self, now: float, finished: List[RequestOutput]):
        # a queued request past its placement deadline fails fast
        for req in self.scheduler.deadline_expired(now):
            self.scheduler.drop_queued(req)
            req.error = DeadlineExceeded(
                f"request {req.request_id} missed its placement deadline "
                f"({req.sampling.deadline_s}s) while queued")
            self._finish_and_free(req, "deadline", now, finished)
            # the 504 fail-fast freezes the ring: the postmortem shows
            # what the engine was doing while the request starved
            self._incident("deadline", req.request_id)
        for req in self.scheduler.expired(now):
            if req.state in (RequestState.QUEUED, RequestState.PREEMPTED):
                self.scheduler.drop_queued(req)
            self._finish_and_free(req, "timeout", now, finished)
        for req in self.scheduler.cancelled_running():
            self._finish_and_free(req, "cancelled", now, finished)

    def _reserve(self, req: Request) -> bool:
        """Page-aware admission: grant the slot only if the request's
        whole page budget is available now (match-then-reserve with the
        prefix cache, which spills and evicts parked pages before it
        refuses). A preempted request re-admits through
        `_reserve_resume`. With adapters on, the request's adapter is
        claimed first (made device-resident, one reference taken); an
        adapter pool full of referenced adapters refuses like KV page
        pressure, and a KV refusal releases the claim."""
        if self.adapters is not None:
            binding = self.adapters.acquire(req.sampling.adapter_id)
            if binding is None:
                return False     # every adapter page is referenced
            req._adapter_binding = binding
            req._adapter_held = True
        ok = (self._reserve_resume(req) if req._swap is not None
              else self._reserve_kv(req))
        if not ok:
            self._release_adapter(req)
        return ok

    def _reserve_kv(self, req: Request) -> bool:
        """The KV-page half of `_reserve` (fresh admission)."""
        if self.prefix_cache is None:
            pages = self.pool.alloc(pages_needed(
                req.prompt_ids.size, self._budget_new(req.sampling),
                self.page_size))
            if pages is None:
                return False
            req.pages = pages
            return True
        grant = self.prefix_cache.acquire(req.prompt_ids,
                                          self._budget_new(req.sampling),
                                          adapter_id=req.sampling.adapter_id)
        if grant is None:
            return False
        req.pages = grant.pages
        req.cached_tokens = grant.cached_len
        req._prefix_grant = grant
        return True

    def _reserve_resume(self, req: Request) -> bool:
        """Re-admission of a PREEMPTED request: allocate the page budget
        of its committed sequence (prefix-matched against the radix tree
        when the cache is on: the prefix released at preemption usually
        re-attaches), then plan which host pages swap back into which
        page-table positions (`_apply_swap_in` runs the copies). A
        refusal leaves the host copy and the queue position as they
        were."""
        swap = req._swap
        seq = req.prefill_ids
        remaining = self._budget_new(req.sampling) - len(req.output_tokens)
        ps = self.page_size
        if self.prefix_cache is not None:
            grant = self.prefix_cache.acquire(
                seq, remaining, adapter_id=req.sampling.adapter_id)
            if grant is None:
                return False
            pages = grant.pages
            m_full = grant.matched_full_pages
            match_cov = grant.cached_len
        else:
            pages = self.pool.alloc(pages_needed(seq.size, remaining, ps))
            if pages is None:
                return False
            grant, m_full, match_cov = None, 0, 0
        # host slot j holds page-table index swap.base + j. Indices below
        # the fresh match are shared tree pages that already hold the
        # same KV (drop the host copy, never write through them); the
        # rest restore into the grant's private pages. The window only
        # extends coverage when it is contiguous with the match.
        swap.restores, swap.drops = [], []
        cov = match_cov
        if m_full >= swap.base:
            end = min(swap.kv_len, (swap.base + len(swap.host_slots)) * ps)
            for j, host_slot in enumerate(swap.host_slots):
                idx = swap.base + j
                if idx < m_full:
                    swap.drops.append(host_slot)
                else:
                    swap.restores.append((host_slot, pages[idx]))
            if swap.restores and end > m_full * ps:
                # restored pages supersede a partial-page COW planned at
                # index m_full: cancel the copy (its content is a prefix
                # of the restored page)
                if grant is not None and grant.cow_src is not None:
                    self.prefix_cache.cow_done(grant)
                    grant.cow_dst = None
                    cov = max(m_full * ps, end)
                else:
                    cov = max(match_cov, end)
        else:
            swap.drops = list(swap.host_slots)
        req.pages = pages
        req._prefix_grant = grant
        req.cached_tokens = min(cov, seq.size - 1)
        return True

    def _release_swap(self, req: Request):
        """Discard a preempted request's host-tier KV (it died before
        resuming: cancel, timeout, abort)."""
        swap = req._swap
        if swap is None:
            return
        for host_slot in swap.host_slots:
            self.host_pool.free(host_slot)
        if swap.host_slots:
            self.pool.drop_swapped(len(swap.host_slots))
        req._swap = None

    def _apply_swap_in(self, req: Request):
        """Run the restore plan `_reserve_resume` made: copy each
        surviving host page into its fresh device page and release the
        redundant ones."""
        swap = req._swap
        t0 = time.perf_counter()
        if swap.restores:
            self._restore_pages(
                [self.host_pool.load(host_slot)
                 for host_slot, _ in swap.restores],
                [dst for _, dst in swap.restores])
            for host_slot, _ in swap.restores:
                self.host_pool.free(host_slot)
            self.pool.swapped_restored(len(swap.restores))
        for host_slot in swap.drops:
            self.host_pool.free(host_slot)
        if swap.drops:
            self.pool.drop_swapped(len(swap.drops))
        req._swap = None
        self.metrics.on_swap_in(len(swap.restores),
                                time.perf_counter() - t0)

    def _admit(self, now: float):
        for slot, req in self.scheduler.assign(reserve=self._reserve):
            req.state = RequestState.PREFILL
            req.admitted_t = now
            span = RecordEvent(f"serving::request[{req.request_id}]")
            span.begin()
            self._spans[req.request_id] = span
            self._slot_pages[slot] = req.pages
            self._pt_host[slot, :] = TRASH_PAGE
            self._pt_host[slot, :len(req.pages)] = req.pages
            self._pt_dev = None
            self._vec_dev = None
            if self.adapters is not None:
                # the page is stable while the slot holds its reference
                self._apage[slot], self._ascale[slot] = req._adapter_binding
                self._adp_dev = None
            self._obs_event(req, "admit", pages=len(req.pages or ()),
                            cached_tokens=int(req.cached_tokens),
                            resumed=req._swap is not None)
            # a resumed request's banked KV comes back from the host
            # tier before any prefill touches the slot
            if req._swap is not None:
                n_restore = len(req._swap.restores)
                self._apply_swap_in(req)
                self._obs_event(req, "swap_in", pages=n_restore)
            # prefill starts at the first uncached token
            self._pos[slot] = req.cached_tokens
            grant = req._prefix_grant
            if grant is not None and grant.cow_src is not None:
                self._copy_page(grant.cow_src, grant.cow_dst)
                self.prefix_cache.cow_done(grant)
            self._prefill_cursor[req.request_id] = req.cached_tokens
            # one drafter a greedy request, made anew at each admission (a
            # resumed request's history already holds its banked tokens);
            # the model tier reserves the slot's draft pages, and under
            # draft-pool pressure the slot just drafts later
            if self.spec is not None and req.sampling.greedy:
                drafter = self.spec.make_drafter()
                self._drafters[req.request_id] = drafter
                if (self._draft is not None
                        and isinstance(drafter, ModelDrafter)):
                    self._draft.admit(slot, int(req.prompt_ids.size),
                                      self._budget_new(req.sampling))
            # one automaton a constrained request, made anew at each
            # admission: it replays the `grammar_prefix` prompt tokens
            # that are already output, then the emitted tokens (EOS, a
            # terminator, never reaches it), so a resumed stream goes on
            # constrained
            if self.grammar_on and req.sampling.grammar is not None:
                g = req.sampling.grammar.make(int(self._last_logits.shape[-1]))
                eos = req.sampling.eos_token_id
                k = int(req.sampling.grammar_prefix or 0)
                replay = list(req.prompt_ids[-k:]) if k else []
                replay.extend(req.output_tokens)
                for t in replay:
                    if eos is None or int(t) != eos:
                        g.advance(int(t))
                self._grammars[req.request_id] = g
            self.metrics.on_admit(req, self._clock())

    # -- preemption --------------------------------------------------------
    def _preempt(self, slot: int, req: Request, now: float):
        """Preempt one resident: bank its committed tokens, copy its
        private committed KV pages to the host tier (the tail recomputes
        where the tier is full), release its shared prefix pages, free
        the slot and requeue it by its original key."""
        pages = self._slot_pages.pop(slot)
        self._free_slot(slot)
        # the adapter reference drops with the slot (the adapter may spill
        # or be evicted while the request waits); resume acquires again
        self._release_adapter(req)
        # committed KV: a decode row holds prompt + every emitted token,
        # a mid-prefill row exactly its prefill cursor
        if req.state is RequestState.DECODE:
            kv_len = int(req.prompt_ids.size) + len(req.output_tokens)
        else:
            kv_len = int(self._prefill_cursor.get(req.request_id, 0))
        self._prefill_cursor.pop(req.request_id, None)
        # the drafter goes and the draft pages went with the slot: resume
        # makes a new drafter and re-seeds the draft K/V from the history
        self._drafters.pop(req.request_id, None)
        self._grammars.pop(req.request_id, None)
        self._end_span(req)
        grant = req._prefix_grant
        base = grant.matched_full_pages if grant is not None else 0
        shared, private = pages[:base], pages[base:]
        if shared:
            self.prefix_cache.release(shared)
        n_kv = -(-kv_len // self.page_size)
        # the committed private pages the host tier has room for; where
        # it is full, the tail recomputes
        n_keep = max(0, min(n_kv - base, len(private),
                            self.host_pool.free_pages))
        host_slots = [self.host_pool.store(data) for data in
                      self._extract_pages(private[:n_keep])]
        kept = private[:n_keep]
        if kept:
            self.pool.swap_out(kept)
        rest = private[len(host_slots):]
        if rest:
            self.pool.free(rest)
        req._swap = _SwapHandle(host_slots, base, kv_len)
        req._resume_ids = np.concatenate(
            [req.prompt_ids.astype(np.int64),
             np.asarray(req.output_tokens, np.int64)])
        req.pages = None
        req._prefix_grant = None
        req.state = RequestState.PREEMPTED
        req.preemptions += 1
        self.scheduler.requeue(req)
        self.metrics.on_preempt(len(kept))
        self._obs_event(req, "preempt", slot=slot, cause="overload",
                        pages=len(kept), kv_len=kv_len,
                        tokens=len(req.output_tokens))

    def _preempt_for_overload(self, now: float):
        """After admission, a still-queued head means backpressure —
        unless a strictly lower-priority resident exists: preempt the
        least important one, admit again, and repeat while the head
        keeps outranking someone."""
        if not self.preempt:
            return
        for _ in range(self.num_slots):
            head = self.scheduler.peek_queued()
            if head is None:
                break
            victim = self.scheduler.preemption_victim(head)
            if victim is None:
                break
            self._preempt(victim[0], victim[1], now)
            self._admit(now)

    # -- page copies: COW and the host tier --------------------------------
    def _copy_page(self, src: int, dst: int):
        """Copy-on-write: one page of every layer's K and V pool (and,
        for int8, of its scale pools)."""
        with RecordEvent(f"serving::cow_copy[{src}->{dst}]"):
            for plane in self._planes:
                for k, v in plane:
                    k[dst].copy_(k[src])
                    v[dst].copy_(v[src])

    def _extract_pages(self, pages: List[int]) -> List[tuple]:
        """Device -> host: each page of every layer's K and V, as a tuple
        of CPU tensors (views of tensors allocated here): the codes
        [n_layers, 2, page_size, H_kv, D] (e4m3 ones as bytes) and, for
        int8, the scales [n_layers, 2, page_size, H_kv], gathered with
        one index_select per pool. From the card the copy lands in pinned
        memory without blocking the host; the stream orders it before any
        later write of the pages and before the copies that restore
        them."""
        if not pages:
            return []
        with RecordEvent(f"serving::swap_out[{len(pages)}]"):
            idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
            blocks = [torch.stack([torch.stack((k.index_select(0, idx),
                                                v.index_select(0, idx)), 1)
                                   for k, v in plane], 1)
                      .to("cpu", non_blocking=True).unbind(0)
                      for plane in self._planes]
            return list(zip(*blocks))

    def _restore_pages(self, payloads: List[tuple], dsts: List[int]):
        """Host -> device: write payloads of `_extract_pages` into device
        pages `dsts` of every layer's pools, one index_copy_ per pool."""
        with RecordEvent(f"serving::swap_in[{len(dsts)}]"):
            idx = torch.tensor(dsts, dtype=torch.int64, device=self.device)
            for p, plane in enumerate(self._planes):
                block = torch.stack([data[p].to(self.device,
                                                non_blocking=True)
                                     for data in payloads])
                for i, (k, v) in enumerate(plane):
                    k.index_copy_(0, idx, block[:, i, 0])
                    v.index_copy_(0, idx, block[:, i, 1])

    def _extract_page(self, src: int) -> tuple:
        """One page of `_extract_pages`."""
        return self._extract_pages([src])[0]

    def _restore_page(self, data: tuple, dst: int):
        """One page of `_restore_pages`."""
        self._restore_pages([data], [dst])

    def _host_store_page(self, page: int) -> Optional[int]:
        """Prefix spill: copy a parked page to the host tier; its host
        slot (the cache then swaps the device page out), or None when
        the tier is full."""
        if self.host_pool.free_pages == 0:
            return None
        return self.host_pool.store(self._extract_page(page))

    def _host_load_page(self, host_slot: int) -> Optional[int]:
        """Prefix restore: copy a spilled page into a fresh device page,
        handed back PARKED. Under pressure another parked page spills to
        make room (the match in progress is retained, so it is never
        the one displaced); None when no page can be freed — the match
        stops and the tail prefills."""
        pages = self.pool.alloc(1)
        if pages is None and self.prefix_cache.spill(1) >= 1:
            pages = self.pool.alloc(1)
        if pages is None:
            return None
        self._restore_page(self.host_pool.load(host_slot), pages[0])
        self.host_pool.free(host_slot)
        self.pool.swapped_restored(1, spill=True)
        self.pool.release(pages)
        self.pool.park(pages)
        self.metrics.on_swap_in(1, 0.0)
        return pages[0]

    def _host_drop_page(self, host_slot: int):
        """A spilled page was evicted from the tree while on the host."""
        self.host_pool.free(host_slot)
        self.pool.drop_swapped(1, spill=True)

    # -- the KV fabric (serving.fabric) ------------------------------------
    @property
    def fabric_geometry(self) -> dict:
        """The page geometry a transfer frame must match to be graftable
        here: pages are raw pool blocks, so every axis must agree."""
        return {"kv_dtype": self.kv_dtype, "page_size": self.page_size,
                "n_layers": self.n_layers, "n_kv": self.n_kv,
                "head_dim": self.head_dim}

    def _fabric_fp_dtype(self) -> torch.dtype:
        """The element dtype a float or e4m3 frame's blob reads as here:
        the pool's own (e4m3 pools move as their bytes)."""
        return torch.uint8 if self.kv_dtype == "fp8" else self.model.dtype

    def _fabric_alloc_restore(self, payload) -> Optional[int]:
        """graft/load callback: one device page (spilling a parked LRU
        page to the host tier under pressure, never evicting, which could
        tear down the chain being grafted) with the payload written into
        it, handed back PARKED; None when no page can be had, which ends
        the graft at that depth."""
        pages = self.pool.alloc(1)
        if pages is None and self.prefix_cache is not None \
                and self.prefix_cache.spill(1) >= 1:
            pages = self.pool.alloc(1)
        if pages is None:
            return None
        self._restore_page(payload, pages[0])
        self.pool.release(pages)
        self.pool.park(pages)
        return pages[0]

    def _host_copies_landed(self):
        """Wait for the device-to-host page copies in flight:
        `_extract_pages` copies into pinned memory without blocking, and
        bytes read from those tensors before the stream reaches them are
        garbage."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _chain_payloads(self, refs) -> list:
        """The payloads of a `collect_chain` chain: device pages read in
        one swap-out copy, spilled pages straight from the host tier."""
        dev = [ref for kind, ref in refs if kind == "page"]
        read = iter(self._extract_pages(dev))
        return [next(read) if kind == "page" else self.host_pool.load(ref)
                for kind, ref in refs]

    def export_prefix_frame(self, tokens, adapter_id: int = 0
                            ) -> Optional[bytes]:
        """Serialise the committed page chain covering `tokens` into one
        transfer frame (None without the prefix cache, or when the tree
        holds no full page of it). Called between steps, like every
        page-table touch."""
        if self.prefix_cache is None:
            return None
        depth, refs = self.prefix_cache.collect_chain(tokens, adapter_id)
        if depth <= 0:
            return None
        payloads = self._chain_payloads(refs)
        self._host_copies_landed()
        tok = np.ascontiguousarray(
            np.asarray(tokens).reshape(-1)[:depth], dtype=np.int64)
        frame = encode_frame(
            kv_dtype=self.kv_dtype, page_size=self.page_size,
            n_layers=self.n_layers, n_kv=self.n_kv,
            head_dim=self.head_dim, tokens=tok, payloads=payloads,
            valid=depth, adapter_id=adapter_id,
            fp_itemsize=(1 if self.kv_dtype in ("int8", "fp8")
                         else self.model.dtype.itemsize))
        self._fabric_pages_sent += len(payloads)
        self._fabric_bytes_sent += len(frame)
        self.metrics.on_fabric(sent_pages=len(payloads),
                               sent_bytes=len(frame))
        self._note("fabric:send",
                   f"{len(payloads)}p/{depth}tok/{len(frame)}B "
                   f"adapter={adapter_id} dtype={self.kv_dtype}")
        return frame

    def import_prefix_frame(self, frame: bytes) -> int:
        """Graft a transfer frame from another engine into this tree, so
        the next admission hits it. The header's geometry must equal
        `fabric_geometry` key for key: a mismatched frame is refused
        whole, before any page is touched. Returns the pages grafted
        (spans already cached cost nothing)."""
        if self.prefix_cache is None:
            return 0
        header = frame_header(frame)
        for key, want in self.fabric_geometry.items():
            if header.get(key) != want:
                raise ValueError(
                    f"fabric frame geometry mismatch: {key}="
                    f"{header.get(key)!r}, this engine has {want!r}")
        _, tokens, payloads = decode_frame(
            frame, fp_dtype=self._fabric_fp_dtype())
        grafted = self.prefix_cache.graft(
            tokens, payloads, int(header["valid"]),
            int(header["adapter_id"]),
            alloc_restore=self._fabric_alloc_restore)
        self._fabric_pages_recv += grafted
        self._fabric_bytes_recv += len(frame)
        self.metrics.on_fabric(recv_pages=grafted, recv_bytes=len(frame))
        self._note("fabric:recv",
                   f"{grafted}/{header['n_pages']}p grafted "
                   f"{len(frame)}B adapter={header['adapter_id']}")
        return grafted

    def export_prefix_state(self) -> Optional[dict]:
        """The whole radix tree, structure and page payloads (device and
        host tier), as one host-side record for a warm restart."""
        if self.prefix_cache is None:
            return None
        snap = self.prefix_cache.snapshot(self._extract_page,
                                          self.host_pool.load)
        self._host_copies_landed()
        snap["geometry"] = self.fabric_geometry
        self._note("fabric:snapshot", f"{len(snap['nodes'])} nodes")
        return snap

    def import_prefix_state(self, snap: Optional[dict]) -> int:
        """Warm-start this engine from an `export_prefix_state` record
        (the geometry must match; pages that no longer fit drop with
        their subtrees). Returns the pages restored."""
        if snap is None or self.prefix_cache is None:
            return 0
        geo = snap.get("geometry")
        if geo is not None and dict(geo) != self.fabric_geometry:
            raise ValueError(
                f"prefix snapshot geometry {geo} does not match "
                f"this engine ({self.fabric_geometry})")
        restored = self.prefix_cache.load(
            snap, alloc_restore=self._fabric_alloc_restore)
        self.metrics.on_fabric(restored_pages=restored)
        self._note("fabric:restore",
                   f"{restored}/{len(snap['nodes'])} pages warm")
        return restored

    # -- the unified step --------------------------------------------------
    def _page_table(self) -> torch.Tensor:
        if self._pt_dev is None:
            self._pt_dev = torch.from_numpy(self._pt_host).to(self.device)
        return self._pt_dev

    def _sampling_vectors(self) -> tuple:
        """(temps, top_k, top_p, greedy) device vectors, rebuilt when
        membership changed."""
        if self._vec_dev is None:
            temps = np.ones((self.num_slots,), np.float32)
            topk = np.zeros((self.num_slots,), np.int32)
            topp = np.ones((self.num_slots,), np.float32)
            greedy = np.ones((self.num_slots,), bool)
            for s, req in self.scheduler.running.items():
                sp = req.sampling
                temps[s] = sp.temperature
                topk[s] = sp.top_k or 0
                topp[s] = sp.top_p if sp.top_p is not None else 1.0
                greedy[s] = sp.greedy
            self._all_greedy = bool(greedy.all())
            self._vec_dev = tuple(torch.from_numpy(a).to(self.device)
                                  for a in (temps, topk, topp, greedy))
        return self._vec_dev

    def _adapter_operands(self) -> Optional[tuple]:
        """(adapter pools, apage [S] int32, ascale [S] f32) for the step,
        the vectors rebuilt when membership changed; None without
        adapters."""
        if self.adapters is None:
            return None
        if self._adp_dev is None:
            self._adp_dev = (torch.from_numpy(self._apage).to(self.device),
                             torch.from_numpy(self._ascale).to(self.device))
        return (self.adapters.pools, *self._adp_dev)

    def _forward(self, tokens, pos, page_table, q_len, is_decode,
                 group=None, lora=None):
        return unified_forward(self.model, self._pools, tokens, pos,
                               page_table, q_len, is_decode,
                               self._last_logits, group, self.attn_impl,
                               lora, self.megakernel)

    def _verify(self, tokens, pos, page_table, q_len, is_decode, head,
                group=None, lora=None, vbias=None):
        return verify_forward(self.model, self._pools, tokens, pos,
                              page_table, q_len, is_decode,
                              self._last_logits, head, group, self.attn_impl,
                              lora, self.megakernel, vbias)

    def _sample_next(self) -> torch.Tensor:
        """Every slot's next token from its held logits: argmax when all
        residents decode greedily, else per-slot sampling. Under the
        megakernel the argmax is K12 (`decode_greedy_argmax`), one launch
        a step, handed to the sampler for its greedy rows. The step's
        grammar bias `_gsamp`, (rows [k] int64, bias [k, V] f32) or None,
        is added to those rows of a copy of the held logits before
        anything samples."""
        temps, topk, topp, greedy = self._sampling_vectors()
        logits = self._last_logits
        gsamp = self._gsamp
        if gsamp is not None:
            logits = logits.clone()
            logits[gsamp[0]] += gsamp[1]
        g = decode_greedy_argmax(logits) if self.megakernel else None
        if self._all_greedy:
            return torch.argmax(logits, dim=-1) if g is None else g.long()
        return _sample_rows(logits, self._generator, temps, topk, topp,
                            greedy, argmax=g)

    def _emit_tokens(self, slots, nxt: np.ndarray,
                     finished: List[RequestOutput], accept=None,
                     drafts: Optional[Dict[int, np.ndarray]] = None):
        """Emit slot s's sampled token nxt[s] for every slot of `slots`
        still in DECODE, and retire the rows that hit EOS or their
        budget. With speculation, `accept` [S] and `drafts` (slot -> the
        drafts its verify row carried): each slot emits its burst, the
        sampled token then its accepted drafts, token by token, so EOS
        or max_new_tokens ends the burst where one-at-a-time decoding
        would; the step gap is spread over the burst's tokens, and the
        drafted and accepted counts go to the request and
        `metrics.on_spec`."""
        running = self.scheduler.running
        now = self._clock()
        drafted = accepted = 0
        bursts: List[int] = []
        for slot in slots:
            req = running.get(slot)
            if req is None or req.state is not RequestState.DECODE:
                continue
            burst = [int(nxt[slot])]
            m = 0 if drafts is None else len(drafts.get(slot, ()))
            if m:
                acc = min(int(accept[slot]), m)
                burst.extend(int(t) for t in drafts[slot][:acc])
            prev_t = req._last_token_t
            sp = req.sampling
            gram = self._grammars.get(req.request_id)
            emitted, reason = 0, None
            for tok in burst:
                req._emit(tok, now)
                emitted += 1
                self.metrics.on_token(req, now)
                if sp.eos_token_id is not None and tok == sp.eos_token_id:
                    reason = "stop"
                    break
                if gram is not None:
                    # the automaton commits along the burst (EOS ended it
                    # above: a terminator, never a grammar character)
                    gram.advance(tok)
                if len(req.output_tokens) >= sp.max_new_tokens:
                    reason = "length"
                    break
            if prev_t is not None:
                dt = (now - prev_t) / emitted
                for _ in range(emitted):
                    self.metrics.on_inter_token(
                        dt, priority=sp.priority, adapter_id=sp.adapter_id,
                        now=now)
            else:
                self._obs_event(req, "first_token")
            if m:
                drafted += m
                accepted += emitted - 1
                req.accepted_draft_tokens += emitted - 1
            bursts.append(emitted)
            if reason is not None:
                self._finish_and_free(req, reason, now, finished)
        if accept is not None and bursts:
            self.metrics.on_spec(drafted, accepted, bursts)
            self._round_stats["accepted_tokens"] += accepted

    # -- speculative decoding ----------------------------------------------
    @staticmethod
    def _history(req: Request) -> np.ndarray:
        """A request's committed stream: prompt + emitted tokens."""
        return np.concatenate([req.prompt_ids.astype(np.int64),
                               np.asarray(req.output_tokens, np.int64)])

    def _propose_drafts(self, running, suppress=frozenset()
                        ) -> Dict[int, np.ndarray]:
        """Ask each greedy DECODE slot's drafter for up to
        min(k, chunk_len - 1, max_new - emitted - 1) drafts over its
        committed history. The cap keeps every transient K/V write in
        the request's own pages: the deepest draft lands at position
        prompt + max_new - 1, the last one admission reserved. The
        model tier's rows draft together (`_propose_model_rows`).
        Slots in `suppress` do not draft. Returns {slot: proposed token
        ids}."""
        proposals: Dict[int, np.ndarray] = {}
        model_rows: Dict[int, tuple] = {}
        for slot, req in sorted(running.items()):
            if (req.state is not RequestState.DECODE or slot in suppress
                    or not req.sampling.greedy):
                continue
            drafter = self._drafters.get(req.request_id)
            if drafter is None:
                continue
            budget = req.sampling.max_new_tokens - len(req.output_tokens) - 1
            cap = min(self.spec.k, self.chunk_len - 1, budget)
            if cap <= 0:
                continue
            if isinstance(drafter, ModelDrafter):
                model_rows[slot] = (req, cap)
                continue
            hist = self._history(req)
            try:
                prop = np.asarray(drafter.propose(hist, cap, budget=budget))
            except TypeError:
                # a drafter without the optional budget: the engine's cap
                # still bounds the grant
                prop = np.asarray(drafter.propose(hist, cap))
            prop = prop.reshape(-1)
            if prop.size:
                proposals[slot] = prop[:cap].astype(np.int64)
        if model_rows:
            proposals.update(self._propose_model_rows(model_rows))
        return proposals

    def _propose_model_rows(self, rows) -> Dict[int, np.ndarray]:
        """Model-tier drafting, every drafting slot in one batched
        `propose_batch`. Per slot: clamp the draft position to the
        committed stream (the rollback of the last step's rejected
        drafts), take this step's t0 on the host, `np.argmax` over the
        held f32 logits (the device's greedy pick: K12 equals
        torch.argmax, and both take the first of equal values), and feed
        the catch-up `committed[dpos:] + [t0]`. Slots lagging more than
        a chunk wait for `_draft_seed_step`; a slot whose t0 is EOS
        finishes this step and does not draft. A constrained slot's t0 is
        the argmax of its grammar-biased held logits (the same f32 add
        the device's sample makes)."""
        d = self._draft
        proposals: Dict[int, np.ndarray] = {}
        if d is None:
            return proposals
        held = None
        entries: Dict[int, tuple] = {}
        for slot, (req, cap) in sorted(rows.items()):
            if not d.resident(slot) and not d.admit(
                    slot, int(req.prompt_ids.size),
                    self._budget_new(req.sampling)):
                continue            # draft-pool pressure: retry later
            hist = self._history(req)
            dpos = d.committed(slot, int(hist.size))
            if (hist.size - dpos) + 1 > self.chunk_len:
                continue            # too cold: seeding catches it up
            if held is None:
                held = self._last_logits.cpu().numpy()
            eos = req.sampling.eos_token_id
            g = self._grammars.get(req.request_id)
            if g is None:
                t0 = int(np.argmax(held[slot]))
            else:       # the grammar-biased pick, the device's bit for bit
                left = req.sampling.max_new_tokens - len(req.output_tokens)
                t0 = int(np.argmax(held[slot] + self._grammar_bias(
                    g, left, eos, held.shape[-1])))
            if eos is not None and t0 == eos:
                continue            # the row finishes this step
            entries[slot] = (np.concatenate([hist[dpos:], [t0]]), cap)
        for slot, p in d.propose_batch(entries).items():
            p = np.asarray(p, np.int64).reshape(-1)[:entries[slot][1]]
            if p.size:
                proposals[slot] = p
        return proposals

    def _draft_seed_step(self, running, suppress, decode_slots, grants,
                         draft_grants, proposals):
        """Warm lagging slots' draft K/V from the step's spare token
        budget (what decode, prefill and drafts left:
        `Scheduler.pack_draft_seed`), every seeding slot in one ragged
        draft forward. PREFILL rows seed from `prefill_ids` (a resumed
        request's banked history is its tail), DECODE rows from prompt +
        emitted. Slots that drafted this step are skipped (their draft
        position is ahead of the committed stream, not behind it), and so
        are slots in `suppress`."""
        d = self._draft
        spare = (self.token_budget - len(decode_slots)
                 - sum(grants.values()) - sum(draft_grants.values()))
        if spare <= 0:
            return
        wanted: Dict[int, int] = {}
        src: Dict[int, np.ndarray] = {}
        for slot, req in sorted(running.items()):
            if slot in suppress or slot in proposals or not isinstance(
                    self._drafters.get(req.request_id), ModelDrafter):
                continue
            if req.state is RequestState.PREFILL:
                committed = np.asarray(req.prefill_ids, np.int64)
            elif req.state is RequestState.DECODE:
                committed = self._history(req)
            else:
                continue
            if not d.resident(slot) and not d.admit(
                    slot, int(req.prompt_ids.size),
                    self._budget_new(req.sampling)):
                continue            # draft-pool pressure
            dpos = d.committed(slot, int(committed.size))
            lag = int(committed.size) - dpos
            if lag <= 1:
                continue    # the catch-up of `propose_batch` absorbs it
            wanted[slot] = lag
            src[slot] = committed[dpos:]
        if not wanted:
            return
        seeds = self.scheduler.pack_draft_seed(spare, self.chunk_len, wanted)
        entries = {slot: src[slot][:take] for slot, take in seeds.items()
                   if take > 0}
        d.seed(entries)
        self._round_stats["draft_seed_tokens"] += sum(
            int(v.size) for v in entries.values())

    # -- grammar-constrained decoding --------------------------------------
    @staticmethod
    def _grammar_bias(g, left, eos, V) -> np.ndarray:
        """One [V] f32 bias row from an automaton's state: 0.0 where the
        grammar allows a token, NEG_BIAS where it forbids one. Budget-
        aware: with `left` emissions to go, one is kept for EOS, so the
        tokens are those from which acceptance stays reachable within
        left - 1 (the automaton falls back to its whole allow-set when
        acceptance is out of reach). EOS is allowed iff the automaton
        accepts, and is the only token left when the grammar allows
        nothing else: a complete, budget-spent stream ends."""
        allow = g.budget_allowed(max(0, left - 1))
        bias = np.where(allow, np.float32(0.0),
                        np.float32(NEG_BIAS)).astype(np.float32)
        if eos is not None and 0 <= eos < V:
            bias[eos] = 0.0 if g.accepting() else NEG_BIAS
        if not (bias == 0.0).any():
            if eos is not None and 0 <= eos < V:
                bias[eos] = 0.0
            else:           # unreachable: SamplingParams requires EOS
                bias[:] = 0.0
        return bias

    def _grammar_operands(self, running, decode_slots, draft_grants,
                          proposals, head) -> tuple:
        """The step's grammar biases, as device operands: (rows, bias
        [k, V]) for the sample, one row a constrained decode slot, and,
        with drafts, (head entries, bias) for the verify columns — a fork
        of the row's automaton walks [t0, drafts...] and each column gets
        the bias of the state it verifies from (t0 is the biased argmax
        of the held logits, recomputed on the host: the device's pick
        bit for bit). A draft the grammar forbids is counted rejected:
        its column's biased argmax cannot match it, and the columns past
        it stay unbiased (the acceptance already stops there). Either is
        None when no row needs it; the counts go to the round stats and
        `metrics.on_grammar_step`."""
        V = int(self._last_logits.shape[-1])
        rows, biases, ver_idx, ver_bias = [], [], [], []
        ll_host = None
        n_rej = 0
        for slot in decode_slots:
            req = running.get(slot)
            g = None if req is None else self._grammars.get(req.request_id)
            if g is None:
                continue
            sp = req.sampling
            eos = sp.eos_token_id
            left = sp.max_new_tokens - len(req.output_tokens)
            bias0 = self._grammar_bias(g, left, eos, V)
            rows.append(slot)
            biases.append(bias0)
            m = draft_grants.get(slot, 0)
            if not m:
                continue
            if ll_host is None:
                ll_host = self._last_logits.cpu().numpy()
            t0 = int(np.argmax(ll_host[slot] + bias0))
            walk = g.fork()
            alive = eos is None or t0 != eos
            if alive:
                walk.advance(t0)
            first = int(head[2 * ((head.size - self.num_slots) // 2)
                             + slot])
            for j in range(m):
                if not alive:
                    break
                bias_j = self._grammar_bias(walk, left - 1 - j, eos, V)
                ver_idx.append(first + j)
                ver_bias.append(bias_j)
                p = int(proposals[slot][j])
                if eos is not None and p == eos:
                    alive = False
                elif bias_j[p] < 0.0:
                    n_rej += 1
                    alive = False
                else:
                    walk.advance(p)
        rs = self._round_stats
        rs["constrained_rows"] += len(rows)
        rs["grammar_rejected"] += n_rej
        if rows:
            self.metrics.on_grammar_step(len(rows), n_rej)
        dev = self.device
        up = lambda idx, b: (torch.tensor(idx, dtype=torch.int64,
                                          device=dev),
                             torch.from_numpy(np.stack(b)).to(dev))
        self.grammar_bias_bytes = 4 * V * (len(rows) + len(ver_idx))
        return (up(rows, biases) if rows else None,
                up(ver_idx, ver_bias) if ver_idx else None)

    # -- the embeddings lane -----------------------------------------------
    def _embed_rows(self, rows):
        """Pooled last-hidden-state embeddings for the embed rows
        [(slot, req)] at the end of their prompts, one batched epilogue
        (`embed_forward`) over their still-attached pages; each request
        keeps its f32 vector. The epilogue writes its recomputed K/V into
        the page of position plen - 1 (a private page: a prefix match
        always leaves the prompt's last token to prefill), so that page
        of every pool is saved first and restored after: the pool's
        bytes are those the prefill wrote."""
        dev = self.device
        slots = [slot for slot, _ in rows]
        plens = [int(req.prefill_ids.size) for _, req in rows]
        tok = torch.tensor([[int(req.prefill_ids[-1])] for _, req in rows],
                           dtype=torch.int64, device=dev)
        pos = torch.tensor([n - 1 for n in plens], dtype=torch.int32,
                           device=dev)
        table = torch.from_numpy(self._pt_host[slots]).to(dev)
        written = torch.tensor(
            [int(self._pt_host[slot, (n - 1) // self.page_size])
             for slot, n in zip(slots, plens)], dtype=torch.int64,
            device=dev)
        with RecordEvent("serving::embed_epilogue"):
            saved = [[(k.index_select(0, written), v.index_select(0, written))
                      for k, v in plane] for plane in self._planes]
            h = embed_forward(self.model, self._pools, tok, pos, table,
                              self.attn_impl)
            for plane, copies in zip(self._planes, saved):
                for (k, v), (k0, v0) in zip(plane, copies):
                    k.index_copy_(0, written, k0)
                    v.index_copy_(0, written, v0)
            h = h.cpu().numpy()
        for (slot, req), row in zip(rows, h):
            req.embedding = row.copy()
            self._obs_event(req, "embed", hidden=int(h.shape[-1]))

    @staticmethod
    def _head_columns(q_len: np.ndarray, is_decode: np.ndarray
                      ) -> np.ndarray:
        """The columns a speculative step's LM head reads, as one int64
        array [rows (n), cols (n), first (S)]: each decode row's q_len
        live columns, each prefill row's last; `first[s]` is row s's
        first entry (0 for a dead row)."""
        rows: List[int] = []
        cols: List[int] = []
        first = np.zeros((q_len.size,), np.int64)
        for s in np.nonzero(q_len)[0]:
            n = int(q_len[s])
            first[s] = len(rows)
            if is_decode[s]:
                rows.extend([int(s)] * n)
                cols.extend(range(n))
            else:
                rows.append(int(s))
                cols.append(n - 1)
        return np.concatenate([np.asarray(rows, np.int64),
                               np.asarray(cols, np.int64), first])

    @torch.no_grad()
    def _unified_step(self, finished: List[RequestOutput],
                      suppress=frozenset()):
        """One unified step (see the module doc). Slots in `suppress`
        ride at q_len 0 with no drafts (quarantine probes): their
        positions, cursors, held logits and pages stay as they were."""
        running = self.scheduler.running
        if not running:
            return
        W = self.chunk_len
        remaining = {
            slot: int(req.prefill_ids.size)
            - self._prefill_cursor[req.request_id]
            for slot, req in running.items()
            if req.state is RequestState.PREFILL and slot not in suppress}
        proposals: Dict[int, np.ndarray] = {}
        draft_grants: Dict[int, int] = {}
        if self.spec is None:
            decode_slots, grants = self.scheduler.pack_tokens(
                self.token_budget, W, remaining)
        else:
            proposals = self._propose_drafts(running, suppress)
            decode_slots, grants, draft_grants = self.scheduler.pack_tokens(
                self.token_budget, W, remaining,
                draft_wanted={s: int(p.size) for s, p in proposals.items()})
        if suppress:
            decode_slots = [s for s in decode_slots if s not in suppress]
            draft_grants = {s: n for s, n in draft_grants.items()
                            if s not in suppress}
        if not decode_slots and not grants:
            return
        if self.step_fault_hook is not None:
            self.step_fault_hook(
                [running[s].request_id for s in decode_slots]
                + [running[s].request_id for s in sorted(grants)])
        if self._draft is not None:
            # the draft cache's warming rides the leftover budget, a draft
            # forward of its own before the target step
            self._draft_seed_step(running, suppress, decode_slots, grants,
                                  draft_grants, proposals)
        tokens = np.zeros((self.num_slots, W), np.int64)
        q_len = np.zeros((self.num_slots,), np.int32)
        is_decode = np.zeros((self.num_slots,), bool)
        q_len[decode_slots] = 1
        is_decode[decode_slots] = True
        for slot, m in draft_grants.items():
            tokens[slot, 1:1 + m] = proposals[slot][:m]
            q_len[slot] = 1 + m
        for slot, take in grants.items():
            req = running[slot]
            cur = self._prefill_cursor[req.request_id]
            tokens[slot, :take] = req.prefill_ids[cur:cur + take]
            q_len[slot] = take
        # prefix-sharing groups of this step's walk, and the page-block
        # reads both walks would issue (per kv head and layer)
        # the fused-byte model's inputs (the census's page-walk record):
        # the pools' element widths and the adapter rows' stream bytes
        kv_elt = (1 if self.kv_dtype in ("int8", "fp8")
                  else self.model.dtype.itemsize)
        lora_rows = (int(np.count_nonzero(self._apage[q_len > 0]))
                     if self.adapters is not None else 0)
        fused = dict(head_dim=self.head_dim, kv_elt=kv_elt,
                     scale_elt=4 if self.kv_dtype == "int8" else 0,
                     lora_bytes=lora_rows * self._adapter_row_bytes)
        groups = None
        if self.grouped:
            groups = shared_prefix_groups(self._pt_host, q_len)
            flat, reads, sizes, walk = count_page_block_reads(
                self._pt_host, self._pos, q_len, groups[0], groups[2],
                page_size=self.page_size, fused=fused)
        else:
            flat, reads, sizes, walk = count_page_block_reads(
                self._pt_host, self._pos, q_len, page_size=self.page_size,
                fused=fused)
        self.metrics.on_grouped_step(flat, reads, sizes)
        self._last_walk_bytes = {
            "unfused": int(walk["unfused"]) * self.n_layers,
            "fused": int(walk["fused"]) * self.n_layers,
            "tokens": int(q_len.sum())}
        self._round_stats["reads_saved"] += int(flat) - int(reads)
        self._sampling_vectors()     # host-to-device rebuilds, untimed
        lora = self._adapter_operands()
        head = (None if self.spec is None
                else self._head_columns(q_len, is_decode))
        self.step_tokens_inflight = int(q_len.sum())
        self._beat()
        t0 = time.perf_counter()
        self._gsamp = gver = None
        if self.grammar_on:
            self._gsamp, gver = self._grammar_operands(
                running, decode_slots, draft_grants, proposals, head)
        with RecordEvent("serving::unified_step"):
            dev = self.device
            isd = torch.from_numpy(is_decode).to(dev)
            ql = torch.from_numpy(q_len).to(dev)
            group = (None if groups is None else
                     torch.from_numpy(np.stack(groups)).to(dev).unbind(0))
            nxt = self._sample_next()
            toks = torch.from_numpy(tokens).to(dev)
            toks[:, 0] = torch.where(isd, nxt, toks[:, 0])
            pos = torch.from_numpy(self._pos).to(dev)
            if head is None:
                self._last_logits = self._forward(
                    toks, pos, self._page_table(), ql, isd, group, lora)
                nxt = nxt.cpu().numpy()      # sync: the host sees the tokens
            else:
                n = (head.size - self.num_slots) // 2
                idx = torch.from_numpy(head).to(dev)
                self._last_logits, accept = self._verify(
                    toks, pos, self._page_table(), ql, isd,
                    (idx[:n], idx[n:2 * n], idx[2 * n:]), group, lora,
                    gver)
                # one sync brings the sampled tokens and the acceptance
                nxt, accept = torch.stack(
                    (nxt.to(torch.int64), accept.to(torch.int64))
                ).cpu().numpy()
        wall = time.perf_counter() - t0
        self.step_tokens_inflight = 0
        self._beat()
        if head is None:
            self._pos += q_len
        else:
            self._pos += np.where(is_decode, 1 + accept, q_len).astype(
                np.int32)
        n_prefill = int(sum(grants.values()))
        n_drafts = int(sum(draft_grants.values()))
        self.metrics.on_unified_step(n_prefill, len(decode_slots), wall,
                                     draft_tokens=n_drafts)
        rs = self._round_stats
        rs["prefill_tokens"] += n_prefill
        rs["decode_tokens"] += len(decode_slots)
        rs["draft_tokens"] += n_drafts
        rs["wall_s"] += wall
        embed_rows = []
        for slot, take in grants.items():
            req = running[slot]
            cur = self._prefill_cursor[req.request_id] + take
            self._prefill_cursor[req.request_id] = cur
            self.metrics.on_prefill_chunk(take)
            self._obs_event(req, "prefill_chunk", tokens=take, cursor=cur)
            if cur >= req.prefill_ids.size:
                self._prefill_cursor.pop(req.request_id, None)
                if req.sampling.embed:
                    # prefill only: the embedding, then retirement
                    embed_rows.append((slot, req))
                    continue
                # the last prefilled token's logits are held: the row
                # samples its next token next step
                req.state = RequestState.DECODE
                self._obs_event(req, "decode")
        if embed_rows:
            # before retirement: the epilogue reads the rows' pages, which
            # `_finish_and_free` then hands to the prefix cache
            self._embed_rows(embed_rows)
            now = self._clock()
            for slot, req in embed_rows:
                self._finish_and_free(req, "stop", now, finished)
        if head is None:
            self._emit_tokens(decode_slots, nxt, finished)
        else:
            self._emit_tokens(decode_slots, nxt, finished, accept,
                              {s: proposals[s][:m]
                               for s, m in draft_grants.items()})

    # -- the legacy alternating step -----------------------------------------
    def _prefill_forward(self, tokens, pos, page_table, last):
        """One prefill chunk's forward (batch 1): its held-logits row."""
        return legacy_forward(self.model, self._pools, tokens, pos,
                              page_table, last, self.attn_impl)

    def _decode_forward(self, tokens, pos, page_table):
        """The decode step's forward over every slot: new logits [S, V]."""
        return legacy_forward(self.model, self._pools, tokens, pos,
                              page_table, torch.zeros_like(pos,
                                                           dtype=torch.int64),
                              self.attn_impl)

    @torch.no_grad()
    def _prefill_chunk(self, slot: int, req: Request):
        """One batch-1 chunk of `req`'s prompt from its cursor, padded to
        its `chunk_bucket`: the K/V of its tokens go into the slot's
        pages, the logits of its last real token into the slot's held
        row, and the slot's position to cursor + real."""
        plen = int(req.prefill_ids.size)
        cursor = self._prefill_cursor[req.request_id]
        bucket = chunk_bucket(plen - cursor, self.chunk_len, self.MIN_CHUNK)
        real = min(plen - cursor, bucket)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :real] = req.prefill_ids[cursor:cursor + real]
        self.prefill_buckets.add(bucket)
        dev = self.device
        self.step_tokens_inflight = int(bucket)
        self._beat()
        t0 = time.perf_counter()
        with RecordEvent(f"serving::prefill[{req.request_id}"
                         f"@{cursor}+{bucket}]"):
            row = self._prefill_forward(
                torch.from_numpy(tokens).to(dev),
                torch.tensor([cursor], dtype=torch.int32, device=dev),
                self._page_table()[slot:slot + 1],
                torch.tensor([real - 1], device=dev))
            self._last_logits[slot] = row[0]
        wall = time.perf_counter() - t0
        self.step_tokens_inflight = 0
        self._beat()
        self._pos[slot] = cursor + real
        self._prefill_cursor[req.request_id] = cursor + real
        self.metrics.on_prefill_chunk(real, wall_s=wall)
        self._round_stats["prefill_tokens"] += real
        self._obs_event(req, "prefill_chunk", tokens=real,
                        cursor=cursor + real)

    def _advance_prefills(self, suppress=frozenset()) -> int:
        """One chunk for EACH mid-prefill slot not in `suppress`, in slot
        order, each after the fault hook with its request; a slot whose
        prompt is done turns to DECODE. Returns the chunks run."""
        chunks = 0
        for slot, req in sorted(self.scheduler.running.items()):
            if req.state is not RequestState.PREFILL or slot in suppress:
                continue
            if self.step_fault_hook is not None:
                self.step_fault_hook([req.request_id])
            self._prefill_chunk(slot, req)
            chunks += 1
            if self._prefill_cursor[req.request_id] >= req.prefill_ids.size:
                self._prefill_cursor.pop(req.request_id, None)
                req.state = RequestState.DECODE
                self._obs_event(req, "decode")
        return chunks

    @torch.no_grad()
    def _decode(self, finished: List[RequestOutput], suppress=frozenset()):
        """The fixed-shape decode step over every slot: sample each
        slot's token from its held logits (token 0 for rows not in
        DECODE), forward all slots one position through a page table
        that points every non-DECODE row at the trash page, keep the new
        logits of DECODE rows and advance only their positions. Slots in
        `suppress` are inactive for this call (quarantine probes): their
        writes go to the trash page and their held logits and positions
        stay."""
        running = self.scheduler.running
        active = np.zeros((self.num_slots,), bool)
        for slot, req in running.items():
            active[slot] = (req.state is RequestState.DECODE
                            and slot not in suppress)
        if not active.any():
            return
        if self.step_fault_hook is not None:
            self.step_fault_hook([r.request_id for s, r in sorted(
                running.items()) if active[s]])
        dev = self.device
        self._sampling_vectors()     # host-to-device rebuild, untimed
        self.step_tokens_inflight = int(active.sum())
        self._beat()
        t0 = time.perf_counter()
        with RecordEvent("serving::decode_step"):
            act = torch.from_numpy(active).to(dev)
            table = torch.from_numpy(np.where(
                active[:, None], self._pt_host, TRASH_PAGE).astype(
                    np.int32)).to(dev)
            nxt = torch.where(act, self._sample_next(), 0)
            new = self._decode_forward(
                nxt[:, None], torch.from_numpy(self._pos).to(dev), table)
            self._last_logits = torch.where(act[:, None], new,
                                            self._last_logits)
            nxt = nxt.cpu().numpy()      # sync: the host sees the tokens
        wall = time.perf_counter() - t0
        self.step_tokens_inflight = 0
        self._beat()
        self._pos += active.astype(np.int32)
        self.metrics.on_decode_step(wall)
        self._round_stats["decode_tokens"] += int(active.sum())
        self._round_stats["wall_s"] += wall
        self._emit_tokens(np.nonzero(active)[0], nxt, finished)

    def _run_round(self, finished: List[RequestOutput],
                   suppress=frozenset()) -> int:
        """One round's model work: the unified step, or the legacy
        prefill chunks then the decode step, with the slots in
        `suppress` idle (positions, held logits and prefill cursors
        untouched): `_quarantine_poison`'s probes. Returns the prefill
        chunks run ahead of the decode (legacy only)."""
        if self.unified:
            self._unified_step(finished, suppress)
            return 0
        chunks = self._advance_prefills(suppress)
        self._decode(finished, suppress)
        return chunks

    def _quarantine_poison(self, finished: List[RequestOutput]) -> bool:
        """A round raised: find the one resident request that
        deterministically kills the step, fail it alone (finish reason
        "poisoned", `PoisonedRequest`) and keep serving everyone else.
        Group-testing bisection over the resident slots: each probe
        re-runs the round with half the candidates suppressed; a probe
        that raises exonerates the suppressed half, one that succeeds
        convicts it (and the innocents it ran made progress). The
        verdict is checked (a round without the suspect must succeed);
        an empty batch or a fault that tracks no single request returns
        False, and the original exception propagates. A CUDA error in a
        probe propagates at once. Assumes deterministic faults, the
        shape `FaultInjector.poison` injects."""
        candidates = sorted(self.scheduler.running)
        if not candidates:
            return False
        while len(candidates) > 1:
            half = frozenset(candidates[:len(candidates) // 2])
            try:
                self._run_round(finished, suppress=half)
            except Exception as exc:
                if _device_fault(exc):
                    raise
                survivors = [s for s in candidates if s not in half]
            else:
                survivors = list(half)
            candidates = [s for s in survivors
                          if s in self.scheduler.running]
            if not candidates:
                return False
        slot = candidates[0]
        req = self.scheduler.running.get(slot)
        if req is None:
            return False
        try:     # the verdict: the round must succeed without it
            self._run_round(finished, suppress=frozenset([slot]))
        except Exception as exc:
            if _device_fault(exc):
                raise
            return False
        req.error = PoisonedRequest(
            f"request {req.request_id} deterministically kills the "
            "serving step; quarantined")
        self._finish_and_free(req, "poisoned", self._clock(), finished)
        return True

    def step(self) -> List[RequestOutput]:
        """One scheduler round: evict (timeout / cancel / expired
        placement deadline), admit queued requests whose pages fit,
        preempt for a strictly more important blocked head, then run the
        round's model work (`_run_round`). A round that raises freezes
        the flight ring and goes through poison quarantine: if exactly
        one resident deterministically kills the step, it alone fails
        and the engine keeps serving; otherwise (or on a CUDA error) the
        exception propagates as replica death. Then the metrics, the
        census (once) and the flight record. Returns the requests that
        finished this round."""
        finished: List[RequestOutput] = []
        self._beat()
        self._step_idx += 1
        self._round_stats = self._new_round_stats()
        now = self._clock()
        self._evict(now, finished)
        self._admit(now)
        self._preempt_for_overload(now)
        chunks = 0
        try:
            chunks = self._run_round(finished)
        except Exception as exc:
            # the ring freezes before recovery runs: whatever quarantine
            # decides, the postmortem keeps the steps that led here
            self._incident("step_fault", repr(exc))
            if _device_fault(exc) or not self._quarantine_poison(finished):
                self._incident("replica_death", repr(exc))
                raise
            self._incident("poison_quarantine", repr(exc))
        self.metrics.on_step(self.scheduler.queue_depth,
                             self.scheduler.occupancy, self.num_slots,
                             pages_used=self.pool.used_pages,
                             pages_total=self.num_pages - 1,
                             stall_chunks=chunks,
                             pages_cached=self.pool.cached_pages,
                             pages_swapped=self.pool.swapped_pages,
                             host_pages_used=self.host_pool.used_pages,
                             host_pages_total=self.host_pages,
                             draft_pages_used=(
                                 0 if self._draft is None
                                 else self._draft.pool.used_pages),
                             draft_pages_total=(
                                 0 if self._draft is None
                                 else self._draft.num_pages - 1),
                             prefix_stats=(None if self.prefix_cache is None
                                           else self.prefix_cache.stats()),
                             adapter_stats=(None if self.adapters is None
                                            else self.adapters.stats()))
        # the analytical census is taken right after the first round (the
        # counted sources wait for the first `cost_census()` read)
        if self._census is None and self.census_mode == "model":
            self.cost_census()
        if self.obs is not None:
            self.obs.flight.on_step(self._flight_record())
        return finished

    def _flight_record(self) -> dict:
        """This step's flight record, the JAX engine's keys, from host
        values the step already holds (no device read)."""
        rs = self._round_stats
        running = self.scheduler.running
        packed = (rs["prefill_tokens"] + rs["decode_tokens"]
                  + rs["draft_tokens"])
        rec = {
            "step": self._step_idx, "t": self._clock(),
            "queue_depth": self.scheduler.queue_depth,
            "residents": len(running),
            "slots": [[s, r.request_id, r.state.name]
                      for s, r in sorted(running.items())],
            "prefill_tokens": rs["prefill_tokens"],
            "decode_tokens": rs["decode_tokens"],
            "draft_tokens": rs["draft_tokens"],
            "accepted_tokens": rs["accepted_tokens"],
            # packed tokens over the step's capacity (the census's
            # live numerator)
            "achieved_util": round(packed / self.step_capacity_tokens, 4)}
        if self.slo is not None:
            rec["slo"] = self.slo.worst_state()
        rec["reads_saved"] = rs["reads_saved"]
        if self.grammar_on:
            # constrained rows and grammar-rejected drafts this step
            rec["constrained_rows"] = rs["constrained_rows"]
            rec["grammar_rejected"] = rs["grammar_rejected"]
        rec.update({
            "pages_used": self.pool.used_pages,
            "pages_total": self.num_pages - 1,
            "pages_cached": self.pool.cached_pages,
            "pages_swapped": self.pool.swapped_pages,
            "host_pages_used": self.host_pool.used_pages})
        if self._draft is not None:
            rec.update({"draft_pages_used": self._draft.pool.used_pages,
                        "draft_pages_total": self._draft.num_pages - 1,
                        "draft_seed_tokens": rs["draft_seed_tokens"]})
        rec["collectives"] = 0          # one device: no mesh collectives
        rec["step_wall_ms"] = round(rs["wall_s"] * 1e3, 4)
        if self.adapters is not None:
            rec["slot_adapters"] = sorted(
                [s, int(r.sampling.adapter_id)] for s, r in running.items()
                if r.sampling.adapter_id != BASE_ADAPTER)
            rec["adapters_resident"] = (self.adapters.pool.used_pages
                                        + self.adapters.pool.cached_pages)
        return rec

    # -- shutdown ----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def drain(self) -> List[RequestOutput]:
        """Graceful shutdown: stop admitting (add_request raises
        EngineClosed), abort still-queued requests that never started
        (reason "aborted"), but let PREEMPTED ones resume and finish,
        then run until idle and check that every page is free or
        cache-resident with nothing stranded in the host tier.
        Idempotent."""
        self._closed = True
        finished: List[RequestOutput] = []
        now = self._clock()
        resume: List[Request] = []
        for req in self.scheduler.pop_queued():
            if req.state is RequestState.PREEMPTED:
                resume.append(req)
            else:
                self._finish_and_free(req, "aborted", now, finished)
        for req in resume:
            self.scheduler.requeue(req)
        finished.extend(self.run())
        self._assert_quiesced()
        return finished

    def abort_all(self, reason: str = "aborted") -> List[RequestOutput]:
        """Forced shutdown: close the engine and retire every request,
        queued, preempted and resident, now with `reason`, freeing its
        pages and host-tier pages, without another step. Residents keep
        the tokens they already emitted (a caller may pass
        "replica_failure" to tell which are safe to retry)."""
        self._closed = True
        finished: List[RequestOutput] = []
        now = self._clock()
        try:
            for req in self.scheduler.pop_queued():
                self._finish_and_free(req, reason, now, finished)
            for slot in sorted(self.scheduler.running):
                self._finish_and_free(self.scheduler.running[slot], reason,
                                      now, finished)
        finally:
            # a teardown that raises midway (a torn pool after a mid-step
            # fault) still closes every request's span
            for span in self._spans.values():
                span.end()
            self._spans.clear()
        self._assert_quiesced()
        return finished

    def _assert_quiesced(self):
        """Every page pool the engine owns is free or cache-resident:
        the KV pool, the adapter pool and the draft pool."""
        self.pool.assert_quiesced()
        if self.adapters is not None:
            self.adapters.assert_quiesced()
        if self._draft is not None:
            self._draft.assert_quiesced()

    # -- debug introspection -------------------------------------------------
    def debug_state(self) -> dict:
        """Host-side live state, with the JAX engine's keys: residents,
        the queue's summary, the pools, the prefix cache's and the
        adapters' stats, the engine's A/B flags, the obs layer's stats,
        the SLO snapshot and the cost census (whose first read captures
        a counted census). Reads of host state, never of the device.
        Features the port has not ported read as the JAX engine reads
        them with their gates off (no mesh: mp = dp = 1)."""
        sched = self.scheduler
        residents = []
        for slot, req in sorted(sched.running.items()):
            residents.append({
                "slot": slot, "request_id": req.request_id,
                "state": req.state.name,
                "prompt_len": int(req.prompt_ids.size),
                "emitted": len(req.output_tokens),
                "pages": len(self._slot_pages.get(slot) or ()),
                "cached_tokens": int(req.cached_tokens),
                "priority": int(req.sampling.priority),
                "adapter_id": int(req.sampling.adapter_id)})
        return {
            "closed": self._closed,
            "step": self._step_idx,
            "num_slots": self.num_slots,
            "residents": residents,
            "queue": sched.queue_summary(),
            "pool": {"pages_total": self.num_pages - 1,
                     "pages_used": self.pool.used_pages,
                     "pages_cached": self.pool.cached_pages,
                     "pages_swapped": self.pool.swapped_pages,
                     "pages_free": self.pool.free_pages,
                     "bytes_per_page": self.page_bytes},
            "host_pool": {"pages_used": self.host_pool.used_pages,
                          "pages_total": self.host_pages},
            "draft_pool": (None if self._draft is None
                           else self._draft.stats()),
            "prefix_cache": (None if self.prefix_cache is None
                             else self.prefix_cache.stats()),
            "adapters": (None if self.adapters is None else {
                "pool": self.adapters.stats(),
                "registered": self.adapters.debug()}),
            "config": {"unified": self.unified,
                       "grouped": self.grouped,
                       "attn_impl": self.attn_impl,
                       "kv_dtype": self.kv_dtype,
                       "mesh": None, "mp": 1, "dp": 1,
                       "preempt": self.preempt,
                       "spec": (None if self.spec is None
                                else self.spec.mode),
                       "spec_draft_model": self._draft is not None,
                       "grammar": self.grammar_on,
                       "num_pages": self.num_pages,
                       "page_size": self.page_size,
                       "chunk_len": self.chunk_len,
                       "max_len": self.max_len,
                       "token_budget": self.token_budget},
            "obs": None if self.obs is None else self.obs.stats(),
            "slo": self._slo_snap(),
            "cost_census": self.cost_census(),
        }

    # -- conveniences ------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def run(self, max_steps: Optional[int] = None) -> List[RequestOutput]:
        """Pump steps until idle (or max_steps); returns everything that
        finished along the way."""
        out: List[RequestOutput] = []
        steps = 0
        while self.has_work:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    def generate(self, prompts: Sequence, sampling=None
                 ) -> List[RequestOutput]:
        """Blocking batch API: submit all prompts, run to completion,
        return outputs in submission order."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        elif len(sampling) != len(prompts):
            raise ValueError(
                f"sampling list length {len(sampling)} != number of "
                f"prompts {len(prompts)}")
        reqs = [self.add_request(p, sp) for p, sp in zip(prompts, sampling)]
        self.run()
        return [r.output() for r in reqs]
