"""ServingEngine: continuous batching over a paged KV pool.

Counterpart of `paddle_tpu/serving/engine.py` on its unified path
(`_build_unified` :1077, driven by `_unified_step` :2534). The engine
owns, per layer, one shared K/V pool [num_pages, page_size, H_kv, D]
(zero-initialised: trash-page keys are masked, never skipped, so they
must be finite), a page table [num_slots, max_pages] and one write
position per slot. A request admitted into a slot allocates the pages
its prompt plus output budget needs.

Every step runs ONE fixed-shape [num_slots, chunk_len] forward in which
each row carries its own live query count `q_len`: decoding rows feed
the token sampled from their held logits at q_len 1, mid-prefill rows
feed up to chunk_len prompt tokens, idle rows ride dead at q_len 0
(`Scheduler.pack_tokens` decides the packing under `token_budget`).
Attention is ragged paged attention (K6), every LayerNorm the fused
kernel (K1): 2 * n_layers + 1 LayerNorm launches and n_layers attention
launches per step. The step runs eagerly; capturing it in a CUDA graph
is later work.

The radix prefix cache (`serving.prefix`, on by default) attaches
cached prefix pages at admission; a mid-page match is copied into a
private page first (copy-on-write), so a shared page is never written
through. Greedy decoding is a first-occurrence argmax over the held
logits; sampled rows use the engine's seeded `torch.Generator`.

Not ported yet, and refused at construction with the ROADMAP item
(queue 1, item 10): the legacy alternating step (`unified=False`), the
grouped prefix walk (K10, the JAX engine's default), preemption and the
host swap tier (also on by default there), int8/fp8 KV, speculative
decoding, grammar, adapters, tensor parallelism, the megakernel, and
the observability and SLO layers.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..core.device import DeviceLike, make_generator, resolve_device
from ..nlp.generation import _top_p_filter, _unpack_caches
from .metrics import ServingMetrics
from .paging import PagePool, TRASH_PAGE, pages_needed
from .prefix import RadixPrefixCache
from .request import Request, RequestOutput, RequestState, SamplingParams
from .scheduler import Scheduler

__all__ = ["ServingEngine", "unified_forward"]

# option -> (values that mean "off", where the port stands)
_UNPORTED = {
    "unified": ((None, True), "the legacy alternating step and K9 "
                "(ROADMAP.md queue 1 item 10, queue 2 K9)"),
    "grouped": ((None, False), "the prefix-grouped walk "
                "(ROADMAP.md queue 2 K10, next slice)"),
    "preempt": ((None, False), "preemption and the host swap tier "
                "(ROADMAP.md queue 1 item 10)"),
    "kv_dtype": ((None, "fp"), "int8/fp8 KV lanes "
                 "(ROADMAP.md queue 1 item 10, queue 2 K7)"),
    "spec": ((None, False), "speculative decoding "
             "(ROADMAP.md queue 1 item 10)"),
    "grammar": ((None, False), "grammar-constrained decoding "
                "(ROADMAP.md queue 1 item 10)"),
    "adapters": ((None, False), "LoRA adapters "
                 "(ROADMAP.md queue 1 item 10, queue 2 K11)"),
    "mesh": ((None,), "tensor-parallel serving "
             "(ROADMAP.md queue 1 item 10)"),
    "megakernel": ((None, False), "the decode megakernel "
                   "(ROADMAP.md queue 2 K8, K12, K13)"),
    "obs": ((None, False), "the flight recorder and request tracer "
            "(ROADMAP.md queue 1 item 10)"),
    "slo": ((None, False), "the SLO tracker "
            "(ROADMAP.md queue 1 item 10)"),
}


def _sample_rows(logits: torch.Tensor, generator: torch.Generator,
                 temps: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, greedy: torch.Tensor
                 ) -> torch.Tensor:
    """Per-slot sampling over f32 logits [S, V] (the JAX engine's
    `_sample_rows`): greedy rows take the first-occurrence argmax of the
    raw logits; the others apply their own temperature, top-k (0 = off)
    and top-p (1.0 = off), then draw with the Gumbel-max trick from
    `generator`."""
    v = logits.shape[-1]
    g = torch.argmax(logits, dim=-1)
    l = logits / temps[:, None]
    sorted_desc = torch.sort(l, dim=-1, descending=True).values
    kidx = (torch.clamp(top_k, 1, v) - 1).to(torch.int64)
    kth = torch.gather(sorted_desc, 1, kidx[:, None])
    l = torch.where((top_k > 0)[:, None] & (l < kth),
                    torch.full_like(l, -1e30), l)
    l = torch.where((top_p < 1.0)[:, None], _top_p_filter(l, top_p[:, None]),
                    l)
    u = torch.rand(l.shape, generator=generator, device=l.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.where(greedy, g, torch.argmax(l + gumbel, dim=-1))


def unified_forward(model, pools, tokens: torch.Tensor, pos: torch.Tensor,
                    page_table: torch.Tensor, q_len: torch.Tensor,
                    is_decode: torch.Tensor,
                    last_logits: torch.Tensor) -> torch.Tensor:
    """The model half of one unified step: run tokens [S, W] through the
    model over the per-layer (k, v) `pools` (written in place) and
    return the new held logits [S, V] f32 — a decode row's from its
    column 0, a prefill row's from its last live column, a dead row's
    unchanged. Only those rows go through the LM head."""
    caches = _unpack_caches(pools, pos, page_table, q_len)
    h, _ = model.gpt(tokens, caches=caches)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last = torch.where(is_decode, torch.zeros_like(q_len),
                       torch.clamp(q_len - 1, min=0)).to(torch.int64)
    row_last = model.lm_head(h[rows, last]).float()
    return torch.where((q_len > 0)[:, None], row_last, last_logits)


class ServingEngine:
    """Online inference engine: submit requests at any time, pump
    `step()` (or call `run()`/`generate()`); requests join free slots
    when their page budget fits the pool, prefill chunk by chunk,
    decode together in the one unified step, and retire on EOS,
    max-tokens, timeout or cancellation."""

    def __init__(self, model, *, num_slots: int = 8, max_len: int = 256,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 chunk_len: int = 32, max_queue: Optional[int] = None,
                 prefix_cache: bool = True, device: DeviceLike = None,
                 seed: int = 0,
                 unified=None, grouped=None, preempt=None, kv_dtype=None,
                 spec=None, grammar=None, adapters=None, mesh=None,
                 megakernel=None, obs=None, slo=None):
        options = dict(unified=unified, grouped=grouped, preempt=preempt,
                       kv_dtype=kv_dtype, spec=spec, grammar=grammar,
                       adapters=adapters, mesh=mesh, megakernel=megakernel,
                       obs=obs, slo=slo)
        for name, value in options.items():
            off, what = _UNPORTED[name]
            if not any(value is o or value == o for o in off):
                raise NotImplementedError(
                    f"ServingEngine({name}={value!r}) is not ported yet: "
                    f"{what}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.n_layers, self.n_kv, self.head_dim = model._decode_cache_spec()
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
        if self.chunk_len < 1:
            raise ValueError("chunk_len must be >= 1")
        # every step may pack the full [num_slots, chunk_len] shape
        self.token_budget = self.num_slots * self.chunk_len
        self.scheduler = Scheduler(self.num_slots, max_queue=max_queue)
        self.metrics = ServingMetrics()
        self._clock = time.monotonic
        self._id_counter = itertools.count()
        self._requests: Dict[str, Request] = {}
        self._generator = make_generator(seed, self.device)
        # device state: per-layer K/V pools, per-slot held logits
        shape = (self.num_pages, self.page_size, self.n_kv, self.head_dim)
        self._pools = [
            (torch.zeros(shape, dtype=model.dtype, device=self.device),
             torch.zeros(shape, dtype=model.dtype, device=self.device))
            for _ in range(self.n_layers)]
        self._last_logits = torch.zeros(
            (self.num_slots, model.config.vocab_size), dtype=torch.float32,
            device=self.device)
        # host state: positions, page tables, sampling vectors
        self._pos = np.zeros((self.num_slots,), np.int32)
        self.pool = PagePool(self.num_pages)
        self.prefix_cache = (RadixPrefixCache(self.pool, self.page_size)
                             if prefix_cache else None)
        self._slot_pages: Dict[int, List[int]] = {}
        self._prefill_cursor: Dict[str, int] = {}
        self._pt_host = np.full((self.num_slots, self.max_pages),
                                TRASH_PAGE, np.int32)
        self._pt_dev: Optional[torch.Tensor] = None   # None = re-upload
        self._vec_dev: Optional[tuple] = None          # None = re-upload
        self._all_greedy = True

    # -- request intake ----------------------------------------------------
    def add_request(self, prompt_ids, sampling: Optional[SamplingParams]
                    = None, request_id: Optional[str] = None,
                    on_token=None) -> Request:
        sampling = sampling or SamplingParams()
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids).reshape(-1)
        if prompt.size >= self.max_len:
            raise ValueError(f"prompt length {prompt.size} >= engine "
                             f"max_len {self.max_len}")
        if prompt.size + sampling.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{sampling.max_new_tokens} exceeds engine max_len "
                f"{self.max_len}")
        need = pages_needed(prompt.size, sampling.max_new_tokens,
                            self.page_size)
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.num_pages - 1} allocatable pages")
        if request_id is None:
            request_id = f"req-{next(self._id_counter)}"
        if request_id in self._requests:
            raise ValueError(f"duplicate request_id {request_id!r}")
        req = Request(request_id, prompt, sampling, on_token=on_token,
                      arrival_t=self._clock())
        self.scheduler.submit(req)
        self._requests[request_id] = req
        self.metrics.on_submit(req)
        return req

    def cancel(self, request_id: str) -> bool:
        """Cancel a request: a queued one drops now, a running one is
        evicted at the next step boundary and its pages return."""
        req = self._requests.get(request_id)
        if req is None or req.finished:
            return False
        if req.state is RequestState.QUEUED:
            self.scheduler.drop_queued(req)
            self._finish_and_free(req, "cancelled", self._clock(), [])
            return True
        req.state = RequestState.CANCELLED
        return True

    # -- step boundary: retire / admit -------------------------------------
    def _finish_and_free(self, req: Request, reason: str, now: float,
                         finished: List[RequestOutput]):
        if req.slot is not None:
            slot = req.slot
            self.scheduler.retire(slot)
            self._vec_dev = None
            pages = self._slot_pages.pop(slot, None)
            if pages:
                self._retire_pages(req, reason, pages)
            req.pages = None
            req._prefix_grant = None
            self._pt_host[slot, :] = TRASH_PAGE
            self._pt_dev = None
        self._prefill_cursor.pop(req.request_id, None)
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
            self.prefix_cache.insert(seq, pages, seq.size)
        else:
            self.prefix_cache.release(pages)

    def _evict(self, now: float, finished: List[RequestOutput]):
        for req in self.scheduler.expired(now):
            if req.state is RequestState.QUEUED:
                self.scheduler.drop_queued(req)
            self._finish_and_free(req, "timeout", now, finished)
        for req in self.scheduler.cancelled_running():
            self._finish_and_free(req, "cancelled", now, finished)

    def _reserve(self, req: Request) -> bool:
        """Page-aware admission: grant the slot only if the request's
        whole page budget is available now (match-then-reserve with the
        prefix cache)."""
        if self.prefix_cache is None:
            pages = self.pool.alloc(pages_needed(
                req.prompt_ids.size, req.sampling.max_new_tokens,
                self.page_size))
            if pages is None:
                return False
            req.pages = pages
            return True
        grant = self.prefix_cache.acquire(req.prompt_ids,
                                          req.sampling.max_new_tokens)
        if grant is None:
            return False
        req.pages = grant.pages
        req.cached_tokens = grant.cached_len
        req._prefix_grant = grant
        return True

    def _admit(self, now: float):
        for slot, req in self.scheduler.assign(reserve=self._reserve):
            req.state = RequestState.PREFILL
            req.admitted_t = now
            self._slot_pages[slot] = req.pages
            self._pt_host[slot, :] = TRASH_PAGE
            self._pt_host[slot, :len(req.pages)] = req.pages
            self._pt_dev = None
            self._vec_dev = None
            # prefill starts at the first uncached token
            self._pos[slot] = req.cached_tokens
            grant = req._prefix_grant
            if grant is not None and grant.cow_src is not None:
                self._copy_page(grant.cow_src, grant.cow_dst)
                self.prefix_cache.cow_done(grant)
            self._prefill_cursor[req.request_id] = req.cached_tokens
            self.metrics.on_admit(req, self._clock())

    def _copy_page(self, src: int, dst: int):
        """Copy-on-write: one page of every layer's K and V pool."""
        with record_function(f"serving::cow_copy[{src}->{dst}]"):
            for k, v in self._pools:
                k[dst].copy_(k[src])
                v[dst].copy_(v[src])

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

    def _forward(self, tokens, pos, page_table, q_len, is_decode):
        return unified_forward(self.model, self._pools, tokens, pos,
                               page_table, q_len, is_decode,
                               self._last_logits)

    @torch.no_grad()
    def _unified_step(self, finished: List[RequestOutput]):
        running = self.scheduler.running
        if not running:
            return
        W = self.chunk_len
        remaining = {
            slot: int(req.prompt_ids.size)
            - self._prefill_cursor[req.request_id]
            for slot, req in running.items()
            if req.state is RequestState.PREFILL}
        decode_slots, grants = self.scheduler.pack_tokens(
            self.token_budget, W, remaining)
        if not decode_slots and not grants:
            return
        tokens = np.zeros((self.num_slots, W), np.int64)
        q_len = np.zeros((self.num_slots,), np.int32)
        is_decode = np.zeros((self.num_slots,), bool)
        q_len[decode_slots] = 1
        is_decode[decode_slots] = True
        for slot, take in grants.items():
            req = running[slot]
            cur = self._prefill_cursor[req.request_id]
            tokens[slot, :take] = req.prompt_ids[cur:cur + take]
            q_len[slot] = take
        temps, topk, topp, greedy = self._sampling_vectors()
        t0 = time.perf_counter()
        with record_function("serving::unified_step"):
            dev = self.device
            isd = torch.from_numpy(is_decode).to(dev)
            ql = torch.from_numpy(q_len).to(dev)
            if self._all_greedy:
                nxt = torch.argmax(self._last_logits, dim=-1)
            else:
                nxt = _sample_rows(self._last_logits, self._generator,
                                   temps, topk, topp, greedy)
            toks = torch.from_numpy(tokens).to(dev)
            toks[:, 0] = torch.where(isd, nxt, toks[:, 0])
            self._last_logits = self._forward(
                toks, torch.from_numpy(self._pos).to(dev),
                self._page_table(), ql, isd)
            nxt = nxt.cpu().numpy()      # sync: the host sees the tokens
        wall = time.perf_counter() - t0
        self._pos += q_len
        n_prefill = int(sum(grants.values()))
        self.metrics.on_unified_step(n_prefill, len(decode_slots), wall)
        now = self._clock()
        for slot, take in grants.items():
            req = running[slot]
            cur = self._prefill_cursor[req.request_id] + take
            self._prefill_cursor[req.request_id] = cur
            if cur >= req.prompt_ids.size:
                # the last prompt token's logits are held: the row
                # samples its first token next step
                self._prefill_cursor.pop(req.request_id, None)
                req.state = RequestState.DECODE
        for slot in decode_slots:
            req = running.get(slot)
            if req is None or req.state is not RequestState.DECODE:
                continue
            tok = int(nxt[slot])
            prev_t = req._last_token_t
            req._emit(tok, now)
            self.metrics.on_token(req, now)
            if prev_t is not None:
                self.metrics.on_inter_token(now - prev_t)
            sp = req.sampling
            if sp.eos_token_id is not None and tok == sp.eos_token_id:
                self._finish_and_free(req, "stop", now, finished)
            elif len(req.output_tokens) >= sp.max_new_tokens:
                self._finish_and_free(req, "length", now, finished)

    def step(self) -> List[RequestOutput]:
        """One scheduler round: evict (timeout / cancel), admit queued
        requests whose pages fit, then run the unified step. Returns
        the requests that finished this round."""
        finished: List[RequestOutput] = []
        now = self._clock()
        self._evict(now, finished)
        self._admit(now)
        self._unified_step(finished)
        self.metrics.on_step(self.scheduler.queue_depth,
                             self.pool.used_pages, self.pool.cached_pages,
                             self.num_pages - 1)
        return finished

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
