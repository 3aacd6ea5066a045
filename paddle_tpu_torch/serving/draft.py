"""A resident draft MODEL inside the serving engine, the "model" tier of
speculative decoding (counterpart of `paddle_tpu/serving/draft.py`).

The n-gram drafter (serving/spec.py) only drafts where the continuation
repeats earlier text. The draft-model tier proposes by decoding: a small
model of the target's family (`make_draft_model` truncates the target's
layers with a weight copy, or the caller hands in any model sharing its
tokenizer) lives in the engine as a `DraftEngine`:

- It owns a second, smaller paged KV pool managed by the engine's
  `PagePool` as it is (trash page 0, refcounted pages,
  `assert_quiesced()`). The pool holds the draft model's float dtype
  whatever the target's `kv_dtype` is, so the draft step never takes the
  quantized lanes; it has no host tier (preemption releases the pages,
  resume re-seeds from the committed history).
- Each drafting slot keeps a mirrored draft page table and a host-side
  draft position `dpos`: how many tokens of the slot's COMMITTED stream
  have valid draft K/V. Proposing advances it; `committed` clamps it to
  the committed length, which is the rollback: rejected drafts' K/V
  sits past the clamp and is overwritten before anything attends it.
- Proposing is k micro-steps of the draft model's own ragged forward,
  every drafting row batched in each: the port's unified-step machinery
  (`_unpack_caches`, ragged paged attention K6, K1 in GPT's LayerNorms)
  on the draft pools, ungrouped and without the megakernel, as the JAX
  draft program. Micro-step 0 feeds each row's catch-up (the committed
  tokens past `dpos`, then the step's t0, the token the target commits
  this step); each later one feeds the previous argmax at q_len 1. The
  harvested argmaxes are `[draft_1 .. draft_k]`, draft i predicting
  committed position P + i, which is what the target's greedy
  acceptance verifies.
- Warming a long prompt rides the step's spare token budget (`seed`,
  packed by `Scheduler.pack_draft_seed`).

The draft model runs without LoRA deltas: only the target's verify row
carries a request's adapter.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..nlp.generation import _unpack_caches
from .paging import PagePool, TRASH_PAGE, pages_needed

__all__ = ["DraftConfig", "DraftEngine", "make_draft_model"]


def make_draft_model(model, num_layers: Optional[int] = None):
    """Shrink a target model into a draft model by LAYER TRUNCATION with
    weight copy: the first `num_layers` layers (default half, at least
    1) and the embedding, final norm and LM head, all copied from the
    target, on its device and in its dtype. The tokenizer, vocabulary
    and head stay the target's, and the kept layers are the target's
    own first layers, so the draft's greedy argmax often agrees with
    the target's (a disagreement costs a rejected draft, never a wrong
    token). Works for any model whose `config.num_hidden_layers` sets
    its depth (`GPTForCausalLM`, `LlamaForCausalLM`)."""
    cfg = copy.deepcopy(model.config)
    n = int(cfg.num_hidden_layers)
    keep = (max(1, n // 2) if num_layers is None
            else max(1, min(int(num_layers), n)))
    cfg.num_hidden_layers = keep
    draft = type(model)(cfg, device=model.device, dtype=model.dtype,
                        seed=getattr(model, "seed", 0))
    want = draft.state_dict()
    draft.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k in want})
    return draft.eval()


@dataclass
class DraftConfig:
    """Geometry of the draft tier, mirrored from the engine: the slot
    count and step width are the target's (draft rows are the same
    slots), the page size too, and `num_pages` / `max_pages` default to
    the target pool's (the same page count, fewer bytes a page)."""

    num_slots: int
    chunk_len: int
    page_size: int
    num_pages: int
    max_pages: int
    attn_impl: Optional[str] = None


class DraftEngine:
    """The draft model and its paged KV pool, resident in one engine.

    - `admit(slot, prompt_len, max_new)` reserves the slot's whole draft
      page budget (False under draft-pool pressure: the slot then does
      not model-draft until pages free; correctness never depends on
      it).
    - `committed(slot, n)` clamps the slot's draft position to the
      committed length `n` (the rollback); `lag(slot, n)` is what the
      draft K/V misses.
    - `propose_batch(entries)` runs the k micro-steps for every drafting
      row at once; `seed(entries)` chunk-prefills lagging rows.
    - `release(slot)` frees the slot's draft pages (retirement,
      preemption, abort); `assert_quiesced()` then proves none leaked.

    `micro_steps` counts the draft forwards run (proposing and
    seeding)."""

    def __init__(self, model, cfg: DraftConfig):
        self.model = model
        self.num_slots = int(cfg.num_slots)
        self.chunk_len = int(cfg.chunk_len)
        self.page_size = int(cfg.page_size)
        self.num_pages = int(cfg.num_pages)
        self.max_pages = int(cfg.max_pages)
        self.attn_impl = cfg.attn_impl
        self.device = model.device
        n_layers, n_kv, head_dim = model._decode_cache_spec()
        self.n_layers, self.n_kv, self.head_dim = \
            int(n_layers), int(n_kv), int(head_dim)
        dtype = model.dtype
        if not dtype.is_floating_point:
            raise ValueError(f"draft model dtype {dtype} is not a float")
        shape = (self.num_pages, self.page_size, self.n_kv, self.head_dim)
        # the draft pool: float pages only (see the module doc)
        self._pools = [(torch.zeros(shape, dtype=dtype, device=self.device),
                        torch.zeros(shape, dtype=dtype, device=self.device),
                        None, None) for _ in range(self.n_layers)]
        self.pool = PagePool(self.num_pages)
        self.page_bytes = (self.n_layers * 2 * self.page_size * self.n_kv
                           * self.head_dim * dtype.itemsize)
        self._slot_pages: Dict[int, List[int]] = {}
        self._pt_host = np.full((self.num_slots, self.max_pages),
                                TRASH_PAGE, np.int32)
        self._pt_dev: Optional[torch.Tensor] = None   # None = re-upload
        # committed-stream tokens with valid draft K/V, per slot
        self._dpos = np.zeros((self.num_slots,), np.int64)
        self.micro_steps = 0

    # -- slot lifecycle ----------------------------------------------------
    def resident(self, slot: int) -> bool:
        return slot in self._slot_pages

    def admit(self, slot: int, prompt_len: int, max_new: int) -> bool:
        """Reserve the slot's whole draft page budget (prompt + max_new,
        the bound the target admission reserves: the deepest draft write
        is position prompt + max_new - 1). Idempotent for a resident
        slot."""
        if slot in self._slot_pages:
            return True
        pages = self.pool.alloc(pages_needed(
            int(prompt_len), int(max_new), self.page_size))
        if pages is None:
            return False
        self._slot_pages[slot] = pages
        self._pt_host[slot, :] = TRASH_PAGE
        self._pt_host[slot, :len(pages)] = pages
        self._pt_dev = None
        self._dpos[slot] = 0
        return True

    def release(self, slot: int):
        """Free the slot's draft pages (a no-op for a slot not
        resident: every slot-freeing engine path calls it)."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.pool.free(pages)
            self._pt_host[slot, :] = TRASH_PAGE
            self._pt_dev = None
        self._dpos[slot] = 0

    def committed(self, slot: int, n: int) -> int:
        """Clamp the slot's draft position to the committed length `n`
        and return it. The clamp is the rollback: draft K/V past `n`
        becomes dead padding, overwritten by the next feed."""
        if self._dpos[slot] > n:
            self._dpos[slot] = n
        return int(self._dpos[slot])

    def lag(self, slot: int, n: int) -> int:
        """How many committed tokens the slot's draft K/V misses."""
        return max(0, int(n) - self.committed(slot, int(n)))

    # -- the draft forward -------------------------------------------------
    @torch.no_grad()
    def _micro_step(self, tokens: np.ndarray, q_len: np.ndarray
                    ) -> np.ndarray:
        """One ragged draft forward over [num_slots, chunk_len]: row i's
        q_len[i] tokens write K/V at dpos[i] .. dpos[i] + q_len[i] - 1,
        and the argmax of its last live column comes back (rows at q_len
        0 change nothing their window holds). Positions come from the
        host's `_dpos` every call, so a clamp needs no device
        bookkeeping."""
        from .engine import model_backbone
        dev = self.device
        if self._pt_dev is None:
            self._pt_dev = torch.from_numpy(self._pt_host).to(dev)
        with record_function("serving::draft_step"):
            ql = torch.from_numpy(q_len.astype(np.int32)).to(dev)
            caches = _unpack_caches(
                self._pools, torch.from_numpy(self._dpos.astype(np.int32))
                .to(dev), self._pt_dev, ql, attn_impl=self.attn_impl)
            h, _ = model_backbone(self.model)(
                torch.from_numpy(tokens.astype(np.int64)).to(dev),
                caches=caches)
            rows = torch.arange(self.num_slots, device=dev)
            last = torch.clamp(ql - 1, min=0).to(torch.int64)
            logits = self.model.lm_head(h[rows, last]).float()
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self._dpos += q_len.astype(np.int64)
        self.micro_steps += 1
        return nxt

    # -- drafting ----------------------------------------------------------
    def propose_batch(self, entries: Dict[int, Tuple[np.ndarray, int]]
                      ) -> Dict[int, np.ndarray]:
        """Draft for every row at once: `entries` maps slot -> (catch-up
        feed, k), the feed being the slot's committed tokens past `dpos`
        and the step's t0 (1 .. chunk_len tokens; larger lags wait for
        `seed`). Micro-step 0 feeds the catch-ups and harvests draft_1,
        micro-steps 1 .. k-1 feed the previous argmax at q_len 1; a row
        with a smaller k stops early. Returns slot -> [draft_1 ..
        draft_k]; the last draft is never fed, so after a full accept
        the slot lags by one and the next catch-up absorbs it."""
        if not entries:
            return {}
        S, W = self.num_slots, self.chunk_len
        out: Dict[int, list] = {slot: [] for slot in entries}
        pend: Dict[int, int] = {}
        tokens = np.zeros((S, W), np.int64)
        q_len = np.zeros((S,), np.int32)
        k_max = 0
        for slot, (catchup, k) in entries.items():
            c = np.asarray(catchup, np.int64).reshape(-1)
            if not 0 < c.size <= W:
                raise ValueError(
                    f"draft catch-up feed for slot {slot} has {c.size} "
                    f"tokens (want 1..{W})")
            tokens[slot, :c.size] = c
            q_len[slot] = c.size
            pend[slot] = int(k)
            k_max = max(k_max, int(k))
        for _ in range(k_max):
            nxt = self._micro_step(tokens, q_len)
            tokens[:] = 0
            q_len[:] = 0
            for slot in list(pend):
                out[slot].append(int(nxt[slot]))
                pend[slot] -= 1
                if pend[slot] > 0:
                    tokens[slot, 0] = nxt[slot]
                    q_len[slot] = 1
                else:
                    del pend[slot]
        return {slot: np.asarray(v, np.int64) for slot, v in out.items()}

    def seed(self, entries: Dict[int, np.ndarray]):
        """Chunked draft prefill: write `entries[slot]` (the slot's next
        committed tokens past its `dpos`, at most chunk_len) into the
        draft K/V, every seeding slot in one ragged forward."""
        if not entries:
            return
        S, W = self.num_slots, self.chunk_len
        tokens = np.zeros((S, W), np.int64)
        q_len = np.zeros((S,), np.int32)
        for slot, toks in entries.items():
            t = np.asarray(toks, np.int64).reshape(-1)
            if not 0 < t.size <= W:
                raise ValueError(
                    f"draft seed chunk for slot {slot} has {t.size} tokens "
                    f"(want 1..{W})")
            tokens[slot, :t.size] = t
            q_len[slot] = t.size
        self._micro_step(tokens, q_len)

    # -- accounting --------------------------------------------------------
    def stats(self) -> dict:
        return {"pages_used": self.pool.used_pages,
                "pages_total": self.num_pages - 1,
                "bytes_per_page": self.page_bytes,
                "residents": len(self._slot_pages),
                "layers": self.n_layers}

    def assert_quiesced(self):
        self.pool.assert_quiesced()
        assert not self._slot_pages, (
            f"draft slots still resident: {sorted(self._slot_pages)}")
