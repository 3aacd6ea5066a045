"""Llama: RMSNorm, rotary embeddings, SwiGLU and GQA, as `nn.Module`s.

Counterpart of `paddle_tpu/nlp/llama.py` (LlamaConfig, LlamaModel,
LlamaForCausalLM), for training and inference: the cache-free forward
(with labels, the loss; in training mode the graph of the backward),
the eager (k, v) tuple cache and the decode caches of
`nlp/generation.py` (the dense cache of `generate()`, the serving
engine's paged and ragged steps).

- RMSNorm (`nn.RMSNorm`), rope and silu are jnp in the JAX package, so
  they are plain torch here, on the card too;
- rope rotates INTERLEAVED pairs (x[..., 0::2], x[..., 1::2], restacked
  on the last axis), not the two halves, with f32 angles pos * inv,
  inv = 1 / theta ** (arange(0, D, 2) / D) (llama.py:48-99). Every layer
  of one forward shares the positions, so the forward takes cos and sin
  once (`rope_tables`); a decode cache's pos is a scalar or a per-row
  [B] vector (the serving step: each row at its own position);
- q, k and v are separate projections; GQA repeats K/V over the query
  groups (`repeat_interleave`) on the cache-free and tuple paths, and
  the decode caches attend un-repeated. On the card the cache-free path
  is flash attention K3 (head dim 64, 128 or 256), the decode caches
  take their mode's kernels (`update_and_attend`);
- multi-tenant LoRA on the cached path (llama.py:123-168): the per-row
  deltas add to each projection BEFORE rope. With `cache.lora` they are
  `lora_delta` of the rows' gathered pairs; with `cache.lora_paged`
  (megakernel mode) each of the q, k, v and o deltas is one
  `lora_delta_paged` (K11) from the whole pools: rope sits between the
  projections and the attend, so Llama passes no `lora_x` and the fused
  op runs without its LoRA prologue;
- every Linear has a bias (the JAX `_make_linear` is `nn.Linear` with
  its default bias), the LM head is untied, and mixed dtypes follow
  jnp's promotion (`Linear`), as in `nlp/gpt.py`;
- training: the backward flows by torch autograd through rope, RMSNorm,
  SwiGLU and GQA's `repeat_interleave`, and through flash attention's
  K4 and K5 on the card; with `use_recompute=True` each decoder layer's
  `_body` runs again in the backward (`distributed.fleet.utils.
  recompute`, llama.py:226-241): K3 twice a layer, K4 and K5 once. The
  loss and the head are not recomputed.

`sequence_parallel` raises: the tensor-parallel layers of the JAX
package's `mp` mesh axis and its ring attention have no counterpart yet
(ROADMAP.md, queue 1, item 13).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..core.device import DeviceLike, make_generator, resolve_device
from ..distributed.fleet.utils import recompute
from ..nn import RMSNorm
from ..nn import functional as PF
from ..ops.cuda.paged_attention import lora_delta, lora_delta_paged
from .generation import (DecodeCache, attend_shards, generate,
                         update_and_attend)
from .gpt import _linear, linear_wb

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "apply_rotary",
           "rope_tables"]


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=None, intermediate_size=11008,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, initializer_range=0.02,
                 use_recompute=False, sequence_parallel=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or \
            num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute
        self.sequence_parallel = sequence_parallel
        self.hidden_dropout_prob = 0.0


RopeTables = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(offset: Union[int, torch.Tensor], l: int, d: int,
                theta: float, device=None) -> RopeTables:
    """cos and sin of the rotary angles of l positions from `offset`, f32
    [1 | B, l, 1, d / 2]: a Python int or a 0-dim tensor (every row) or a
    [B] tensor (row b from offset[b]), the JAX `_rope_fwd` and
    `_rope_dyn_fwd` angles."""
    if torch.is_tensor(offset):
        device = offset.device
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d))
    if torch.is_tensor(offset) and offset.dim() == 1:
        steps = torch.arange(l, dtype=torch.float32, device=device)
        freqs = (offset.float()[:, None] + steps[None])[:, :, None] * \
            inv[None, None, :]                               # [B, l, d/2]
    else:
        if torch.is_tensor(offset):
            pos = offset.float() + torch.arange(l, dtype=torch.float32,
                                                device=device)
        else:
            pos = torch.arange(int(offset), int(offset) + l,
                               dtype=torch.float32, device=device)
        freqs = torch.outer(pos, inv)[None]                  # [1, l, d/2]
    return torch.cos(freqs)[:, :, None, :], torch.sin(freqs)[:, :, None, :]


def _rotate(x: torch.Tensor, rope: RopeTables) -> torch.Tensor:
    """x [B, l, H, D] rotated pairwise by the tables, in x's dtype (the
    products in f32, as jnp promotes them)."""
    cos, sin = rope
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rotary(x: torch.Tensor, offset: Union[int, torch.Tensor] = 0,
                 theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of x [B, L, H, D] at positions offset + i (the
    JAX `apply_rotary`; `offset` as `rope_tables` takes it)."""
    return _rotate(x, rope_tables(offset, x.shape[1], x.shape[3], theta,
                                  x.device))


class Linear(nn.Linear):
    """`torch.nn.Linear` in the promoted dtype of its input and weights
    when they differ (jnp's promotion, `nlp.gpt._linear`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self, x)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.n_heads = config.num_attention_heads
        self.n_kv = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.q_proj = Linear(h, self.n_heads * self.head_dim, **factory)
        self.k_proj = Linear(h, self.n_kv * self.head_dim, **factory)
        self.v_proj = Linear(h, self.n_kv * self.head_dim, **factory)
        self.o_proj = Linear(self.n_heads * self.head_dim, h, **factory)

    def forward(self, x: torch.Tensor, rope: RopeTables, cache=None):
        """Without a cache: causal attention over x -> [b, l, h]. With a
        `DecodeCache`, or an eager (k, v) tuple [b, L, H_kv, D]: (output,
        advanced cache)."""
        b, l, _ = x.shape
        decode = isinstance(cache, DecodeCache)
        if decode and cache.shards is not None:
            return self._forward_shards(x, rope, cache)
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        lora = cache.lora if decode else None
        lora_paged = cache.lora_paged if decode else None
        if lora is not None:
            aq, bq, ak, bk, av, bv, ao, bo, sc = lora
            q = q + lora_delta(x, aq, bq, sc)
            k = k + lora_delta(x, ak, bk, sc)
            v = v + lora_delta(x, av, bv, sc)
        elif lora_paged is not None:
            aq, bq, ak, bk, av, bv, _, _, apage, ascale = lora_paged
            q = q + lora_delta_paged(x, aq, bq, apage, ascale)
            k = k + lora_delta_paged(x, ak, bk, apage, ascale)
            v = v + lora_delta_paged(x, av, bv, apage, ascale)
        q = _rotate(q.view(b, l, self.n_heads, self.head_dim), rope)
        k = _rotate(k.view(b, l, self.n_kv, self.head_dim), rope)
        v = v.view(b, l, self.n_kv, self.head_dim)
        if decode:
            out, cache = update_and_attend(q, k, v, cache)
            out = out.reshape(b, l, self.n_heads * self.head_dim)
            o = self.o_proj(out)
            if lora is not None:
                o = o + lora_delta(out, ao, bo, sc)
            elif lora_paged is not None:
                o = o + lora_delta_paged(out, *lora_paged[6:10])
            return o, cache
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        if self.n_kv != self.n_heads:
            rep = self.n_heads // self.n_kv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = PF.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=self.training)
        out = self.o_proj(out.reshape(b, l, self.n_heads * self.head_dim))
        return out if cache is None else (out, cache)

    def _forward_shards(self, x: torch.Tensor, rope: RopeTables,
                        cache: DecodeCache):
        """The paged step over a sharded cache (serving/tp.py): each
        shard projects its H / mp query and H_kv / mp kv heads (with its
        rows' LoRA deltas over its columns of B) and rotates them with
        the rope tables sent along with x; `attend_shards` writes, walks
        and gathers; the output projection and its delta run on the lead
        device."""
        b, l, _ = x.shape
        d = self.head_dim

        def project(xs, weights, c):
            q = linear_wb(xs, *weights["q_proj"])
            k = linear_wb(xs, *weights["k_proj"])
            v = linear_wb(xs, *weights["v_proj"])
            if c.lora is not None:
                aq, bq, ak, bk, av, bv, _, _, sc = c.lora
                q = q + lora_delta(xs, aq, bq, sc)
                k = k + lora_delta(xs, ak, bk, sc)
                v = v + lora_delta(xs, av, bv, sc)
            tables = tuple(t.to(xs.device) for t in rope)
            q = _rotate(q.view(b, l, -1, d), tables)
            k = _rotate(k.view(b, l, -1, d), tables)
            return q, k, v.view(b, l, -1, d)

        out, cache = attend_shards(x, cache, project)
        out = out.reshape(b, l, self.n_heads * d)
        o = self.o_proj(out)
        if cache.lora is not None:
            o = o + lora_delta(out, *cache.lora[6:])
        return o, cache


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, **factory)
        self.up_proj = Linear(h, i, **factory)
        self.down_proj = Linear(i, h, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(PF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps,
                                       **factory)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=eps, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.use_recompute = config.use_recompute

    def _body(self, x: torch.Tensor, rope: RopeTables) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), rope)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x: torch.Tensor, rope: RopeTables, cache=None):
        if cache is not None:
            h, cache = self.self_attn(self.input_layernorm(x), rope, cache)
            x = x + h
            return x + self.mlp(self.post_attention_layernorm(x)), cache
        if self.use_recompute and self.training and torch.is_grad_enabled():
            return recompute(self._body, x, rope)
        return self._body(x, rope)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        if config.sequence_parallel:
            raise NotImplementedError(
                "LlamaConfig(sequence_parallel=True): the distributed "
                "paths are not ported (ROADMAP.md, queue 1, item 13)")
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **factory)

    def forward(self, input_ids: torch.Tensor, caches=None):
        """The final hidden states [b, l, h]; with `caches` (one per
        layer: `DecodeCache`s, or (k, v) tuples), (hidden states, the
        advanced caches)."""
        cfg = self.config
        l = input_ids.shape[1]
        if caches is None:
            offset = 0
        elif isinstance(caches[0], DecodeCache):
            offset = caches[0].pos
        else:
            offset = caches[0][0].shape[1]
        rope = rope_tables(offset, l,
                           cfg.hidden_size // cfg.num_attention_heads,
                           cfg.rope_theta, input_ids.device)
        x = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                x = layer(x, rope)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer(x, rope, cache)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Llama with an untied LM head (with a bias, as every JAX Llama
    Linear). Built on `device` (default "cuda", which raises without
    CUDA) and initialised from `seed` as the JAX package does: N(0,
    initializer_range) for Linear weights and the embedding, zero
    biases, RMSNorm weights 1."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.config = config
        self.seed = int(seed)
        self.llama = LlamaModel(config, **factory)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              **factory)
        self.init_weights(seed)
        self._generator = make_generator(self.seed + 1, dev)

    @torch.no_grad()
    def init_weights(self, seed: int):
        gen = make_generator(seed, self.device)
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.embed_tokens.weight.dtype

    @property
    def generator(self) -> torch.Generator:
        """The sampling generator of `generate()`, re-made on the model's
        device if the model moved."""
        if self._generator.device != self.device:
            self._generator = make_generator(self.seed + 1, self.device)
        return self._generator

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                caches: Optional[List] = None):
        """input_ids [b, l] -> logits [b, l, V]; with `labels` [b, l],
        the mean cross entropy instead (labels aligned with logits, no
        shift); with `caches`, (logits, advanced caches)."""
        if caches is not None:
            h, caches = self.llama(input_ids, caches=caches)
            return self.lm_head(h), caches
        logits = self.lm_head(self.llama(input_ids))
        if labels is not None:
            return PF.cross_entropy(logits, labels)
        return logits

    def _decode_cache_spec(self) -> Tuple[int, int, int]:
        cfg = self.config
        return (cfg.num_hidden_layers, cfg.num_key_value_heads,
                cfg.hidden_size // cfg.num_attention_heads)

    def generate(self, input_ids, max_new_tokens: int = 16,
                 temperature: float = 1.0, top_k=None, top_p=None,
                 eos_token_id=None, pad_token_id: int = 0,
                 decode_strategy=None, num_beams: int = 4,
                 length_penalty: float = 0.0, num_return_sequences: int = 1,
                 use_compiled: bool = True, kv_cache_dtype=None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Autoregressive decoding over a static dense KV cache
        (`nlp.generation.generate`, GPT's arguments):
        input_ids [B, L] -> [B * n, L + max_new_tokens]."""
        return generate(self, input_ids, max_new_tokens, temperature,
                        top_k, top_p, eos_token_id, pad_token_id,
                        decode_strategy, num_beams, length_penalty,
                        num_return_sequences, use_compiled, kv_cache_dtype,
                        generator)
