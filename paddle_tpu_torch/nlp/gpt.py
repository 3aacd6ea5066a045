"""GPT: decoder-only transformer LM, as `nn.Module`s.

Counterpart of `paddle_tpu/nlp/gpt.py` (GPTConfig, GPTModel,
GPTForCausalLM), for training and for inference over the paged decode
cache:

- pre-LN decoder layers; every LayerNorm runs through `nn.LayerNorm`
  of this package: K1 forward and K2 backward on the card;
- the fused QKV projection is reshaped to [b, l, H, 3 * D] and split, so
  q, k and v are interleaved PER HEAD as in the JAX package
  (gpt.py:101-103);
- without caches (training, and a plain forward) attention is
  `F.scaled_dot_product_attention(..., is_causal=True)`, so flash
  attention K3 forward and K4/K5 backward on the card (gpt.py:150-152);
  the embedding dropout and each layer's dropout1/dropout2
  (upscale_in_train) run in training mode, drawn from a model-owned
  generator;
- with caches, attention is `nlp.generation.update_and_attend` in the
  caches' mode: the unified step's ragged walk (K6/K7/K10), the legacy
  step's paged decode (K9, or K7 over int8 pools) and gathered chunks
  (K3), or the dense cache of `generate()` (K3); position ids are
  pos[b] + i for a per-row pos and pos + i for a scalar one
  (gpt.py:231-239), clamped to the table: a padding column of the
  serving step can sit past the last position, and its output is never
  used. That path applies no dropout;
- the LM head is tied: logits = h @ E^T (gpt.py:311-312); with labels
  the forward returns cross_entropy(logits, labels), labels aligned
  with logits position for position (no shift, gpt.py:313-315);
- multi-tenant LoRA on the cached path (gpt.py:105-133): with
  `cache.lora` the per-row q/k/v deltas (`lora_delta`) add after the
  fused-QKV split and the o-delta after the output projection; with
  `cache.lora_paged` (megakernel mode) the attention input goes to the
  fused op as `lora_x` for the q/k/v deltas and the o-delta is
  `lora_delta_paged` (K11);
- mixed dtypes follow jnp's promotion, as the JAX layers do: a layer
  fed a wider dtype than its weights (the gather branch over 1-byte
  pools returns f32 to a bf16 model) computes its projections and
  LayerNorms in the wider dtype, the weights upcast;
- `generate()` (gpt.py:355) decodes through `CompiledGenerator` over a
  static dense cache (greedy, sampling, beam search; a bf16/f32 or the
  int8 cache); `use_compiled=False` runs the same loop as the JAX eager
  debug loop (gpt.py:398-423) does, which never stops at eos.

- `use_recompute=True` recomputes each decoder layer's body in the
  backward of a training forward (`distributed.fleet.utils.recompute`,
  gpt.py:189-205), replaying its dropout draws from the model's
  generator.

Linear layers are `torch.nn.Linear` ([out, in] weights; `convert.py`
transposes the JAX package's [in, out]). `fuse_attention_qkv` is
stored, as the JAX package stores it (the projection is always fused);
tensor and sequence parallelism raise (ROADMAP.md, queue 1, item 13).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, make_generator, resolve_device
from ..distributed.fleet.utils import recompute
from ..nn import LayerNorm
from ..nn import functional as PF
from ..ops.cuda.paged_attention import lora_delta, lora_delta_paged
from .generation import (DecodeCache, attend_shards, generate,
                         update_and_attend)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=1024,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 initializer_range=0.02, layer_norm_epsilon=1e-5,
                 use_recompute=False, tensor_parallel=None,
                 sequence_parallel=False, fuse_attention_qkv=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        self.use_recompute = use_recompute
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.fuse_attention_qkv = fuse_attention_qkv


def _linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """mod(x), in the promoted dtype of x and the weights when they
    differ (jnp's promotion: the weights upcast exactly)."""
    return linear_wb(x, mod.weight, mod.bias)


def linear_wb(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
    """F.linear(x, w, b) with `_linear`'s promotion: also a shard's run
    of a projection's output features (serving/tp.py)."""
    if x.dtype == w.dtype:
        return F.linear(x, w, b)
    ct = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(ct), w.to(ct), None if b is None else b.to(ct))


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.dropout = config.attention_probs_dropout_prob
        self.qkv_proj = nn.Linear(config.hidden_size,
                                  3 * config.hidden_size, **factory)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  **factory)

    def forward(self, x: torch.Tensor, cache: Optional[DecodeCache] = None,
                generator: Optional[torch.Generator] = None):
        """Without a cache: causal attention over x -> [b, l, h]. With
        one: (output, advanced cache) through the paged step, with the
        cache's LoRA deltas (module doc)."""
        b, l, h = x.shape
        if cache is not None and cache.shards is not None:
            return self._forward_shards(x, cache)
        qkv = _linear(self.qkv_proj, x).view(b, l, self.num_heads,
                                             3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        if cache is not None:
            lora, lora_paged = cache.lora, cache.lora_paged
            if lora is not None:
                aq, bq, ak, bk, av, bv, ao, bo, sc = lora
                q = q + lora_delta(x, aq, bq, sc).reshape(q.shape)
                k = k + lora_delta(x, ak, bk, sc).reshape(k.shape)
                v = v + lora_delta(x, av, bv, sc).reshape(v.shape)
            out, cache = update_and_attend(
                q, k, v, cache,
                lora_x=x if lora_paged is not None else None)
            out = out.reshape(b, l, h)
            o = _linear(self.out_proj, out)
            if lora is not None:
                o = o + lora_delta(out, ao, bo, sc)
            elif lora_paged is not None:
                o = o + lora_delta_paged(out, *lora_paged[6:10])
            return o, cache
        out = PF.scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout, is_causal=True,
            training=self.training, generator=generator)
        return self.out_proj(out.reshape(b, l, h))

    def _shard_qkv(self, x: torch.Tensor, weights: dict,
                   cache: DecodeCache) -> tuple:
        """A shard's (q, k, v) [b, l, H / mp, D]: its run of qkv_proj's
        columns (q, k and v interleaved per head, so a run of whole
        heads) plus its rows' LoRA deltas over its columns of B."""
        b, l, _ = x.shape
        qkv = linear_wb(x, *weights["qkv_proj"])
        heads = qkv.shape[-1] // (3 * self.head_dim)
        q, k, v = qkv.view(b, l, heads, 3 * self.head_dim).split(
            self.head_dim, dim=-1)
        if cache.lora is not None:
            aq, bq, ak, bk, av, bv, _, _, sc = cache.lora
            q = q + lora_delta(x, aq, bq, sc).reshape(q.shape)
            k = k + lora_delta(x, ak, bk, sc).reshape(k.shape)
            v = v + lora_delta(x, av, bv, sc).reshape(v.shape)
        return q, k, v

    def _forward_shards(self, x: torch.Tensor, cache: DecodeCache):
        """The paged step over a sharded cache (serving/tp.py): the
        shards' heads through `attend_shards`, then the replicated output
        projection and its LoRA delta on the lead device."""
        b, l, h = x.shape
        out, cache = attend_shards(x, cache, self._shard_qkv)
        out = out.reshape(b, l, h)
        o = _linear(self.out_proj, out)
        if cache.lora is not None:
            o = o + lora_delta(out, *cache.lora[6:])
        return o, cache


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **factory)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x),
                                        approximate="tanh"))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: x + dropout1(attn(ln1(x))), then
    + dropout2(mlp(ln2(x)))."""

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln1 = LayerNorm(config.hidden_size, epsilon=eps, **factory)
        self.attn = GPTAttention(config, **factory)
        self.ln2 = LayerNorm(config.hidden_size, epsilon=eps, **factory)
        self.mlp = GPTMLP(config, **factory)
        self.hidden_dropout = config.hidden_dropout_prob
        self.use_recompute = config.use_recompute

    def _dropout(self, x, generator):
        return PF.dropout(x, self.hidden_dropout, self.training,
                          generator=generator)

    def _body(self, x, generator=None):
        x = x + self._dropout(self.attn(self.ln1(x), generator=generator),
                              generator)
        return x + self._dropout(self.mlp(self.ln2(x)), generator)

    def forward(self, x: torch.Tensor, cache: Optional[DecodeCache] = None,
                generator: Optional[torch.Generator] = None):
        if cache is not None:
            h, cache = self.attn(self.ln1(x), cache)
            x = x + h
            return x + self.mlp(self.ln2(x)), cache
        if self.use_recompute and self.training and torch.is_grad_enabled():
            return recompute(self._body, x, generator=generator)
        return self._body(x, generator)


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.max_position = config.max_position_embeddings
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **factory)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, **factory)
        self.dropout = config.hidden_dropout_prob

    def embed(self, input_ids: torch.Tensor, position_ids: torch.Tensor
              ) -> torch.Tensor:
        """Word plus position embeddings, without dropout (the paged
        step's input)."""
        return self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)

    def forward(self, input_ids: torch.Tensor, position_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return PF.dropout(self.embed(input_ids, position_ids), self.dropout,
                          self.training, generator=generator)

    def cached_position_ids(self, pos, l: int, b: int,
                            device: torch.device) -> torch.Tensor:
        """[b, l] ids of a cached step, clamped to the table: pos[b] + i
        for a per-row pos [b], pos + i for a scalar pos (an int or a
        0-dim tensor: the dense cache, and the legacy prefill chunk)."""
        ar = torch.arange(l, dtype=torch.int64, device=device)
        if torch.is_tensor(pos) and pos.dim() == 1:
            ids = pos.to(device=device, dtype=torch.int64)[:, None] + ar
        else:
            ids = (ar + (pos.to(device=device, dtype=torch.int64)
                         if torch.is_tensor(pos) else int(pos))
                   ).expand(b, l)
        return torch.clamp(ids, max=self.max_position - 1)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        if config.tensor_parallel or config.sequence_parallel:
            raise NotImplementedError(
                "GPTConfig(tensor_parallel=..., sequence_parallel=True): "
                "the distributed paths are not ported (ROADMAP.md, queue "
                "1, item 13)")
        self.config = config
        self.embeddings = GPTEmbeddings(config, **factory)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **factory)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                caches: Optional[List[DecodeCache]] = None,
                generator: Optional[torch.Generator] = None):
        """Without caches: the final hidden states [b, l, h], positions
        0..l-1 unless given. With caches: (hidden states, advanced
        caches) of the paged step."""
        if caches is not None:
            if position_ids is None:
                position_ids = self.embeddings.cached_position_ids(
                    caches[0].pos, input_ids.shape[1], input_ids.shape[0],
                    input_ids.device)
            x = self.embeddings.embed(input_ids, position_ids)
            new_caches = []
            for layer, cache in zip(self.layers, caches):
                x, cache = layer(x, cache)
                new_caches.append(cache)
            return self.ln_f(x), new_caches
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        x = self.embeddings(input_ids, position_ids, generator)
        for layer in self.layers:
            x = layer(x, generator=generator)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with the tied LM head. Built on `device` (default "cuda",
    which raises without CUDA) and initialised from `seed` as the JAX
    package does: N(0, initializer_range) for Linear weights and
    embeddings, zero biases, LayerNorm weight 1 and bias 0. Dropout
    (training mode only) draws from a generator on the model's device
    seeded from seed + 1, so its stream is not the weights'."""

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.seed = int(seed)
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
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
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.word_embeddings.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.embeddings.word_embeddings.weight.dtype

    def lm_head(self, h: torch.Tensor) -> torch.Tensor:
        w = self.gpt.embeddings.word_embeddings.weight
        ct = torch.promote_types(h.dtype, w.dtype)
        return F.linear(h.to(ct), w.to(ct))

    @property
    def generator(self) -> torch.Generator:
        """The dropout generator, re-made on the model's device if the
        model moved."""
        if self._generator.device != self.device:
            self._generator = make_generator(self.seed + 1, self.device)
        return self._generator

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                caches: Optional[List[DecodeCache]] = None):
        """input_ids [b, l] -> logits [b, l, V]; with `labels` [b, l],
        the mean cross entropy instead; with `caches`, (logits, advanced
        caches) of the paged step."""
        if caches is not None:
            h, caches = self.gpt(input_ids, position_ids, caches=caches)
        else:
            h = self.gpt(input_ids, position_ids, generator=self.generator)
        logits = self.lm_head(h)
        if labels is not None:
            return PF.cross_entropy(logits, labels)
        if caches is not None:
            return logits, caches
        return logits

    def _decode_cache_spec(self) -> Tuple[int, int, int]:
        cfg = self.config
        return (cfg.num_hidden_layers, cfg.num_attention_heads,
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
        (`nlp.generation.generate`, the JAX method's arguments and
        errors): input_ids [B, L] -> [B * n, L + max_new_tokens]."""
        return generate(self, input_ids, max_new_tokens, temperature,
                        top_k, top_p, eos_token_id, pad_token_id,
                        decode_strategy, num_beams, length_penalty,
                        num_return_sequences, use_compiled, kv_cache_dtype,
                        generator)
