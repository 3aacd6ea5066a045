"""GPT: decoder-only transformer LM, as `nn.Module`s.

Counterpart of `paddle_tpu/nlp/gpt.py` (GPTConfig, GPTModel,
GPTForCausalLM) for inference over the paged decode cache:

- pre-LN decoder layers; every LayerNorm runs through K1's wrapper
  (`nn.LayerNorm` of this package);
- the fused QKV projection is reshaped to [b, l, H, 3 * D] and split, so
  q, k and v are interleaved PER HEAD as in the JAX package
  (gpt.py:101-103);
- attention is the paged ragged step of `nlp.generation`, which runs
  ragged paged attention (K6). A forward without caches builds a
  one-shot paged cache, so plain causal attention goes through K6 too;
- position ids are per row, pos[b] + i (gpt.py:231-239), clamped to
  the table: a padding column of the serving step can sit past the last
  position, and its output is never used;
- the LM head is tied: logits = h @ E^T (gpt.py:311-312).

Linear layers are `torch.nn.Linear` ([out, in] weights; `convert.py`
transposes the JAX package's [in, out]). Dropout, recompute, tensor and
sequence parallelism and the training path are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, make_generator, resolve_device
from ..nn import LayerNorm
from .generation import DecodeCache, update_and_attend

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM"]

# page size of the one-shot cache a forward without caches builds
_ONE_SHOT_PAGE = 16


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=1024,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 initializer_range=0.02, layer_norm_epsilon=1e-5):
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


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = nn.Linear(config.hidden_size,
                                  3 * config.hidden_size, **factory)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  **factory)

    def forward(self, x: torch.Tensor, cache: DecodeCache
                ) -> Tuple[torch.Tensor, DecodeCache]:
        b, l, h = x.shape
        qkv = self.qkv_proj(x).view(b, l, self.num_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        out, cache = update_and_attend(q, k, v, cache)
        return self.out_proj(out.reshape(b, l, h)), cache


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **factory)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(x))."""

    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln1 = LayerNorm(config.hidden_size, epsilon=eps, **factory)
        self.attn = GPTAttention(config, **factory)
        self.ln2 = LayerNorm(config.hidden_size, epsilon=eps, **factory)
        self.mlp = GPTMLP(config, **factory)

    def forward(self, x: torch.Tensor, cache: DecodeCache
                ) -> Tuple[torch.Tensor, DecodeCache]:
        h, cache = self.attn(self.ln1(x), cache)
        x = x + h
        return x + self.mlp(self.ln2(x)), cache


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.max_position = config.max_position_embeddings
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **factory)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, **factory)

    def forward(self, input_ids: torch.Tensor, pos: torch.Tensor
                ) -> torch.Tensor:
        l = input_ids.shape[1]
        ids = pos.to(torch.int64)[:, None] + torch.arange(
            l, dtype=torch.int64, device=input_ids.device)[None, :]
        ids = torch.clamp(ids, max=self.max_position - 1)
        return self.word_embeddings(input_ids) + \
            self.position_embeddings(ids)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **factory):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, **factory)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **factory)

    def forward(self, input_ids: torch.Tensor, caches: List[DecodeCache]
                ) -> Tuple[torch.Tensor, List[DecodeCache]]:
        x = self.embeddings(input_ids, caches[0].pos)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer(x, cache)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """GPT with the tied LM head. Built on `device` (default "cuda",
    which raises without CUDA) and initialised from `seed` as the JAX
    package does: N(0, initializer_range) for Linear weights and
    embeddings, zero biases, LayerNorm weight 1 and bias 0."""

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self.init_weights(seed)

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
        return F.linear(h, self.gpt.embeddings.word_embeddings.weight)

    def forward(self, input_ids: torch.Tensor,
                caches: Optional[List[DecodeCache]] = None):
        """input_ids [b, l] -> logits [b, l, V]; with `caches`, returns
        (logits, advanced caches). Without caches every row starts at
        position 0 with all l tokens live, in a fresh one-shot cache."""
        if caches is None:
            h, _ = self.gpt(input_ids, self._one_shot_caches(*input_ids.shape))
            return self.lm_head(h)
        h, caches = self.gpt(input_ids, caches)
        return self.lm_head(h), caches

    def _one_shot_caches(self, b: int, l: int) -> List[DecodeCache]:
        n_layers, n_kv, hd = self._decode_cache_spec()
        ps = _ONE_SHOT_PAGE
        mp = -(-l // ps)
        dev = self.device
        table = (1 + torch.arange(b * mp, dtype=torch.int32, device=dev)
                 ).view(b, mp)
        pos = torch.zeros(b, dtype=torch.int32, device=dev)
        q_len = torch.full((b,), l, dtype=torch.int32, device=dev)
        shape = (1 + b * mp, ps, n_kv, hd)
        return [DecodeCache(torch.zeros(shape, dtype=self.dtype, device=dev),
                            torch.zeros(shape, dtype=self.dtype, device=dev),
                            pos, table, q_len)
                for _ in range(n_layers)]

    def _decode_cache_spec(self) -> Tuple[int, int, int]:
        cfg = self.config
        return (cfg.num_hidden_layers, cfg.num_attention_heads,
                cfg.hidden_size // cfg.num_attention_heads)
