"""paddle_tpu_torch.serving: continuous-batching inference over the
paged KV pool (counterpart of `paddle_tpu.serving`).

`ServingEngine` runs the unified ragged prefill+decode step (or, with
`unified=False` / PADDLE_TPU_UNIFIED_STEP=off, the legacy alternating
prefill-chunk and decode step) with the JAX engine's defaults: the radix prefix cache, the grouped walk (K10),
overload preemption and a host tier of `num_pages - 1` pages, under the
same gates (`PADDLE_TPU_GROUPED_ATTN`, `PADDLE_TPU_PREEMPT`). See
`serving/engine.py` for what is not ported yet. The pools hold the
model's dtype, int8 codes with scales or float8 e4m3 (`kv_dtype`, gate
`PADDLE_TPU_KV_DTYPE`, `resolve_kv_dtype`). Multi-tenant LoRA adapters
(`serving.adapters`, gate `PADDLE_TPU_ADAPTERS`) and the decode
megakernel (gate `PADDLE_TPU_MEGAKERNEL`) run on the unified step.
"""
from .adapters import (ADAPTER_PROJS, BASE_ADAPTER, AdapterStore,
                       LoRAWeights, make_random_lora, resolve_adapters_flag)
from .engine import (KV_DTYPE_MODES, ServingEngine, legacy_forward,
                     resolve_grouped_flag, resolve_kv_dtype,
                     resolve_preempt_flag, resolve_unified_flag,
                     unified_forward)
from .errors import DeadlineExceeded, EngineClosed, QueueFull, ServingError
from .metrics import ServingMetrics
from .paging import (HostPagePool, PagePool, TRASH_PAGE, chunk_bucket,
                     pages_needed)
from .prefix import (PrefixGrant, RadixPrefixCache,
                     resolve_prefix_cache_flag, shared_prefix_groups)
from .request import Request, RequestOutput, RequestState, SamplingParams
from .scheduler import Scheduler

__all__ = ["ServingEngine", "unified_forward", "legacy_forward",
           "resolve_grouped_flag", "resolve_preempt_flag",
           "resolve_unified_flag", "resolve_kv_dtype", "KV_DTYPE_MODES",
           "resolve_prefix_cache_flag",
           "AdapterStore", "LoRAWeights", "make_random_lora",
           "resolve_adapters_flag", "BASE_ADAPTER", "ADAPTER_PROJS",
           "QueueFull", "ServingError", "EngineClosed", "DeadlineExceeded",
           "ServingMetrics", "PagePool", "HostPagePool", "TRASH_PAGE",
           "pages_needed", "chunk_bucket", "PrefixGrant", "RadixPrefixCache",
           "shared_prefix_groups", "Request", "RequestOutput",
           "RequestState", "SamplingParams", "Scheduler"]
