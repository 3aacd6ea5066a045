"""paddle_tpu_torch.serving: continuous-batching inference over the
paged KV pool (counterpart of `paddle_tpu.serving`).

`ServingEngine` runs the unified ragged prefill+decode step with the
radix prefix cache; see `serving/engine.py` for what is and is not
ported yet. The port's defaults differ from the JAX engine's until the
grouped walk (K10) and the host swap tier land: grouped=False and
preempt=False.
"""
from .engine import ServingEngine, unified_forward
from .errors import QueueFull, ServingError
from .metrics import ServingMetrics
from .paging import PagePool, TRASH_PAGE, pages_needed
from .prefix import PrefixGrant, RadixPrefixCache
from .request import Request, RequestOutput, RequestState, SamplingParams
from .scheduler import Scheduler

__all__ = ["ServingEngine", "unified_forward", "QueueFull", "ServingError", "ServingMetrics",
           "PagePool", "TRASH_PAGE", "pages_needed", "PrefixGrant",
           "RadixPrefixCache", "Request", "RequestOutput", "RequestState",
           "SamplingParams", "Scheduler"]
