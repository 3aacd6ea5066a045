"""paddle_tpu_torch.serving: continuous-batching inference over the
paged KV pool (counterpart of `paddle_tpu.serving`).

`ServingEngine` runs the unified ragged prefill+decode step (or, with
`unified=False` / PADDLE_TPU_UNIFIED_STEP=off, the legacy alternating
prefill-chunk and decode step) with the JAX engine's defaults: the radix prefix cache, the grouped walk (K10),
overload preemption and a host tier of `num_pages - 1` pages, under the
same gates (`PADDLE_TPU_GROUPED_ATTN`, `PADDLE_TPU_PREEMPT`). See
`serving/engine.py`. The pools hold the
model's dtype, int8 codes with scales or float8 e4m3 (`kv_dtype`, gate
`PADDLE_TPU_KV_DTYPE`, `resolve_kv_dtype`). Multi-tenant LoRA adapters
(`serving.adapters`, gate `PADDLE_TPU_ADAPTERS`) and the decode
megakernel (gate `PADDLE_TPU_MEGAKERNEL`) run on the unified step, and
so does speculative decoding (`serving.spec`, gate
`PADDLE_TPU_SPEC_DECODE=off|ngram[:k]|model[:k]`): n-gram prompt lookup
or a resident draft model (`serving.draft`) drafts, greedy acceptance
verifies. The request tracer and flight recorder (`serving.obs`, gate
`PADDLE_TPU_OBS`), the SLO tracker and the cost census (`serving.slo`,
gates `PADDLE_TPU_SLO` and `PADDLE_TPU_COST_CENSUS`) are on by default, as
in the JAX engine; the engine quarantines a request that deterministically
kills its step (`PoisonedRequest`), and `serving.faults` injects such
faults. Grammar-constrained decoding (`serving.grammar`, gate
`PADDLE_TPU_GRAMMAR`), the embeddings lane (`SamplingParams(embed=True)`),
session pins (`SamplingParams(session=...)`) and the KV fabric's engine
side (`serving.fabric`: PKVF frames, prefix fingerprints, tree snapshots)
run on the unified step. `serving.http.EngineDriver` runs an engine on a
pump thread of its own, and `serving.http` fronts engines with the router
(placement, failover, mid-stream migration, the breaker and the watchdog,
the KV fabric's hand-off and warm restart) and the HTTP server (`serve`);
the fleet control plane (`serving.controlplane`, gate
`PADDLE_TPU_CONTROLPLANE`) makes placement SLO-aware, sheds
deadline-infeasible requests and resizes the fleet. Tensor-parallel
serving (`serving.tp`, gate `PADDLE_TPU_MESH=dpXmpY`) splits one engine's
pools and attention heads over mp shards.
"""
from .adapters import (ADAPTER_PROJS, BASE_ADAPTER, AdapterStore,
                       LoRAWeights, make_random_lora, resolve_adapters_flag)
from .controlplane import (ControlPlaneConfig, DeadlineInfeasible, Decision,
                           FleetController, FleetSignals,
                           parse_controlplane_spec, resolve_controlplane,
                           slo_placement_rank)
from .draft import DraftConfig, DraftEngine, make_draft_model
from .engine import (KV_DTYPE_MODES, ServingEngine, embed_forward,
                     legacy_forward, resolve_grouped_flag, resolve_kv_dtype,
                     resolve_preempt_flag, resolve_unified_flag,
                     unified_forward, verify_forward)
from .errors import (DeadlineExceeded, EngineClosed, PoisonedRequest,
                     QueueFull, RateLimited, ServingError)
from .fabric import (FabricConfig, decode_frame, encode_frame, frame_header,
                     parse_fabric_spec, prompt_fingerprints, resolve_fabric)
from .faults import FaultInjector, InjectedFault, resolve_faults
from .grammar import (ChoiceGrammar, GrammarSpec, JsonGrammar, RegexGrammar,
                      TokenGrammar, resolve_grammar_flag)
from .metrics import Histogram, ServingMetrics, prometheus_render
from .obs import (EngineObs, FlightRecorder, RequestTracer,
                  resolve_debug_flag, resolve_flight_steps, resolve_obs_flag,
                  timeline_to_chrome)
from .paging import (HostPagePool, PagePool, TRASH_PAGE, chunk_bucket,
                     pages_needed)
from .prefix import (PrefixGrant, RadixPrefixCache,
                     resolve_prefix_cache_flag, shared_prefix_groups)
from .request import Request, RequestOutput, RequestState, SamplingParams
from .scheduler import Scheduler
from .slo import (SLOConfig, SLOTracker, model_cost_census,
                  resolve_cost_census, resolve_slo_config)
from .spec import (SPEC_DECODE_ENV, SPEC_MODES, Drafter, ModelDrafter,
                   NgramDrafter, SpecConfig, resolve_spec_config)
from .tp import (ServingTP, collective_counts, parse_mesh_spec,
                 resolve_serving_mesh)

__all__ = ["ServingEngine", "unified_forward", "verify_forward",
           "legacy_forward", "embed_forward",
           "resolve_grouped_flag", "resolve_preempt_flag",
           "resolve_unified_flag", "resolve_kv_dtype", "KV_DTYPE_MODES",
           "resolve_prefix_cache_flag",
           "AdapterStore", "LoRAWeights", "make_random_lora",
           "resolve_adapters_flag", "BASE_ADAPTER", "ADAPTER_PROJS",
           "QueueFull", "ServingError", "EngineClosed", "DeadlineExceeded",
           "RateLimited", "PoisonedRequest", "FaultInjector",
           "InjectedFault", "resolve_faults",
           "EngineObs", "FlightRecorder", "RequestTracer",
           "resolve_obs_flag", "resolve_debug_flag", "resolve_flight_steps",
           "timeline_to_chrome", "SLOConfig", "SLOTracker",
           "resolve_slo_config", "resolve_cost_census", "model_cost_census",
           "ServingMetrics", "Histogram", "prometheus_render", "PagePool", "HostPagePool", "TRASH_PAGE",
           "pages_needed", "chunk_bucket", "PrefixGrant", "RadixPrefixCache",
           "shared_prefix_groups", "Request", "RequestOutput",
           "RequestState", "SamplingParams", "Scheduler",
           "SpecConfig", "NgramDrafter", "ModelDrafter", "Drafter",
           "resolve_spec_config", "SPEC_DECODE_ENV", "SPEC_MODES",
           "DraftEngine", "DraftConfig", "make_draft_model",
           "FabricConfig", "resolve_fabric", "parse_fabric_spec",
           "encode_frame", "decode_frame", "frame_header",
           "prompt_fingerprints", "TokenGrammar", "JsonGrammar",
           "ChoiceGrammar", "RegexGrammar", "GrammarSpec",
           "resolve_grammar_flag", "ControlPlaneConfig", "FleetController",
           "FleetSignals", "Decision", "DeadlineInfeasible",
           "resolve_controlplane", "parse_controlplane_spec",
           "slo_placement_rank", "ServingTP", "collective_counts",
           "parse_mesh_spec", "resolve_serving_mesh"]
