"""paddle_tpu_torch.serving.http: the serving engine's driver
(counterpart of `paddle_tpu.serving.http`, so far its engine driver).

`EngineDriver` gives one engine replica its own pump thread with a
thread-safe inbox, the replica-death path (`ReplicaDead`,
`ReplicaHung`, `condemn()`) and the fault injector's hooks:

    from paddle_tpu_torch.serving import ServingEngine, FaultInjector
    from paddle_tpu_torch.serving.http import EngineDriver

    drv = EngineDriver(ServingEngine(model), faults=FaultInjector())
    drv.start()
    req = drv.submit(prompt_ids)          # from any thread
    ...
    drv.drain()

The HTTP front-end itself — the completion protocol, the per-client rate
limiter, the router with its watchdog and circuit breaker, the server
and `serve()` — is not ported yet (ROADMAP.md, queue 1, item 6): of what
its modules import, the grammar and the KV fabric's engine side are
ported, and the control plane, the router and the server remain.
"""
from ..faults import FaultInjector, InjectedFault, resolve_faults
from .driver import EngineDriver, ReplicaDead, ReplicaHung

__all__ = ["EngineDriver", "ReplicaDead", "ReplicaHung", "FaultInjector",
           "InjectedFault", "resolve_faults"]
