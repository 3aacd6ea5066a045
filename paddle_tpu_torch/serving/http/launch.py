"""Launch the streaming HTTP serving front end from the command line
(the port's counterpart of `scripts/serving_http_server.py`, with its
flags and start-up lines).

Builds N ServingEngine replicas over a GPT configuration (GPT-124M-sized
in bf16 on a CUDA card, tiny on the CPU; random weights from seed 0),
fronts them with the least-loaded router and serves OpenAI-style
completions until SIGTERM/SIGINT drains gracefully (stop admitting,
finish the residents, exit 0):

    python -m paddle_tpu_torch.serving.http.launch --port 8000 --replicas 2
    curl -s localhost:8000/v1/completions \\
         -d '{"prompt": [3, 14, 15, 9], "max_tokens": 8}'
    curl -s localhost:8000/metrics | head
    kill -TERM <pid>       # graceful drain

The engines read every serving gate from the environment as usual, so
PADDLE_TPU_MESH=dp1mp2 serves each replica over a two-shard mesh
(serving/tp.py; on the CPU with PADDLE_TPU_FORCE_CPU_DEVICES set).
"""
from __future__ import annotations

import argparse
import time

__all__ = ["main", "build_model"]


def build_model(on_gpu: bool):
    """The launcher's model and config: GPT-124M's widths with 2048
    positions in bf16 on the card, a 2-layer GPT of hidden 64 on the CPU
    (the JAX launcher's `serving_bench.build_model` configurations)."""
    import torch

    from ...nlp import GPTConfig, GPTForCausalLM

    if on_gpu:
        cfg = GPTConfig(vocab_size=50304, hidden_size=768,
                        num_hidden_layers=12, num_attention_heads=12,
                        max_position_embeddings=2048,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    else:
        cfg = GPTConfig(vocab_size=256, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128,
                        max_position_embeddings=256,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda" if on_gpu else "cpu",
                           dtype=torch.bfloat16 if on_gpu else None, seed=0)
    return model.eval(), cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="per-replica admission queue bound "
                    "(full -> HTTP 429)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="default per-request deadline in seconds")
    ap.add_argument("--watchdog-timeout", type=float, default=None,
                    help="condemn a replica whose pump heartbeat is "
                    "stale this long (hung-step detector); size it "
                    "ABOVE the worst-case step time incl. the kernels' "
                    "first-use build on the card. Residents of a "
                    "condemned replica migrate to survivors")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable overload preemption: a blocked "
                    "higher-priority request backpressures instead "
                    "of displacing the lowest-priority resident")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host-RAM KV tier capacity in pages "
                    "(default mirrors the device pool; 0 disables "
                    "swap — preemption then recomputes on resume)")
    ap.add_argument("--max-migrations", type=int, default=8,
                    help="per-request bound on mid-stream "
                    "migrations before the typed replica error "
                    "surfaces")
    ap.add_argument("--adapters", type=int, default=0,
                    help="register K random LoRA adapters (rank "
                    "--adapter-rank) named lora-0..lora-K-1 on every "
                    "replica — multi-tenant serving: clients pick a "
                    "tenant with the completions 'model' field "
                    "(unknown names 404)")
    ap.add_argument("--adapter-rank", type=int, default=4)
    ap.add_argument("--adapter-pages", type=int, default=8,
                    help="device adapter-pool capacity in adapters; "
                    "cold tenants load on demand, idle ones park, "
                    "pressure spills to host RAM / evicts LRU")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="SLO targets for the burn-rate tracker "
                    "(serving/slo.py), e.g. "
                    "'ttft_p99=0.5,itl_p99=0.1,goodput=0.99' — "
                    "'off' disables; default = the generous "
                    "defaults / PADDLE_TPU_SLO")
    ap.add_argument("--debug", action="store_true",
                    help="expose the /debug/state, "
                    "/debug/requests/<id> and /debug/flight "
                    "introspection endpoints (serving/obs.py) — off "
                    "by default, they carry prompt metadata; "
                    "equivalent to PADDLE_TPU_DEBUG=on")
    args = ap.parse_args(argv)

    import torch

    from .. import ServingEngine, make_random_lora
    from . import serve

    on_gpu = torch.cuda.is_available()
    model, cfg = build_model(on_gpu)
    max_len = args.max_len or (1024 if on_gpu else 128)
    chunk = args.chunk or (128 if on_gpu else 32)

    engines = [ServingEngine(model, num_slots=args.slots,
                             max_len=max_len, page_size=args.page_size,
                             chunk_len=chunk, max_queue=args.max_queue,
                             preempt=not args.no_preempt,
                             host_pages=args.host_pages,
                             adapters=args.adapters > 0 or None,
                             adapter_pages=args.adapter_pages,
                             adapter_ranks=(args.adapter_rank,),
                             slo=args.slo, device=model.device)
               for _ in range(args.replicas)]
    if args.adapters:
        # the same registration order on every replica gives the same
        # adapter ids fleet-wide (the router's model-name registry)
        import numpy as np
        h = cfg.hidden_size
        hd = h // cfg.num_attention_heads
        rng = np.random.RandomState(0)
        weights = [make_random_lora(
            cfg.num_hidden_layers, h, cfg.num_attention_heads * hd,
            cfg.num_attention_heads * hd, rank=args.adapter_rank, rng=rng,
            amp=0.1) for _ in range(args.adapters)]
        for e in engines:
            for i, w in enumerate(weights):
                e.adapters.register(f"lora-{i}", w)
    # PADDLE_TPU_FAULTS (serving/faults.py) is parsed by serve() itself
    server = serve(engines, args.host, args.port,
                   default_timeout_s=args.timeout,
                   watchdog_timeout_s=args.watchdog_timeout,
                   max_migrations=args.max_migrations,
                   debug_endpoints=args.debug or None)
    server.install_signal_handlers()
    print(f"serving {args.replicas} replica(s) of "
          f"{type(model).__name__} (vocab={cfg.vocab_size}) on "
          f"{server.url} — SIGTERM drains gracefully", flush=True)
    try:
        while server.router.healthy:
            time.sleep(0.25)
    except KeyboardInterrupt:
        server.drain()
    print("drained; exiting", flush=True)


if __name__ == "__main__":
    main()
