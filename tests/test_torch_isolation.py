"""The port stands alone and runs on the GPU unless told otherwise.

`paddle_tpu_torch` (and `chip_smoke.py`) import neither JAX nor anything
of the JAX package `paddle_tpu`, and its entry points default to CUDA
and raise without it instead of falling back to the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import layer_norm as tln
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"
# `import jax...`, `from paddle_tpu import ...`, `import paddle_tpu.x` —
# but not paddle_tpu_torch
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)(\.|\s|,|$)", re.M)
SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, max_position_embeddings=32)


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.convert\n"
        "import paddle_tpu_torch.serving, paddle_tpu_torch.nlp\n"
        "import paddle_tpu_torch.ops.cuda._build\n"
        "import paddle_tpu_torch.nn.functional, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.optimizer.lr\n"
        "import paddle_tpu_torch.regularizer, paddle_tpu_torch.nn.clip\n"
        "import paddle_tpu_torch.distributed.fleet.utils\n"
        "import paddle_tpu_torch.ops.cuda.flash_attention\n"
        "import paddle_tpu_torch.ops.cuda.paged_attention\n"
        "import paddle_tpu_torch.nlp.generation\n"
        "import paddle_tpu_torch.nlp.llama\n"
        "import paddle_tpu_torch.serving.engine\n"
        "import paddle_tpu_torch.serving.adapters\n"
        "import paddle_tpu_torch.serving.prefix\n"
        "import paddle_tpu_torch.serving.grammar\n"
        "import paddle_tpu_torch.serving.fabric\n"
        "import paddle_tpu_torch.serving.obs, paddle_tpu_torch.serving.slo\n"
        "import paddle_tpu_torch.serving.faults, paddle_tpu_torch.profiler\n"
        "import paddle_tpu_torch.serving.http.driver\n"
        "import paddle_tpu_torch.serving.controlplane\n"
        "import paddle_tpu_torch.serving.http.protocol\n"
        "import paddle_tpu_torch.serving.http.ratelimit\n"
        "import paddle_tpu_torch.serving.http.router\n"
        "import paddle_tpu_torch.serving.http.server\n"
        "from paddle_tpu_torch.serving.http import serve\n"
        "import paddle_tpu_torch.ops.cuda.cost\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the serving modules ported last (grammar, the KV fabric, the control
    # plane and the HTTP front end) are scanned
    http = PKG / "serving" / "http"
    assert {PKG / "serving" / "grammar.py", PKG / "serving" / "fabric.py",
            PKG / "serving" / "controlplane.py", http / "__init__.py",
            http / "protocol.py", http / "ratelimit.py", http / "router.py",
            http / "server.py"} <= set(files)
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(GPTConfig(**SMALL))
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, max_len=16, page_size=4, chunk_len=8)
    eng = ServingEngine(model, max_len=16, page_size=4, chunk_len=8,
                        device="cpu")
    assert eng.device.type == "cpu"


def test_wrappers_never_fall_back_off_the_cpu():
    x = torch.zeros(2, 64, device="meta")
    w = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tln.layer_norm(x, w, w)
    q = torch.zeros(1, 1, 2, 16, device="meta")
    pool = torch.zeros(2, 4, 2, 16, device="meta")
    i = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.ragged_paged_attention(q, pool, pool, i.view(1, 1), i, i)
    with pytest.raises(ValueError, match="no kernel"):
        tpa.ragged_paged_attention_grouped(q, pool, pool, i.view(1, 1), i,
                                           i, i, i, i)
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_decode_attention(q, pool, pool, i.view(1, 1), i)
    with pytest.raises(ValueError, match="no kernel"):
        tln.layer_norm_bwd(x, x, w)
    q4 = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_fwd(q4, q4, q4, causal=True)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_bwd(q4, q4, q4, q4, torch.zeros(2, 4), q4)
    x = torch.zeros(2, 4, 64, device="meta")
    a = torch.zeros(3, 64, 8, device="meta")
    bp = torch.zeros(3, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.lora_delta_paged(x, a, bp, i.expand(2), i.float().expand(2))
    with pytest.raises(ValueError, match="no kernel"):
        tpa.decode_greedy_argmax(torch.zeros(2, 64, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_scatter_kernel(pool, pool[:1], i, i.view(1, 1))


def test_training_defaults_to_cuda_and_raises_without_it(no_cuda):
    """The training model is built on the card unless told otherwise;
    built on the CPU on request, one train step runs there."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(GPTConfig(**SMALL))
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = tjit.compile_train_step(
        lambda ids, labels: model(ids, labels=labels), model, opt)
    ids = torch.randint(0, SMALL["vocab_size"], (2, 8))
    loss = step(ids, ids)
    assert loss.device.type == "cpu" and torch.isfinite(loss)


# options that have been ported since these cases were written: the
# engine now builds them (the pools' dtype and the scale pools' dtype)
_PORTED = {("kv_dtype", "int8"): (torch.int8, torch.float32),
           ("kv_dtype", "fp8"): (tpa.FP8_DTYPE, None),
           ("unified", False): (torch.float32, None),
           ("megakernel", True): (torch.float32, None),
           ("spec", "ngram"): (torch.float32, None),
           ("obs", True): (torch.float32, None),
           ("slo", "on"): (torch.float32, None),
           ("cost_census", "lowered"): (torch.float32, None)}
# the observability options: the engine attribute each builds and the mode
# it must hold
_LAYER = {"obs": lambda e: e.obs is not None,
          "slo": lambda e: e.slo is not None and "on",
          "cost_census": lambda e: e.census_mode}


@pytest.mark.parametrize("option,value", [
    ("kv_dtype", "int8"), ("kv_dtype", "fp8"), ("unified", False), ("mesh", "dp1mp2"),
    ("spec", "ngram"), ("megakernel", True), ("obs", True), ("slo", "on"),
    ("cost_census", "lowered")])
def test_unported_engine_options_raise(option, value, monkeypatch):
    """Every option is ported now: each (int8 and fp8 KV, the legacy
    step, the mesh, the megakernel, speculative decoding, obs, the SLO
    tracker, the cost census) builds its pools — the mesh one per shard,
    over the shard's kv heads — and the observability options serve with
    their mode on."""
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    if option == "mesh":
        monkeypatch.setenv("PADDLE_TPU_FORCE_CPU_DEVICES", "2")
        eng = ServingEngine(model, device="cpu", max_len=16, page_size=4,
                            chunk_len=8, mesh=value)
        assert eng.tp.shape == "dp1xmp2" and len(eng._pools) == 1
        for shard in eng._pools.pools:
            for k, v, ks, vs in shard:
                assert k.dtype == v.dtype == torch.float32
                assert k.shape == (eng.num_pages, eng.page_size,
                                   eng.n_kv // 2, eng.head_dim)
                assert ks is None and vs is None
        return
    if (option, value) in _PORTED:
        pool_dtype, scale_dtype = _PORTED[option, value]
        eng = ServingEngine(model, device="cpu", max_len=16, page_size=4,
                            chunk_len=8, **{option: value})
        if option in _LAYER:
            assert _LAYER[option](eng) == value
            out = eng.generate([torch.arange(1, 6)],
                               SamplingParams(max_new_tokens=6))
            assert len(out[0].token_ids) == 6
            assert eng.cost_census()["source"] == (
                value if option == "cost_census" else "model")
        else:
            got = getattr(eng, option)
            assert (got.mode if option == "spec" else got) == value
        assert len(eng._pools) == 1
        for k, v, ks, vs in eng._pools:
            assert k.dtype == v.dtype == pool_dtype
            assert k.shape == (eng.num_pages, eng.page_size, eng.n_kv,
                               eng.head_dim)
            if scale_dtype is None:
                assert ks is None and vs is None
            else:
                assert ks.dtype == vs.dtype == scale_dtype
                assert ks.shape == k.shape[:3]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(model, device="cpu", **{option: value})
