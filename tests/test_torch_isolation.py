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
from paddle_tpu_torch.serving import ServingEngine

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
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.ops.cuda.flash_attention\n"
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
        ServingEngine(model, max_len=16, page_size=4, chunk_len=4)
    eng = ServingEngine(model, max_len=16, page_size=4, chunk_len=4,
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
        tln.layer_norm_bwd(x, x, w)
    q4 = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_fwd(q4, q4, q4, causal=True)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_bwd(q4, q4, q4, q4, torch.zeros(2, 4), q4)


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


@pytest.mark.parametrize("option,value", [
    ("grouped", True), ("preempt", True), ("kv_dtype", "int8"),
    ("kv_dtype", "fp8"), ("unified", False), ("mesh", "dp1mp2"),
    ("spec", "ngram"), ("megakernel", True)])
def test_unported_engine_options_raise(option, value):
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(model, device="cpu", **{option: value})
