"""The hand-written CUDA kernels against their plain versions, on the
card. Every test here needs CUDA and `nvcc` and is marked `cuda`; without
a card it skips. Run them on the GPU machine with
`python -m pytest tests/test_torch_cuda_kernels.py -q`.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import layer_norm as tln
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

pytestmark = pytest.mark.cuda

# kernel vs plain version: f32 differs by summation order only; bf16 by
# the rounding of the output (the plain version rounds the same f32
# values, so mostly 0 or 1 ulp)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(512, 768), (7, 256), (3, 1000)])
def test_layer_norm_kernel(cuda, dtype, rows, cols):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(rows, cols, generator=g, device=cuda) * 2 + 1).to(dtype)
    w = torch.randn(cols, generator=g, device=cuda).to(dtype)
    b = torch.randn(cols, generator=g, device=cuda).to(dtype)
    before = tln.LAUNCHES
    y = tln.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert tln.LAUNCHES == before + 1
    torch.testing.assert_close(y.float(),
                               tln.layer_norm_reference(x, w, b, 1e-5).float(),
                               **TOL[dtype])


def _mixed_batch(cuda, dtype, h, hkv, d=64, ps=16, lq=32, seed=0):
    rs = np.random.RandomState(seed)
    b, mp = 6, 8
    n_pages = 1 + b * mp
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    pos = np.array([0, 15, 16, 47, 0, 90], np.int32)
    q_len = np.array([0, 1, 1, 5, 32, 32], np.int32)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        cuda, dtype)
    return (mk(b, lq, h, d), mk(n_pages, ps, hkv, d), mk(n_pages, ps, hkv, d),
            *(torch.from_numpy(a).to(cuda) for a in (table, pos, q_len)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(12, 12), (12, 6)])
def test_ragged_paged_attention_kernel(cuda, dtype, h, hkv):
    args = _mixed_batch(cuda, dtype, h, hkv)
    before = tpa.LAUNCHES
    out = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1
    ref = tpa.ragged_attention_reference(*args)
    q_len = args[5].cpu()
    live = torch.arange(out.shape[1])[None, :] < q_len[:, None]
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float().cpu()[live],
                               ref.float().cpu()[live], **TOL[dtype])


def test_engine_tokens_on_the_card_equal_the_cpu(cuda):
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, size=n).astype(np.int64)
               for n in (5, 11, 17, 8)]
    tokens = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu")
        model.to(dev)
        eng = ServingEngine(model, device=dev, num_slots=4, max_len=64,
                            page_size=8, chunk_len=8)
        tln.reset_launches()
        tpa.reset_launches()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        tokens[str(dev)] = [r.token_ids for r in res]
        if dev is cuda:
            steps = eng.metrics.unified_steps
            assert tpa.LAUNCHES == 2 * steps
            assert tln.LAUNCHES == 5 * steps
    assert tokens["cpu"] == tokens[str(cuda)]
