"""The hand-written CUDA kernels against their plain versions, on the
card. Every test here needs CUDA and `nvcc` and is marked `cuda`; without
a card it skips. Run them on the GPU machine with
`python -m pytest tests/test_torch_cuda_kernels.py -q`.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import layer_norm as tln
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

pytestmark = pytest.mark.cuda

# K6 against its plain version: f32 differs by summation order only;
# bf16 by the rounding of the output (the plain version rounds the same
# f32 values, so mostly 0 or 1 ulp)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}
# the other kernels against their plain versions, both computing in f32
# from the same inputs: an f32 output within F32_TOL x (1 + max|ref|)
# (summation order); a bf16 output, element by element, within BF16_ULPS
# ulps of the reference element plus F32_TOL x max|ref|
F32_TOL, BF16_ULPS = 1e-5, 2


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
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))


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


def _bf16_ulp(x):
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def _close(got, want):
    """got within F32_TOL / BF16_ULPS of want (see above), by got's
    dtype."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    ref_max = want.abs().max().item()
    if dtype == torch.bfloat16:
        allowed = BF16_ULPS * _bf16_ulp(want) + F32_TOL * ref_max
    else:
        allowed = torch.full_like(want, F32_TOL * (1.0 + ref_max))
    diff = (got - want).abs()
    assert (diff <= allowed).all(), (diff / allowed).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(4096, 768), (7, 256), (3, 1000)])
def test_layer_norm_bwd_kernel(cuda, dtype, rows, cols):
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x, dy = (mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype)
    w = mk(cols).to(dtype)
    before = tln.BWD_LAUNCHES
    got = tln.layer_norm_bwd(dy, x, w, 1e-5)
    torch.cuda.synchronize()
    assert tln.BWD_LAUNCHES == before + 1
    want = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b)


def test_layer_norm_bwd_kernel_is_bit_reproducible(cuda):
    """K2 folds its warps and blocks in a fixed order, without atomics:
    dw and db are the same bits on every run."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x, dy = (torch.randn(8192, 768, generator=g, device=cuda)
             for _ in range(2))
    w = torch.randn(768, generator=g, device=cuda)
    first = tln.layer_norm_bwd(dy, x, w, 1e-5)
    for _ in range(3):
        again = tln.layer_norm_bwd(dy, x, w, 1e-5)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_layer_norm_on_the_card_raises_what_the_kernels_cannot_take(cuda):
    """No plain fallback on the card: a bf16 input with f32 weights, or
    a width the kernels do not hold, raises."""
    from paddle_tpu_torch.nn import functional as PF
    x = torch.randn(4, 768, device=cuda, dtype=torch.bfloat16)
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    with pytest.raises(TypeError, match="share a dtype"):
        PF.layer_norm(x, 768, w, b)
    x = torch.randn(4, 8192, device=cuda)
    w, b = torch.ones(8192, device=cuda), torch.zeros(8192, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        PF.layer_norm(x, 8192, w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_on_the_card_carries_gradients(cuda, dtype):
    """The LayerNorm layer's output on the card has a grad_fn, and x,
    weight and bias get the gradients of the plain version's autograd."""
    from paddle_tpu_torch.nn import LayerNorm
    g = torch.Generator(device=cuda).manual_seed(2)
    layer = LayerNorm(768, device=cuda, dtype=dtype)
    with torch.no_grad():
        layer.weight.normal_(generator=g)
        layer.bias.normal_(generator=g)
    x = torch.randn(3, 40, 768, generator=g, device=cuda).to(dtype)
    x.requires_grad_(True)
    dy = torch.randn(3, 40, 768, generator=g, device=cuda).to(dtype)
    y = layer(x)
    assert y.grad_fn is not None
    y.backward(dy)
    xr = x.detach().clone().requires_grad_(True)
    wr = layer.weight.detach().clone().requires_grad_(True)
    br = layer.bias.detach().clone().requires_grad_(True)
    tln.layer_norm_reference(xr, wr, br, 1e-5).backward(dy)
    for got, want in ((x.grad, xr.grad), (layer.weight.grad, wr.grad),
                      (layer.bias.grad, br.grad)):
        assert got is not None and got.dtype == dtype
        _close(got, want)


def _attn_case(cuda, dtype, d, lq, lk, masks, seed=0):
    rs = np.random.RandomState(seed)
    b, h = 2, 3
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        cuda, dtype)
    q, k, v, do = mk(b, lq, h, d), mk(b, lk, h, d), mk(b, lk, h, d), \
        mk(b, lq, h, d)
    bias = kvec = None
    if masks:
        bias = torch.from_numpy(rs.randn(1, h, lq, lk).astype(np.float32)
                                ).to(cuda)
        kvec = torch.from_numpy(np.where(rs.rand(b, lk) < 0.2, -1e30, 0.0)
                                .astype(np.float32)).to(cuda)
    seeds = torch.tensor([-123456789, 987654321], dtype=torch.int32,
                         device=cuda)
    return q, k, v, do, bias, kvec, seeds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
@pytest.mark.parametrize("lq,lk,masks", [(200, 200, False), (70, 130, False),
                                         (96, 96, True)])
def test_flash_attention_kernels(cuda, dtype, d, causal, dropout_p, lq, lk,
                                 masks):
    q, k, v, do, bias, kvec, seeds = _attn_case(cuda, dtype, d, lq, lk,
                                                masks)
    args = (bias, kvec, seeds, causal, None, dropout_p)
    before = dict(tfa.LAUNCHES)
    o, lse = tfa.flash_attention_fwd(q, k, v, *args)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, *args)
    _close(o, o_ref)
    _close(lse, lse_ref)
    for got, want in zip((dq, dk, dv),
                         tfa.flash_bwd_reference(q, k, v, o, lse, do, *args)):
        assert got.dtype == dtype
        _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_sends_a_per_head_key_mask_to_the_kernels(cuda, dtype):
    """A [B, H, 1, Lk] mask rides K3-K5's bias operand, broadcast over
    the queries, and matches the plain versions fed the mask expanded to
    [B, H, Lq, Lk]."""
    from paddle_tpu_torch.nn import functional as PF
    rs = np.random.RandomState(8)
    b, l, h, d = 2, 100, 3, 64
    mk = lambda: torch.from_numpy(rs.randn(b, l, h, d).astype(np.float32)
                                  ).to(cuda, dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    mask = torch.from_numpy(rs.rand(b, h, 1, l) < 0.8).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(tfa.LAUNCHES)
    out = PF.scaled_dot_product_attention(*leaves, mask, is_causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    bias = torch.where(mask, 0.0, -1e30).expand(b, h, l, l)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, bias,
                                                   causal=True)
    _close(out, o_ref)
    want = tfa.flash_bwd_reference(q, k, v, out.detach(), lse_ref, do, bias,
                                   causal=True)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_flash_attention_reads_strided_views_in_place(cuda):
    """GPT's q, k, v are per-head interleaved views of one QKV tensor:
    the kernels read them through their strides and agree with the
    contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 130, 4, 3 * 64, generator=g, device=cuda
                      ).to(torch.bfloat16).requires_grad_(True)
    q, k, v = qkv.split(64, dim=-1)
    out = tfa.flash_attention_blhd(q, k, v, causal=True)
    out.float().square().sum().backward()
    qkv2 = qkv.detach().clone().requires_grad_(True)
    q2, k2, v2 = (t.contiguous() for t in qkv2.split(64, dim=-1))
    out2 = tfa.flash_attention_blhd(q2, k2, v2, causal=True)
    out2.float().square().sum().backward()
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    torch.testing.assert_close(qkv.grad, qkv2.grad, rtol=0, atol=0)


def test_gpt_train_steps_on_the_card_equal_the_cpu(cuda):
    """Three AdamW steps of a small f32 GPT through the kernels on the
    card give the CPU's losses (plain versions), and launch K1-K5 the
    number of times each step needs."""
    from paddle_tpu_torch import jit, optimizer
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=128,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    rs = np.random.RandomState(9)
    ids, labels = (torch.from_numpy(rs.randint(0, 256, (2, 96)))
                   for _ in range(2))
    losses = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu").to(dev)
        opt = optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.named_parameters())
        step = jit.compile_train_step(
            lambda i, l: model(i, labels=l), model, opt)
        tln.reset_launches()
        tfa.reset_launches()
        losses[str(dev)] = [step(ids, labels).item() for _ in range(3)]
        if dev is cuda:
            assert (tln.LAUNCHES, tln.BWD_LAUNCHES) == (15, 15)
            assert tfa.LAUNCHES == {"fwd": 6, "dq": 6, "dkv": 6}
    # f32 on both; summation order differs between the kernels and the
    # CPU's plain versions, and Adam passes it on
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-5)
