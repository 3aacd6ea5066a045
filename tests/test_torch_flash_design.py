"""The flash kernels' two designs, on the CPU: which design each dtype and
head dim takes, the ctypes mirror of the kernels' `Params`, and the
per-element allowance the card checks grant the tensor-core design for
rounding P_eff and dS to the operand dtype.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

CU = (_build.CSRC / "flash_attention.cu").read_text()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_16_bit_flash_takes_the_tensor_cores(dtype, d):
    # K3, K4 and K5 at every head dim (K5's split lane at 256)
    assert tfa.kernel_design(dtype, d) == dict.fromkeys(
        ("fwd", "dq", "dkv"), tfa.TENSOR_CORES)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_flash_stays_on_the_cuda_cores(d):
    assert tfa.kernel_design(torch.float32, d) == dict.fromkeys(
        ("fwd", "dq", "dkv"), tfa.CUDA_CORES)


def test_kernel_design_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim 32"):
        tfa.kernel_design(torch.bfloat16, 32)


def _struct_fields(src: str, name: str):
    """[(field, C type)] of `struct name { ... };` in src, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*([A-Za-z_]\w*(?:\s*,\s*\w+)*);", line)
        ctype, names = m.group(1).strip(), m.group(2)
        fields += [(n.strip(), ctype) for n in names.split(",")]
    return fields


def test_params_mirror_keeps_the_field_order_of_the_cu():
    fields = _struct_fields(CU, "Params")
    assert [n for n, _ in fields] == [f[0] for f in tfa._Params._fields_]
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const float*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int,
             "unsigned int": ctypes.c_uint, "float": ctypes.c_float}
    mirror = dict(tfa._Params._fields_)
    for n, ctype in fields:
        assert mirror[n] is kinds[ctype], (n, ctype)
    assert fields[-1] == ("design", "int")


def test_design_codes_match_the_cu_enum():
    enum = re.search(r"enum Design \{ kCudaCores = (\d), kTensorCores = "
                     r"(\d) \};", CU)
    assert (int(enum.group(1)), int(enum.group(2))) == (
        tfa._DESIGN_CODES[tfa.CUDA_CORES],
        tfa._DESIGN_CODES[tfa.TENSOR_CORES])


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, {"ptt_flash_fwd": 1, "ptt_flash_dq": 1,
                          "ptt_flash_dkv": 1}),
    (torch.float16, 256, {"ptt_flash_fwd": 1, "ptt_flash_dq": 1,
                          "ptt_flash_dkv": 1}),
    (torch.float32, 64, {"ptt_flash_fwd": 0, "ptt_flash_dq": 0,
                         "ptt_flash_dkv": 0})])
def test_the_wrapper_passes_its_design_to_each_entry(monkeypatch, dtype, d,
                                                     want):
    seen = {}

    class Lib:
        def __getattr__(self, entry):
            def call(addr, code, device, stream):
                seen[entry] = tfa._Params.from_address(addr).design
                return 0
            return call

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    for entry in want:
        p = tfa._Params()
        p.D = d
        tfa._launch(entry, p, torch.device("cuda", 0), dtype)
    assert seen == want


def _case(dtype, lq, lk, seed=0, d=32, b=2, h=2):
    rs = np.random.RandomState(seed)
    mk = lambda l: torch.from_numpy(rs.randn(b, l, h, d).astype(np.float32)
                                    ).to(dtype)
    return mk(lq), mk(lk), mk(lk), mk(lq)


def test_rounding_allowance_is_zero_in_f32():
    q, k, v, do = _case(torch.float32, 9, 12)
    assert not tfa.fwd_rounding_allowance(q, k, v, causal=True).any()
    o, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    di = tfa._row_dot(o, do)
    for a in tfa.dkv_rounding_allowance(q, k, v, lse, di, do, causal=True):
        assert a.shape == k.shape and not a.any()
    eq = tfa.dq_rounding_allowance(q, k, v, lse, di, do, causal=True)
    assert eq.shape == q.shape and not eq.any()
    assert not tfa.rounding_bound(torch.randn(5), torch.float32).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_bound_covers_one_rounding(dtype):
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(
        np.float32)) * torch.logspace(-30, 3, 4096)
    x[:3] = torch.tensor([0.0, 1e-42, -3e-8])     # zero, tiny, subnormal
    moved = (x.to(dtype).float() - x).abs()
    assert (moved <= tfa.rounding_bound(x, dtype)).all()
    assert tfa.rounding_bound(x, dtype)[0] == 0


def _emulated_k3(q, k, v, causal, bn, dropout_p=0.0, seeds=None):
    """K3's arithmetic in f32 with P_eff rounded to q's dtype relative to
    the running max of each key tile of `bn` keys, as the kernel rounds
    it."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = tfa._logits(q, k, None, None, causal, 1.0 / d ** 0.5)
    m = torch.full((b, h, lq, 1), -float("inf"))
    l = torch.zeros(b, h, lq, 1)
    o = torch.zeros(b, h, lq, d)
    for k0 in range(0, lk, bn):
        st = s[..., k0:k0 + bn]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        mu = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
        p = torch.exp(st - mu)
        alpha = torch.exp(m - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        full = torch.zeros_like(s)   # the keep mask at absolute columns
        full[..., k0:k0 + bn] = p
        pe = tfa._dropped(full, seeds, dropout_p)[..., k0:k0 + bn]
        pe = pe.to(q.dtype).float()
        o = o * alpha + pe @ v[:, k0:k0 + bn].float().permute(0, 2, 1, 3)
        m = mn
    return (o / torch.clamp(l, min=1e-30)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,dropout_p", [(False, 0.0), (True, 0.0),
                                              (True, 0.2)])
def test_fwd_allowance_bounds_the_running_max_rounding(dtype, causal,
                                                       dropout_p):
    q, k, v, _ = _case(dtype, 40, 50, seed=2)
    seeds = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    args = (None, None, seeds, causal, None, dropout_p)
    exact = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                          *args)[0]
    extra = tfa.fwd_rounding_allowance(q, k, v, *args)
    got = _emulated_k3(q, k, v, causal, bn=16, dropout_p=dropout_p,
                       seeds=seeds)
    diff = (got - exact).abs()
    assert (diff <= extra + 1e-5 * exact.abs().max()).all()
    assert diff.max() > 0     # the rounding did move o
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
    bound = u * v.float().abs().max() / (1 - dropout_p) * 1.0001
    assert extra.max() <= bound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_dkv_allowance_bounds_rounding_p_and_ds(dtype, causal):
    q, k, v, do = _case(dtype, 30, 24, seed=3)
    o, lse = tfa.flash_attention_reference(q, k, v, causal=causal)
    di = tfa._row_dot(o, do)
    args = (q, k, v, lse, di, do, None, None, None, causal, None, 0.0)
    p, ds, dof = tfa._recompute(*args)
    dk_exact = torch.einsum("bhlm,blhd->bmhd", ds, q.float())
    dv_exact = torch.einsum("bhlm,blhd->bmhd", p, dof)
    dk_round = torch.einsum("bhlm,blhd->bmhd", ds.to(dtype).float(),
                            q.float())
    dv_round = torch.einsum("bhlm,blhd->bmhd", p.to(dtype).float(), dof)
    ek, ev = tfa.dkv_rounding_allowance(*args)
    for got, want, extra in ((dk_round, dk_exact, ek),
                             (dv_round, dv_exact, ev)):
        diff = (got - want).abs()
        assert (diff <= extra + 1e-6 * want.abs().max()).all()
        assert diff.max() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_allowance_bounds_rounding_ds(dtype, causal):
    """K4 on the tensor cores rounds dS to the operand dtype before
    dS . K: the allowance bounds a hand rounding of dS, which does move
    dq."""
    q, k, v, do = _case(dtype, 30, 24, seed=4)
    o, lse = tfa.flash_attention_reference(q, k, v, causal=causal)
    di = tfa._row_dot(o, do)
    args = (q, k, v, lse, di, do, None, None, None, causal, None, 0.0)
    _, ds, _ = tfa._recompute(*args)
    exact = torch.einsum("bhlm,bmhd->blhd", ds, k.float())
    rounded = torch.einsum("bhlm,bmhd->blhd", ds.to(dtype).float(),
                           k.float())
    extra = tfa.dq_rounding_allowance(*args)
    assert extra.shape == q.shape and extra.dtype == torch.float32
    diff = (rounded - exact).abs()
    assert (diff <= extra + 1e-6 * exact.abs().max()).all()
    assert diff.max() > 0     # the rounding did move dq


def _emulated_k5_split(q, k, v, lse, di, do, causal, bq, dropout_p=0.0,
                       seeds=None):
    """The split lane of K5 (head dim 256) in f32, query tile by query
    tile of `bq` queries: P^T in f32 (what warpgroup 0 hands over), dS^T
    and P_eff^T rounded to q's dtype before dK += dS^T Q and dV +=
    P_eff^T dO, summed over the tiles."""
    b, lq, h, d = q.shape
    scale = 1.0 / d ** 0.5
    s = tfa._logits(q, k, None, None, causal, scale)
    fin = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(s - fin.view(b, h, lq, 1))           # masked: 0
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    dp_eff = tfa._dropped(dp, seeds, dropout_p)
    p_eff = tfa._dropped(p, seeds, dropout_p)
    ds = p * (dp_eff - di.view(b, h, lq, 1)) * scale
    dk = torch.zeros(b, k.shape[1], h, d)
    dv = torch.zeros_like(dk)
    for q0 in range(0, lq, bq):
        rows = slice(q0, q0 + bq)
        dk += torch.einsum("bhlm,blhd->bmhd", ds[:, :, rows].to(q.dtype)
                           .float(), q[:, rows].float())
        dv += torch.einsum("bhlm,blhd->bmhd", p_eff[:, :, rows].to(q.dtype)
                           .float(), do[:, rows].float())
    return dk, dv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,dropout_p", [(False, 0.0), (True, 0.0),
                                              (True, 0.2)])
def test_k5_split_lane_within_the_dkv_allowance(dtype, causal, dropout_p):
    """K5's head-dim-256 design, emulated on the CPU (P in f32, dS and
    P_eff rounded per query tile), agrees with flash_dkv_reference within
    dkv_rounding_allowance; with Lq > Lk causal the blind queries add
    nothing."""
    q, k, v, do = _case(dtype, 70, 50, seed=5, d=256, h=1)
    seeds = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    o, lse = tfa.flash_attention_reference(q, k, v, None, None, seeds,
                                           causal, None, dropout_p)
    di = tfa._row_dot(o, do)
    args = (q, k, v, lse, di, do, None, None, seeds, causal, None,
            dropout_p)
    exact = [t.float() for t in tfa.flash_dkv_reference(
        q.float(), k.float(), v.float(), lse, di, do.float(),
        *args[6:])]
    allow = tfa.dkv_rounding_allowance(*args)
    got = _emulated_k5_split(q, k, v, lse, di, do, causal, bq=32,
                             dropout_p=dropout_p, seeds=seeds)
    for g, want, extra in zip(got, exact, allow):
        diff = (g - want).abs()
        assert (diff <= extra + 1e-5 * want.abs().max()).all()
        assert diff.max() > 0
