"""The paired paged KV write (K8 writing K and V in one launch) on the
CPU, held against the JAX package.

The JAX megakernel and the fp8 cache write K and V with two
`paged_scatter` calls; the port makes one K8 launch for both on the card
(`paged_scatter_kernel_pair`, `paged_scatter_pair`), and on the CPU their
plain versions write each pool as `paged_scatter_reference` does. Here
both pairs' plain versions against two JAX `paged_scatter` calls, into a
bf16 pool and an e4m3 pool (at 300x the scale, so many values are
clipped to +-448), byte for byte outside the trash page 0 (which of
several writes to one trash slot stays is unspecified on both sides).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

# pool dtype -> (torch dtype, numpy/JAX dtype)
POOLS = {"bf16": (torch.bfloat16, ml_dtypes.bfloat16),
         "e4m3": (tpa.FP8_DTYPE, ml_dtypes.float8_e4m3fn)}


def _case(seed, upd_dtype, b=5, l=7, hkv=3, d=16, ps=8, mp=4):
    """K and V updates [b, l, hkv, d] of `upd_dtype` (numpy f32 values
    already rounded to it), positions that reach past some rows' windows
    (those tokens go to the trash page) and shuffled page tables."""
    rs = np.random.RandomState(seed)
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        b, mp)
    pos = np.array([0, 3, 8, mp * ps - 4, 17], np.int32)[:b]
    upd = [torch.from_numpy(rs.randn(b, l, hkv, d).astype(np.float32) * 300)
           .to(upd_dtype) for _ in range(2)]
    return upd, pos, table, (n_pages, ps, hkv, d)


def _bytes(pool):
    if isinstance(pool, torch.Tensor):
        return (pool.view(torch.uint8) if pool.dtype == tpa.FP8_DTYPE
                else pool.view(torch.int16)).numpy()
    pool = np.asarray(pool)
    return pool.view(np.uint8 if pool.itemsize == 1 else np.int16)


@pytest.mark.parametrize("upd_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", list(POOLS))
def test_pair_plain_versions_equal_two_jax_writes(pool, upd_dtype):
    tdt, jdt = POOLS[pool]
    (ku, vu), pos, table, shape = _case(3, upd_dtype)
    zeros = lambda: torch.zeros(shape, dtype=torch.uint8).view(tdt) \
        if tdt == tpa.FP8_DTYPE else torch.zeros(shape, dtype=tdt)
    tpos, ttab = torch.from_numpy(pos), torch.from_numpy(table)
    jpos, jtab = jnp.asarray(pos), jnp.asarray(table)
    want = [jpa.paged_scatter(jnp.zeros(shape, jdt),
                              jnp.asarray(u.float().numpy()).astype(
                                  ml_dtypes.bfloat16 if upd_dtype ==
                                  torch.bfloat16 else np.float32),
                              jpos, jtab) for u in (ku, vu)]
    for pair in (tpa.paged_scatter_kernel_pair, tpa.paged_scatter_pair):
        got = pair(zeros(), zeros(), ku, vu, tpos, ttab)
        for g, w in zip(got, want):
            assert g.dtype == tdt
            np.testing.assert_array_equal(_bytes(g)[1:], _bytes(w)[1:])
    # the pair writes what the single writes write
    for upd, g in zip((ku, vu), got):
        one = tpa.paged_scatter_kernel(zeros(), upd, tpos, ttab)
        np.testing.assert_array_equal(_bytes(one)[1:], _bytes(g)[1:])
