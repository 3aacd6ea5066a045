"""Write `csrc/wgmma.cuh`: the `wgmma.mma_async` wrappers the
tensor-core flash kernels use, one inline-PTX function per shape.

A `wgmma` names every accumulator register of its thread in its operand
list (N / 2 of them for an m64nNk16 product), so each shape is spelled
out; this script writes them so the header need not be edited by hand.
Run from the repository root after changing the shapes:

    python -m paddle_tpu_torch.ops.cuda.gen_wgmma
"""
from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parent / "csrc" / "wgmma.cuh"
# (operand A from shared memory, N) and (operand A from registers, N)
SS_N = (32, 64, 128)
RS_N = (64, 128, 256)
TYPES = (("__nv_bfloat16", "bf16"), ("__half", "f16"))

HEAD = """\
// Warpgroup matrix products (wgmma.mma_async, sm_90a) for the
// tensor-core flash kernels. Written by ops/cuda/gen_wgmma.py; edit that
// script, not this file.
//
// ss<T, N, TB>(d, desc_a, desc_b, acc): d[64 x N] = (acc ? d : 0) +
//   A[64 x 16] . B[16 x N], A and B in shared memory (64-bit matrix
//   descriptors), A K-major, B K-major (TB 0) or MN-major (TB 1).
// rs<T, N, TB>(d, a, desc_b, acc): the same with A in registers, four
//   32-bit registers of two T each in the m64k16 fragment layout.
// d is the thread's N / 2 f32 accumulators. Each call is one wgmma;
// the caller fences (wgmma.fence), commits and waits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ptt {
namespace wg {

template <typename T, int N, int TB>
struct SS;
template <typename T, int N, int TB>
struct RS;

"""


def _regs(n: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n))


def _outs(n: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def _ss(ctype: str, ptx: str, n: int, tb: int) -> str:
    r = n // 2
    return f"""template <>
struct SS<{ctype}, {n}, {tb}> {{
  static __device__ __forceinline__ void run(float (&d)[{r}], uint64_t da,
                                             uint64_t db, int acc) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, {tb};\\n}}\\n"
        : {_outs(r)}
        : "l"(da), "l"(db), "r"(acc));
  }}
}};

"""


def _rs(ctype: str, ptx: str, n: int, tb: int) -> str:
    r = n // 2
    return f"""template <>
struct RS<{ctype}, {n}, {tb}> {{
  static __device__ __forceinline__ void run(float (&d)[{r}],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{_regs(r)}}}, {{{_regs(4, r)}}}, %{r + 4}, p, 1, 1, {tb};\\n}}\\n"
        : {_outs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }}
}};

"""


def render() -> str:
    parts = [HEAD]
    for ctype, ptx in TYPES:
        for n in SS_N:
            parts.append(_ss(ctype, ptx, n, 0))
        for n in RS_N:
            parts.append(_rs(ctype, ptx, n, 1))
    parts.append("}  // namespace wg\n}  // namespace ptt\n")
    return "".join(parts)


if __name__ == "__main__":
    OUT.write_text(render())
    print(f"wrote {OUT}")
