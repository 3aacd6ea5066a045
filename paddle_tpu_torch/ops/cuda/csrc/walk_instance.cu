// One instantiation of the walk's dispatch for one dtype of q's
// (`ring_dispatch_t` in paged_walk.cuh: the ring walk kernel of K6/K7, K9
// and K10 at every head dim and piece length it takes), compiled on its
// own:
//
//   nvcc ... -c -DPTT_WALK_PHASE1=0|1 -DPTT_WALK_MASKED=0|1
//            -DPTT_WALK_DTYPE=0|1|2 walk_instance.cu
//
// (the dtype codes of common.cuh: f32, bf16, f16). `_build.build()` links
// each walk library's own file, compiled with PTT_WALK_EXTERN, with the
// instantiations it calls: ragged and decode (0, 0) and (0, 1), grouped
// (1, 0) and (0, 0), each at the three dtypes and compiled with the
// PTT_WALK_* settings the library's file defines (decode's
// PTT_WALK_Q_REGS 0). The kernels and their launches are those the
// library's file would instantiate itself.
#define PTT_WALK_INSTANCE
#include "paged_walk.cuh"

#if PTT_WALK_DTYPE == 0
#define PTT_WALK_T float
#elif PTT_WALK_DTYPE == 1
#define PTT_WALK_T __nv_bfloat16
#elif PTT_WALK_DTYPE == 2
#define PTT_WALK_T __half
#else
#error "PTT_WALK_DTYPE must be 0 (f32), 1 (bf16) or 2 (f16)"
#endif

namespace ptt {
namespace walk {
template int ring_dispatch_t<PTT_WALK_PHASE1 != 0, PTT_WALK_MASKED != 0,
                             PTT_WALK_T>(const Args&, cudaStream_t);
}  // namespace walk
}  // namespace ptt
