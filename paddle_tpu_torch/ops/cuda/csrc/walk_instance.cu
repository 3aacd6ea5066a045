// One instantiation of the walk's dispatch (`ring_dispatch` in
// paged_walk.cuh: the ring walk kernel of K6/K7, K9 and K10 at every
// dtype, head dim and piece length it takes), compiled on its own:
//
//   nvcc ... -c -DPTT_WALK_PHASE1=0|1 -DPTT_WALK_MASKED=0|1 walk_instance.cu
//
// `_build.build()` links each walk library's own file, compiled with
// PTT_WALK_EXTERN, with the instantiations it calls: ragged and decode
// (0, 0) and (0, 1), grouped (1, 0) and (0, 0), each compiled with the
// PTT_WALK_* settings the library's file defines (decode's
// PTT_WALK_Q_REGS 0). The kernels and their launches are those the
// library's file would instantiate itself.
#define PTT_WALK_INSTANCE
#include "paged_walk.cuh"

namespace ptt {
namespace walk {
template int ring_dispatch<PTT_WALK_PHASE1 != 0, PTT_WALK_MASKED != 0>(
    int, const Args&, cudaStream_t);
}  // namespace walk
}  // namespace ptt
