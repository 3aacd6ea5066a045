// K11: the paged LoRA delta for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_lora_paged_kernel,
// launched from lora_delta_paged (the decode megakernel's LoRA prologue
// for the q, k and v projections, and the o-projection's delta after
// attention). Each row gathers its own adapter page from the shared pools:
//
//   x [B, W, IN]; a_pool [P, IN, R]; b_pool [P, R, OUT] (all of x's dtype
//   T: f32, bf16 or f16); apage [B] int32 (page 0 is the all-zero base
//   page); ascale [B] f32. out[b] = ((x[b] . A[p]) . B[p]) * scale[b],
//   p = apage[b], in T, rounded at the TPU kernel's points: t = x . A
//   (f32 sums) rounded to T; d = t . B (f32 sums) rounded to T; then
//   d * T(scale[b]) rounded to T. Page 0 or scale 0 gives exactly 0.
//
// What bounds it: bytes. At the serving step (B 16, W 32, IN = OUT = 768,
// R 8) it reads x and writes out (about 0.8 MB each in bf16) and one
// 24 KB A/B page pair per row, for 2 * W * R * (IN + OUT) flops a row:
// a few flops a byte. In practice the launch and one chain of dependent
// steps (copy in, the two products, copy out) set its time.
//
// Design. The TPU kernel streamed row b's page through VMEM once and ran
// both products on the MXU. Here a thread-block cluster of nc blocks
// (at most 8, so that B * nc covers the 132 SMs) owns (row b, up to 64
// positions of it):
// - t = x . A is computed once per row: block c of the cluster sums the
//   c-th slice of IN (whole 16-wide k-steps) for every position and rank
//   into an f32 partial, and pushes it from its registers into row c of
//   every block's [nc] partials with st.async over distributed shared
//   memory; the stores complete the transaction of the receiving block's
//   mbarrier, so a block waits for exactly the bytes it receives, and no
//   cluster barrier stands between the products (one, arrived at the
//   start, covers the mbarriers' initialisation). Every block then adds
//   the nc partials in rank order 0 .. nc-1, so every block holds the
//   same f32 t, rounds it to T, and no block recomputes another's slice.
//   Fixed-order sums and no atomics: the same bits on every run. (Pulling
//   the partials after a cluster barrier, with a second barrier so that
//   no block exits while another reads it, was slower on the H100;
//   `python -m paddle_tpu_torch.ops.cuda.lora_sweep` times the steps.)
// - Block c then computes d and the output for the c-th tile of OUT.
// - In bf16/f16 both products run on the tensor cores with mma.sync
//   m16n8k16 (f32 accumulators): t is [W x IN] . [IN x R], d is
//   [W x R] . [R x OUT]. Not wgmma: its tiles are 64 rows, and W <= 32
//   at the serving step. R is walked in pieces of 16, as IN and OUT are
//   walked in pieces of 256: t's columns are summed a group of ranks at a
//   time (all of R in one group up to 64 ranks at 64 positions; each
//   column's sums in the same order whatever the group), and d sums over
//   R in k-steps of 16, one mma after another into its f32 accumulator,
//   in rank order; at R <= 16 that is one k-step, the launch of ranks
//   1-16. R past a multiple of 16 and the ragged edges of W, IN and OUT
//   are padded with zeros in shared memory, and zeros add exactly
//   nothing. Where a large rank's tiles would not fit shared memory, a
//   cluster takes fewer positions, then smaller pieces of IN and OUT,
//   then fewer blocks (`make_plan`). The x and B tiles feed ldmatrix (A
//   page and B slab transposed on the load), with rows padded to an odd
//   number of 16-byte units so a load hits distinct banks.
// - The f32 lane keeps f32 FMAs on the CUDA cores (no TF32: its rule is
//   1e-5): the same cluster, slices and rank-order combine; a thread per
//   (position, rank) of a group sums its slice in order, a thread per four
//   output columns sums over all the ranks in order.
// - Every tile comes in by cp.async, 16 bytes a thread, where the rows
//   are 16-byte aligned (IN, OUT and, for the A page, R a multiple of the
//   16-byte vector); the x and A tiles and the B tile are two commit
//   groups, so the B tile lands while t is computed. Elsewhere the tiles
//   are loaded element by element into the same layouts. The bf16/f16
//   output goes through shared memory and leaves in 16-byte stores.
// - Rounding points: t rounded to T once (after the combine), d rounded
//   to T, then __fmul_rn by T(scale) rounded to T (__float2bfloat16, as
//   layer_norm.cu rounds), so no FMA contracts across a rounding point.
// IN and OUT larger than one tile (256) are walked in pieces, so any
// shape the JAX op takes fits shared memory, at every rank up to about
// 1,400 (f32; 1,536 in bf16/f16 at IN = OUT = 768). The page id is
// clamped into the pool.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSMs = 132;        // blocks wanted in flight
constexpr int kMaxRows = 64;     // positions a cluster
constexpr int kPiece = 256;      // IN (OUT) elements a staged tile
constexpr int kRankStep = 16;    // one k-step of d: R is walked in these
constexpr int kTasksMax = 32;    // t's warp tasks of a group: 4 a warp
constexpr int kSumsMax = 4;      // t's f32 sums of a group a thread carries
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~15; }
// a row of n 16-bit elements (n a multiple of 8) padded to an odd number
// of 16-byte units: 8 rows read by ldmatrix hit distinct banks
__host__ __device__ inline int odd_units(int n) {
  return n + ((n / 8) % 2 == 0 ? 8 : 16);
}

// A launch's geometry and shared memory, computed on the host for the
// launch (which passes it to the kernel) and for `ptt_lora_plan`. mma:
// the bf16/f16 lane. R is padded to rp, a multiple of kRankStep; t's
// partial is computed a group of gr ranks at a time (all of R in one group
// up to 64 ranks at 64 positions), so a warp carries at most four
// fragments (a thread at most four f32 sums). Where the tiles do not fit
// shared memory the positions a cluster takes (wc) shrink first, then the
// staged pieces of IN and OUT, then the cluster; never the rank.
struct Plan {
  int nc;        // blocks a cluster
  int wc, nwc;   // positions a cluster (a multiple of 16), clusters a row
  int ks, ct;    // IN slice and OUT tile of one block
  int kt, ctt;   // staged piece of the slice and of the tile
  int xs, bs;    // row strides (elements) of the x/out and B tiles
  int rp, gr;    // R padded to k-steps of d; ranks of a group of t
  int ts;        // row stride (elements) of t
  int ku;        // warp tasks (mma) or sums (f32) a thread carries
  size_t x_off, a_off, b_off, p_off, t_off, bar_off, total;  // bytes
};

__host__ __device__ inline Plan make_plan(bool mma, int elem, int B, int W,
                                          int IN, int R, int OUT) {
  Plan p;
  p.rp = cdiv(imax(R, 1), kRankStep) * kRankStep;
  const int nk = imax(1, cdiv(IN, 16)), nn = imax(1, cdiv(OUT, 8));
  int wc = imin(kMaxRows, cdiv(imax(W, 1), 16) * 16);
  int kcap = kPiece, ccap = kPiece, ncap = kMaxCluster;
  for (;;) {
    p.wc = wc;
    p.nwc = cdiv(W, p.wc);
    const int want = cdiv(kSMs, imax(1, B * p.nwc));
    p.nc = imin(imin(ncap, imax(1, want)), imin(nk, nn));
    p.ks = cdiv(nk, p.nc) * 16;
    p.ct = cdiv(nn, p.nc) * 8;
    p.kt = imin(p.ks, kcap);
    p.ctt = imin(p.ct, ccap);
    const int mts = p.wc / 16;
    size_t xb, ab, bb, tb;
    if (mma) {
      // (m-tile, 8-rank tile) warp tasks of one group: at most kTasksMax
      p.gr = imin(p.rp, imax(kRankStep,
                             kTasksMax / mts * 8 / kRankStep * kRankStep));
      p.ku = mts * cdiv(imin(p.gr, R), 8) <= kWarps ? 1 : kTasksMax / kWarps;
      p.xs = odd_units(imax(p.kt, p.ctt));  // x tile, then the out tile
      p.bs = odd_units(p.ctt);
      p.ts = p.rp + 8;
      xb = (size_t)p.wc * p.xs * elem;
      ab = (size_t)cdiv(imin(p.gr, R), 8) * p.kt * 8 * elem;  // [nt][kt][8]
      bb = (size_t)p.rp * p.bs * elem;                        // [rp][bs]
      tb = (size_t)p.wc * p.ts * elem;                        // t in T
    } else {
      // (position, rank) sums of one group: at most four a thread
      p.gr = imin(p.rp, imax(kRankStep, kSumsMax * kThreads / p.wc /
                                            kRankStep * kRankStep));
      p.ku = kSumsMax;
      p.xs = p.kt + 4;
      p.bs = p.ctt;
      p.ts = p.rp;
      xb = (size_t)p.wc * p.xs * 4;
      ab = (size_t)p.kt * p.gr * 4;     // [kt][gr]
      bb = (size_t)p.rp * p.bs * 4;     // [rp][bs]
      tb = (size_t)p.wc * p.ts * 4;     // t in f32
    }
    p.x_off = 0;
    p.a_off = round16(xb);
    p.b_off = p.a_off + round16(ab);
    p.p_off = p.b_off + round16(bb);
    // every block's partial, [nc][wc][rp] f32
    p.t_off = p.p_off + round16((size_t)p.nc * p.wc * p.rp * 4);
    p.bar_off = p.t_off + round16(tb);
    p.total = p.bar_off + 16;
    if (p.total <= kSmemMax) break;
    if (wc > 16) {
      wc -= 16;
    } else if (kcap > 16 || ccap > 8) {
      kcap = imax(16, kcap / 2);
      ccap = imax(8, ccap / 2);
    } else if (ncap > 1) {
      ncap /= 2;  // fewer partials: the last resort, as it costs SMs
    } else {
      break;  // too large a rank: total > kSmemMax, the launch refuses
    }
  }
  return p;
}

struct Args {
  const void* x;
  const void* a_pool;
  const void* b_pool;
  const int* apage;
  const float* ascale;
  void* out;
  int B, W, IN, R, OUT, num_pages;
  int vec;   // x, the B page and out in 16-byte chunks
  int avec;  // the A page in 16-byte chunks (R a multiple of the vector)
};

// a value rounded to T and back: the TPU kernel's `.astype(x.dtype)`
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ptt::to_f32<T>(ptt::from_f32<T>(v));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when !valid (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the address of this block's shared `p` in cluster block `rank`
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Store v (two floats with kN 2) at cluster address dst; the bytes count
// towards the transaction of the mbarrier at cluster address bar.
template <int kN>
__device__ __forceinline__ void st_push(unsigned dst, const float* v,
                                        unsigned bar) {
  if (kN == 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
        "[%0], {%1, %2}, [%3];\n" ::"r"(dst),
        "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(bar)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
        "[%0], %1, [%2];\n" ::"r"(dst),
        "r"(__float_as_uint(v[0])), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stage x[b, w0 + w, i0 + k] (w < wc, k < kt; zero past W or iend) into
// the [wc][xs] tile.
template <typename T>
__device__ void stage_x(const Args& a, const Plan& p, int b, int w0, int i0,
                        int iend, T* sx) {
  const T* x = static_cast<const T*>(a.x);
  constexpr int E = 16 / sizeof(T);
  if (a.vec) {
    const int nch = p.kt / E;
    for (int idx = threadIdx.x; idx < p.wc * nch; idx += kThreads) {
      const int w = idx / nch, k = (idx - w * nch) * E;
      const bool ok = w0 + w < a.W && i0 + k < iend;
      cp16(sx + w * p.xs + k,
           ok ? x + ((size_t)b * a.W + w0 + w) * a.IN + i0 + k : x, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < p.wc * p.kt; idx += kThreads) {
      const int w = idx / p.kt, k = idx - w * p.kt;
      const bool ok = w0 + w < a.W && i0 + k < iend;
      sx[w * p.xs + k] =
          ok ? x[((size_t)b * a.W + w0 + w) * a.IN + i0 + k]
             : ptt::from_f32<T>(0.f);
    }
  }
}

// Stage the A page's rows i0 .. i0 + kt - 1, ranks r0 .. r0 + gr - 1
// (zero past iend and past R): bf16/f16 as [nt][kt][8] (rank tile h holds
// ranks r0 + 8h .. r0 + 8h + 7, nt tiles through min(R, r0 + gr)), f32
// as [kt][gr].
template <typename T, bool kMma>
__device__ void stage_a(const Args& a, const Plan& p, const T* A, int i0,
                        int iend, int r0, int gr, T* sa) {
  constexpr int E = 16 / sizeof(T);
  const int R = a.R;
  const int nt = cdiv(imin(gr, R - r0), 8);
  const int cols = kMma ? 8 : gr;   // a staged row's width
  const int groups = kMma ? nt : gr / E;
  if (a.avec) {  // R a multiple of E: whole 16-byte chunks of a row
    for (int idx = threadIdx.x; idx < p.kt * groups; idx += kThreads) {
      const int k = idx / groups, h = idx - k * groups;
      const bool ok = i0 + k < iend && r0 + h * E < R;
      T* dst = kMma ? sa + ((size_t)h * p.kt + k) * 8 : sa + k * cols + h * E;
      cp16(dst, ok ? A + (size_t)(i0 + k) * R + r0 + h * E : A, ok);
    }
  } else {
    const int per = kMma ? nt * 8 : gr;
    for (int idx = threadIdx.x; idx < p.kt * per; idx += kThreads) {
      const int k = idx / per, r = idx - k * per;
      const bool ok = i0 + k < iend && r0 + r < R;
      const T v =
          ok ? A[(size_t)(i0 + k) * R + r0 + r] : ptt::from_f32<T>(0.f);
      if (kMma)
        sa[((size_t)(r / 8) * p.kt + k) * 8 + r % 8] = v;
      else
        sa[k * cols + r] = v;
    }
  }
}

// Stage the B page's columns c0 .. c0 + ctt - 1 (zero past cend and in
// rows R .. rp - 1) into the [rp][bs] tile.
template <typename T>
__device__ void stage_b(const Args& a, const Plan& p, const T* Bm, int c0,
                        int cend, int rp, T* sb) {
  constexpr int E = 16 / sizeof(T);
  if (a.vec) {
    const int nch = p.ctt / E;
    for (int idx = threadIdx.x; idx < rp * nch; idx += kThreads) {
      const int r = idx / nch, c = (idx - r * nch) * E;
      const bool ok = r < a.R && c0 + c < cend;
      cp16(sb + r * p.bs + c, ok ? Bm + (size_t)r * a.OUT + c0 + c : Bm,
           ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rp * p.ctt; idx += kThreads) {
      const int r = idx / p.ctt, c = idx - r * p.ctt;
      const bool ok = r < a.R && c0 + c < cend;
      sb[r * p.bs + c] =
          ok ? Bm[(size_t)r * a.OUT + c0 + c] : ptt::from_f32<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         const unsigned* b);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* c,
                                                        const unsigned* a,
                                                        const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* c, const unsigned* a,
                                                 const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// two f32 values rounded to T, packed low then high
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  return static_cast<unsigned>(__half_as_ushort(__float2half(lo))) |
         static_cast<unsigned>(__half_as_ushort(__float2half(hi))) << 16;
}

// One staged piece of t's partial: bf16/f16 on the tensor cores. Warp
// task (m-tile mt, rank tile h) runs the piece's k-steps in order into
// its accumulator fragment acc[4].
template <typename T>
__device__ __forceinline__ void t_piece_mma(const Plan& p, const T* sx,
                                            const T* sa, int mt, int h,
                                            float* acc, int lane) {
  for (int ks = 0; ks < p.kt / 16; ++ks) {
    unsigned af[4], bf[2];
    ldsm_x4(af, sx + (mt * 16 + (lane & 15)) * p.xs + ks * 16 +
                    (lane >> 4) * 8);
    ldsm_x2_trans(bf, sa + ((size_t)h * p.kt + ks * 16 + (lane & 15)) * 8);
    mma16816<T>(acc, af, bf);
  }
}

// kU: the warp tasks (mma) or sums (f32) a thread carries through one
// group of t's ranks (Plan::ku). kR16: R <= 16, one group of t's ranks and
// one k-step of d, the plan's rank geometry as compile-time constants.
template <typename T, bool kMma, int kU, bool kR16>
__global__ void __launch_bounds__(kThreads)
    lora_paged_kernel(const Args a, const Plan p) {
  const int rp = kR16 ? kRankStep : p.rp;
  const int gr = kR16 ? kRankStep : p.gr;
  const int ts = kR16 ? (kMma ? kRankStep + 8 : kRankStep) : p.ts;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int w0 = blockIdx.y * p.wc;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = min(p.wc, a.W - w0);        // live positions
  const int mts = cdiv(rows, 16);              // their m-tiles
  const int page = min(max(a.apage[b], 0), a.num_pages - 1);
  const T* A = static_cast<const T*>(a.a_pool) + (size_t)page * a.IN * a.R;
  const T* Bm = static_cast<const T*>(a.b_pool) + (size_t)page * a.R * a.OUT;
  T* sx = reinterpret_cast<T*>(smem + p.x_off);
  T* sa = reinterpret_cast<T*>(smem + p.a_off);
  T* sb = reinterpret_cast<T*>(smem + p.b_off);
  // every block's partial of t: [nc][wc][rp] f32, row c from block c
  float* sp = reinterpret_cast<float*>(smem + p.p_off);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  const int i_lo = min(a.IN, c * p.ks), i_hi = min(a.IN, (c + 1) * p.ks);
  const int c_lo = min(a.OUT, c * p.ct), c_hi = min(a.OUT, (c + 1) * p.ct);

  // The partials cross by push: every block stores its partial into each
  // block's `sp` with st.async, whose bytes complete the transaction of
  // the receiving block's mbarrier. `pushed`: the bytes one block sends
  // to each (every block of the cluster sends the same), over all groups.
  const unsigned pushed = kMma ? mts * cdiv(a.R, 8) * 32 * 4 * sizeof(float)
                               : rows * a.R * sizeof(float);
  if (tid == 0) {
    mbar_init(bar);
    mbar_expect_tx(bar, p.nc * pushed);
  }
  cluster_arrive();  // this block's barrier is ready for the others

  // group 0: the slice's first x and A piece; group 1: the tile's first
  // B piece, landing while t is computed
  stage_x<T>(a, p, b, w0, i_lo, i_hi, sx);
  stage_a<T, kMma>(a, p, A, i_lo, i_hi, 0, gr, sa);
  cp_commit();
  stage_b<T>(a, p, Bm, c_lo, c_hi, rp, sb);
  cp_commit();

  // ---- t's partial over this block's slice of IN, gr ranks at a time:
  // the steps (group gi, piece pc) in order ----
  const int n_pieces = max(1, cdiv(i_hi - i_lo, p.kt));
  const int n_groups = kR16 ? 1 : cdiv(a.R, gr);
  for (int gi = 0; gi < n_groups; ++gi) {
    const int r0 = gi * gr;
    const int grn = min(gr, a.R - r0);  // ranks of this group
    const int nt = cdiv(grn, 8);        // their 8-rank tiles
    float acc[kU][4] = {};  // mma: a fragment a task; f32: acc[u][0]
    for (int pc = 0; pc < n_pieces; ++pc) {
      if (gi == 0 && pc == 0)
        cp_wait<1>();
      else
        cp_wait<0>();
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if constexpr (kMma) {
          // warp task (m-tile, rank tile) = (task / nt, task % nt)
          const int task = warp + u * kWarps;
          const int mt = task / nt, h = task - mt * nt;
          if (mt < mts) t_piece_mma<T>(p, sx, sa, mt, h, acc[u], lane);
        } else {
          // a thread per (position, rank), the slice's terms in order
          const int idx = u * kThreads + tid;
          if (idx < rows * grn) {
            const int w = idx / grn, r = idx - w * grn;
            const float* xr = reinterpret_cast<const float*>(sx) + w * p.xs;
            const float* ar = reinterpret_cast<const float*>(sa) + r;
            float v = acc[u][0];
            for (int k = 0; k < p.kt; ++k)
              v = fmaf(xr[k], ar[k * gr], v);
            acc[u][0] = v;
          }
        }
      }
      // the next step's tiles: the next piece, or the next group's first
      const bool last = pc + 1 == n_pieces;
      if (!last || gi + 1 < n_groups) {
        __syncthreads();  // every warp is done with this step's tiles
        const int i0 = i_lo + (last ? 0 : pc + 1) * p.kt;
        if (n_pieces > 1) stage_x<T>(a, p, b, w0, i0, i_hi, sx);
        stage_a<T, kMma>(a, p, A, i0, i_hi, last ? r0 + gr : r0, gr,
                         sa);
        cp_commit();
      }
    }
    // ---- this group's partials pushed to every block of the cluster ----
    if (gi == 0) cluster_wait();  // every block's barrier is initialised
    for (int k = 0; k < p.nc; ++k) {
      const unsigned rbar = cluster_addr(bar, k);
      float* mine = sp + (size_t)c * p.wc * rp;  // row c of [nc]
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if constexpr (kMma) {
          const int g = lane >> 2, q = lane & 3;
          const int task = warp + u * kWarps;
          const int mt = task / nt, h = task - mt * nt;
          if (mt < mts) {
            const float* t0 = mine + (mt * 16 + g) * rp + r0 + h * 8 + 2 * q;
            st_push<2>(cluster_addr(t0, k), acc[u], rbar);
            st_push<2>(cluster_addr(t0 + 8 * rp, k), acc[u] + 2, rbar);
          }
        } else {
          const int idx = u * kThreads + tid;
          if (idx < rows * grn) {
            const int w = idx / grn, r = idx - w * grn;
            st_push<1>(cluster_addr(mine + w * rp + r0 + r, k), acc[u],
                       rbar);
          }
        }
      }
    }
  }
  mbar_wait(bar, 0);  // every block's partial has landed here

  // ---- t: the partials added in rank order, rounded to T ----
  // (entries no block pushed, past R or past the live m-tiles, are never
  // read as t: ranks >= R are set to 0, and d runs on the live m-tiles)
  for (int idx = tid; idx < p.wc * rp / 4; idx += kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < p.nc; ++k) {
      const float4 pk = reinterpret_cast<const float4*>(
          sp + (size_t)k * p.wc * rp)[idx];
      v = make_float4(v.x + pk.x, v.y + pk.y, v.z + pk.z, v.w + pk.w);
    }
    const int w = idx / (rp / 4), r = (idx % (rp / 4)) * 4;
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kMma)   // [wc][ts] in T, ranks >= R exactly 0
        reinterpret_cast<T*>(smem + p.t_off)[w * ts + r + e] =
            ptt::from_f32<T>(r + e < a.R ? vv[e] : 0.f);
      else                  // [wc][rp] in f32
        reinterpret_cast<float*>(smem + p.t_off)[w * ts + r + e] = vv[e];
    }
  }
  __syncthreads();

  // ---- d = t . B, the scale, out: the tile of OUT in pieces ----
  const float s = round_to<T>(a.ascale[b]);
  const int n_cpieces = max(1, cdiv(c_hi - c_lo, p.ctt));
  T* out = static_cast<T*>(a.out);
  for (int pc = 0; pc < n_cpieces; ++pc) {
    const int c0 = c_lo + pc * p.ctt;
    if (pc > 0) {
      __syncthreads();  // the previous piece's B and out tiles are read
      stage_b<T>(a, p, Bm, c0, c_hi, rp, sb);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
    const int ncols = min(p.ctt, c_hi - c0);
    if constexpr (kMma) {
      const T* st = reinterpret_cast<const T*>(smem + p.t_off);
      T* so = sx;  // the x tile, free now: [wc][xs]
      const int g = lane >> 2, q = lane & 3;
      const int nts = cdiv(ncols, 8);
      for (int task = warp; task < mts * nts; task += kWarps) {
        const int mt = task / nts, nt = task - mt * nts;
        // d sums over R in k-steps of 16, in rank order
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int r0 = 0; r0 < rp; r0 += kRankStep) {
          const T* t0 = st + (mt * 16 + g) * ts + r0 + 2 * q;
          unsigned af[4] = {
              *reinterpret_cast<const unsigned*>(t0),
              *reinterpret_cast<const unsigned*>(t0 + 8 * ts),
              *reinterpret_cast<const unsigned*>(t0 + 8),
              *reinterpret_cast<const unsigned*>(t0 + 8 * ts + 8)};
          unsigned bf[2];
          ldsm_x2_trans(bf, sb + (r0 + (lane & 15)) * p.bs + nt * 8);
          mma16816<T>(d, af, bf);
        }
        // d rounded to T, times the scale in T, the product rounded to T
        T* o0 = so + (mt * 16 + g) * p.xs + nt * 8 + 2 * q;
        *reinterpret_cast<unsigned*>(o0) =
            pack2<T>(__fmul_rn(round_to<T>(d[0]), s),
                     __fmul_rn(round_to<T>(d[1]), s));
        *reinterpret_cast<unsigned*>(o0 + 8 * p.xs) =
            pack2<T>(__fmul_rn(round_to<T>(d[2]), s),
                     __fmul_rn(round_to<T>(d[3]), s));
      }
      __syncthreads();
      constexpr int E = 16 / sizeof(T);
      if (a.vec) {
        const int nch = ncols / E;
        for (int idx = tid; idx < rows * nch; idx += kThreads) {
          const int w = idx / nch, k = (idx - w * nch) * E;
          *reinterpret_cast<uint4*>(
              out + ((size_t)b * a.W + w0 + w) * a.OUT + c0 + k) =
              *reinterpret_cast<const uint4*>(so + w * p.xs + k);
        }
      } else {
        for (int idx = tid; idx < rows * ncols; idx += kThreads) {
          const int w = idx / ncols, k = idx - w * ncols;
          out[((size_t)b * a.W + w0 + w) * a.OUT + c0 + k] = so[w * p.xs + k];
        }
      }
    } else {
      // a thread per (position, four columns), the ranks in order
      const float* st = reinterpret_cast<const float*>(smem + p.t_off);
      const float* sbf = reinterpret_cast<const float*>(sb);
      const int n4 = cdiv(ncols, 4);
      for (int idx = tid; idx < rows * n4; idx += kThreads) {
        const int w = idx / n4, k = (idx - w * n4) * 4;
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < a.R; ++r) {
          const float tv = st[w * ts + r];
          const float4 bv =
              *reinterpret_cast<const float4*>(sbf + r * p.bs + k);
          d.x = fmaf(tv, bv.x, d.x);
          d.y = fmaf(tv, bv.y, d.y);
          d.z = fmaf(tv, bv.z, d.z);
          d.w = fmaf(tv, bv.w, d.w);
        }
        d = make_float4(__fmul_rn(d.x, s), __fmul_rn(d.y, s),
                        __fmul_rn(d.z, s), __fmul_rn(d.w, s));
        float* o = reinterpret_cast<float*>(out) +
                   ((size_t)b * a.W + w0 + w) * a.OUT + c0 + k;
        if (a.vec && k + 4 <= ncols) {
          *reinterpret_cast<float4*>(o) = d;
        } else {
          const float v[4] = {d.x, d.y, d.z, d.w};
          for (int e = 0; e < 4 && k + e < ncols; ++e) o[e] = v[e];
        }
      }
    }
  }
}

template <typename T, bool kMma, int kU, bool kR16>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  auto kernel = lora_paged_kernel<T, kMma, kU, kR16>;
  if (p.total > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nc, p.nwc, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan for dtype T, and the launch of the instantiation it needs.
template <typename T, bool kMma>
int launch(const Args& a, cudaStream_t stream) {
  const Plan p = make_plan(kMma, sizeof(T), a.B, a.W, a.IN, a.R, a.OUT);
  if (p.total > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kU = kMma ? kTasksMax / kWarps : kSumsMax;
  if (p.rp == kRankStep)  // one group, one k-step; a thread's share of
                          // t fits one task (mma) or four sums (f32)
    return launch<T, kMma, kMma ? 1 : kSumsMax, true>(a, p, stream);
  if constexpr (kMma)
    if (p.ku == 1) return launch<T, kMma, 1, false>(a, p, stream);
  return launch<T, kMma, kU, false>(a, p, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// The launch K11 makes for these shapes, written to out[10]: blocks a
// cluster, clusters a row (each over up to 64 positions), the IN slice and
// the OUT tile of one block, dynamic shared memory bytes, the grid's
// blocks, threads a block, 1 if both products run on the tensor cores,
// the positions a cluster takes and the ranks of one group of t's
// partial. Returns cudaErrorInvalidValue for a dtype the kernel does not
// take, or a rank so large that no plan fits shared memory (past about
// 1,400).
extern "C" int ptt_lora_plan(int B, int W, int IN, int R, int OUT, int dtype,
                             int* out) {
  if (B < 1 || W < 1 || IN < 0 || OUT < 1 || R < 1 || dtype < ptt::kF32 ||
      dtype > ptt::kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = dtype != ptt::kF32;
  const Plan p = make_plan(mma, mma ? 2 : 4, B, W, IN, R, OUT);
  if (p.total > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int vals[10] = {p.nc, p.nwc, p.ks, p.ct, static_cast<int>(p.total),
                        p.nc * p.nwc * B, kThreads, mma ? 1 : 0, p.wc,
                        p.gr};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// x [B, W, IN], a_pool [P, IN, R], b_pool [P, R, OUT], out [B, W, OUT], all
// of `dtype` and contiguous; apage [B] int32; ascale [B] f32; R >= 1.
extern "C" int ptt_lora_delta_paged(const void* x, const void* a_pool,
                                    const void* b_pool, const void* apage,
                                    const void* ascale, void* out, int B,
                                    int W, int IN, int R, int OUT,
                                    int num_pages, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || W == 0 || OUT == 0) return 0;
  if (R < 1 || num_pages < 1 || IN < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.a_pool = a_pool;
  a.b_pool = b_pool;
  a.apage = static_cast<const int*>(apage);
  a.ascale = static_cast<const float*>(ascale);
  a.out = out;
  a.B = B;
  a.W = W;
  a.IN = IN;
  a.R = R;
  a.OUT = OUT;
  a.num_pages = num_pages;
  const int E = dtype == ptt::kF32 ? 4 : 8;  // elements a 16-byte chunk
  a.vec = IN % E == 0 && OUT % E == 0 && aligned16(x) && aligned16(b_pool) &&
          aligned16(out);
  a.avec = R % E == 0 && IN * R % E == 0 && aligned16(a_pool);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch<float, false>(a, s);
    case ptt::kBF16:
      return launch<__nv_bfloat16, true>(a, s);
    case ptt::kF16:
      return launch<__half, true>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
