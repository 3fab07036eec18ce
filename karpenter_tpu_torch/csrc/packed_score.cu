// Packed score reduction of the hierarchical price loop, for Hopper (sm_90a).
//
// Replaces: karpenter_tpu/solver/hierarchy.py::_pallas_score (the repo's one
// Pallas kernel, pl.pallas_call at hierarchy.py:388, wrapped by
// packed_scan_scores), and — in the fused entry — the host price math the
// reference runs before it each price iteration.
//
// One kernel template, two entries:
//
//   packed_score_launch      f int8 [G, C], p bf16 [C] -> cost f32 [G],
//                            idx i32 [G]: the Pallas kernel's function.
//   price_step_score_launch  f int8 [G, C], base f32 [C, D], prov i32 [C],
//                            mult f32 [P] -> cost f32 [G], idx i32 [G],
//                            with the price row built on the card:
//       adj[c, d] = base[c, d] >= 1e37 ? base[c, d]
//                                       : base[c, d] * mult[prov[c]]
//       p[c]      = bf16_rn(min_d adj[c, d])
//     which is the host chain price_adjusted(...)[:C].min(axis=1) followed
//     by pack_scores, byte for byte (IEEE f32 multiply rounded to nearest,
//     no contraction; round-to-nearest-even to bf16, 3.0e38 -> 0x7F62).
//
// Both compute, for every row g:
//     cost[g] = min_c (f[g, c] > 0 ? float(p[c]) : 3.0e38f)
//     idx[g]  = the FIRST c attaining cost[g]
// An all-infeasible row gives (3.0e38f, 0).  A NaN price is not a case the
// callers produce (prices are finite, +inf, or the 3.0e38 sentinel).
//
// What bounds it.  At the price loop's shape (G=40, C=425, D=6) the inputs
// are about 30 KB: a few nanoseconds of HBM time, so one call is bound by
// its launch and by the host round trips around it.  The fused entry is the
// answer to that: the feasibility, base prices and owners stay resident on
// the card, the adjusted price row is built on the chip, and one launch
// writes one [2, G] buffer that the host copies back once.  At large G
// (65,536 x 1,024 = 64 MiB of f, beyond the 50 MB L2) the kernel is bound by
// HBM bytes, with little room to spare in instruction issue: at 3.35 TB/s
// the SMs issue about 9 to 10 thread-instructions per byte of f, and each
// byte is a cell.  The design moves the bytes properly and spends few
// instructions on each:
//
// - every CTA stages the bf16 price row in shared memory once and then
//   walks rows (grid-stride, grid sized from G and the SMs' occupancy), so
//   f is the only stream;
// - a row's body is read with 16-byte loads, neighbouring lanes on
//   neighbouring 16-byte chunks; the row's unaligned head (< 16 bytes, rows
//   are not padded) and ragged tail (< 16 bytes) are read a byte per lane;
// - a lane needs the 16 prices of its chunk as two 16-byte shared loads.
//   Rows start at any byte offset mod 16, so the chunk's first column has
//   any offset mod 8; the CTA stages 8 / gcd(C, 8) copies of the row, each
//   shifted so that one of them is 16-byte aligned for every row;
// - a chunk is masked and reduced as bf16x2 pairs: the positive bytes of
//   an f word are found with three integer operations, prmt spreads each
//   verdict over its price's 16 bits, one logic op puts an infeasible cell
//   at bf16 0x7F62 (just above 3.0e38) and min.bf16x2 folds the pairs —
//   about 2.5 instructions per cell.  Below 3.0e38 that min is exact; a
//   chunk whose min is not (all its feasible prices at or above the
//   sentinel) is decided cell by cell, which happens only while the lane
//   has seen nothing cheaper;
// - a lane keeps the lowest cost and the chunk it came from, not the
//   column; after the reduction (lower cost wins, on equal cost the lower
//   column) the winning chunk's lane finds the first column at that cost,
//   once per row;
// - L lanes share a row and a warp works 32 / L rows at once, with L picked
//   from C (at least 8 chunks per lane) and widened while a small G would
//   not fill the SMs: the per-row work (head, tail, reduction, refine) is
//   shared across rows at large G, and a small G is not left to a few long
//   lanes.
//
// The staged copies need ncopy * round_up(C + 8, 8) * 2 bytes of shared
// memory, at most 227 KB: C up to 14,520 for any C, up to 116,216 when C is
// a multiple of 8.  Beyond that the price-row entry reads the prices from
// global memory a column per lane (the unstaged variant), and the
// fused entry's launcher refuses (cudaErrorInvalidValue).
//
// Plain C interface, loaded with ctypes: each launcher takes device pointers
// and the caller's stream, launches, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInfeasible = 3.0e38f;
constexpr float kSentinel = 1e37f;
constexpr uint32_t kInfPair = 0x7F627F62u;  // bf16x2 just above 3.0e38
constexpr int kRefine = 1 << 30;            // key flag: chunk start, not col
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block can have
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
// element k (0..15) of a chunk's 8 bf16x2 words, as float
__device__ __forceinline__ float elem(const uint32_t* pw, int k) {
  return (k & 1) ? bf16_hi(pw[k >> 1]) : bf16_lo(pw[k >> 1]);
}
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t sel) {
  uint32_t r;  // prmt honours the sign-replicate bit of each selector nibble
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(x), "r"(sel));
  return r;
}
__device__ __forceinline__ uint32_t min_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Lane-local merge, visiting columns in increasing order: strict < keeps
// the first column on ties.
__device__ __forceinline__ void take(float v, int key, float& best,
                                     int& bkey) {
  if (v < best) {
    best = v;
    bkey = key;
  }
}

__device__ __forceinline__ float masked(int8_t fb, float p) {
  return fb > 0 ? p : kInfeasible;
}

// The 16 masked prices of a chunk as 8 bf16x2 words, infeasible cells at
// kInfPair: f bytes b > 0 (signed) by bit tricks on 4 bytes at once, each
// byte's verdict spread over its 16-bit half by prmt's sign replicate.
__device__ __forceinline__ void mask_chunk(const uint32_t* fwd,
                                           const uint32_t* pw,
                                           uint32_t* mp) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t x = fwd[w];
    const uint32_t pos = ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) & ~x & 0x80808080u;
    const uint32_t m0 = prmt(pos, 0x9988u);
    const uint32_t m1 = prmt(pos, 0xbbaau);
    mp[2 * w] = (pw[2 * w] & m0) | (kInfPair & ~m0);
    mp[2 * w + 1] = (pw[2 * w + 1] & m1) | (kInfPair & ~m1);
  }
}

// One 16-column chunk at c0.  The bf16x2 min of the masked words is the
// chunk's exact min whenever it is below 3.0e38 (then a feasible price, and
// every infeasible cell scores above it); the lane then only records the
// chunk (key c0 | kRefine) and the first column is found once per row,
// after the reduction.  A chunk whose min is not below 3.0e38 is decided
// cell by cell, and only while the lane has nothing below 3.0e38 yet.
__device__ __forceinline__ void chunk16(const uint4 fw, const uint4 q0,
                                        const uint4 q1, int c0, float& best,
                                        int& bkey) {
  const uint32_t fwd[4] = {fw.x, fw.y, fw.z, fw.w};
  const uint32_t pw[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  uint32_t mp[8];
  mask_chunk(fwd, pw, mp);
  const uint32_t t = min_bf16x2(
      min_bf16x2(min_bf16x2(mp[0], mp[1]), min_bf16x2(mp[2], mp[3])),
      min_bf16x2(min_bf16x2(mp[4], mp[5]), min_bf16x2(mp[6], mp[7])));
  const float m = fminf(bf16_lo(t), bf16_hi(t));
  if (m < kInfeasible) {
    take(m, c0 | kRefine, best, bkey);
  } else if (best > kInfeasible) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      take(masked(static_cast<int8_t>(fwd[k >> 2] >> ((k & 3) * 8)),
                  elem(pw, k)),
           c0 + k, best, bkey);
  }
}

// The fused entry's price of candidate c (see the head note).
__device__ __forceinline__ __nv_bfloat16 adjusted_price(
    const float* __restrict__ base, const int32_t* __restrict__ prov,
    const float* __restrict__ mult, int c, int D) {
  const float m = mult[prov[c]];
  const float* row = base + static_cast<size_t>(c) * D;
  float lo = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float b = row[d];
    const float a = b >= kSentinel ? b : __fmul_rn(b, m);
    lo = d == 0 ? a : fminf(lo, a);
  }
  return __float2bfloat16_rn(lo);
}

// kLanes lanes per row, 32 / kLanes rows per warp at a time.
template <int kLanes, bool kFused>
__global__ void __launch_bounds__(kThreads)
score_kernel(const int8_t* __restrict__ f,
             const __nv_bfloat16* __restrict__ price,
             const float* __restrict__ base,
             const int32_t* __restrict__ prov,
             const float* __restrict__ mult,
             float* __restrict__ cost, int32_t* __restrict__ idx,
             int G, int C, int D, int gcd8, int stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_price = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kRowsPerBlock = kThreads / kLanes;

  // copy k holds price[c] at k * stride + c + fmod + k * gcd8
  const int fmod = static_cast<int>(reinterpret_cast<uintptr_t>(f) % gcd8);
  const int ncopy = 8 / gcd8;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const __nv_bfloat16 p =
        kFused ? adjusted_price(base, prov, mult, c, D) : price[c];
    for (int k = 0; k < ncopy; ++k)
      s_price[k * stride + c + fmod + k * gcd8] = p;
  }
  __syncthreads();

  const int sub = threadIdx.x & (kLanes - 1);
  const __nv_bfloat16* p0 = s_price + fmod;  // copy 0: price[c] at p0[c]
  // the loop runs over a warp's first row, so its lanes stay in it together
  for (int wrow = blockIdx.x * kRowsPerBlock +
                  (threadIdx.x >> 5) * (32 / kLanes);
       wrow < G; wrow += gridDim.x * kRowsPerBlock) {
    const int row = wrow + (threadIdx.x & 31) / kLanes;
    const bool live = row < G;
    const int8_t* frow = f + static_cast<size_t>(live ? row : 0) * C;
    const uintptr_t a = reinterpret_cast<uintptr_t>(frow);
    const int head = min(static_cast<int>((16 - (a & 15)) & 15), C);
    const int nch = live ? (C - head) >> 4 : 0;
    const int tail0 = head + (nch << 4);
    // the copy whose chunks line up with this row's 16-byte chunks
    const int off = static_cast<int>(a & 7);
    const __nv_bfloat16* pk = s_price + (off / gcd8) * stride + off;
    const uint4* fv = reinterpret_cast<const uint4*>(frow + head);

    // +inf start: the first visited column always replaces it
    float best = __int_as_float(0x7f800000);
    int bkey = 0x3fffffff;
    if (live)
      for (int c = sub; c < head; c += kLanes)
        take(masked(frow[c], __bfloat162float(p0[c])), c, best, bkey);
#pragma unroll 4
    for (int j = sub; j < nch; j += kLanes) {
      const int c0 = head + (j << 4);
      const uint4* pp = reinterpret_cast<const uint4*>(pk + c0);
      chunk16(__ldg(fv + j), pp[0], pp[1], c0, best, bkey);
    }
    if (live)
      for (int c = tail0 + sub; c < C; c += kLanes)
        take(masked(frow[c], __bfloat162float(p0[c])), c, best, bkey);

    // the row's kLanes lanes: lower cost wins, on equal cost the lower
    // column (a chunk's columns all lie past c0, before c0 + 16)
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bkey, o);
      const int pa = bkey & (kRefine - 1), pb = ok & (kRefine - 1);
      if (ob < best || (ob == best && pb < pa)) {
        best = ob;
        bkey = ok;
      }
    }
    if (!live) continue;
    int col = bkey & (kRefine - 1);
    if (bkey & kRefine) {
      // the winning chunk's lane finds its first column at the row's min
      const int j = (col - head) >> 4;
      if ((j & (kLanes - 1)) != sub) continue;
      const uint4 fw = __ldg(fv + j);
      const uint4* pp = reinterpret_cast<const uint4*>(pk + col);
      const uint4 q0 = pp[0], q1 = pp[1];
      const uint32_t fwd[4] = {fw.x, fw.y, fw.z, fw.w};
      const uint32_t pw[8] = {q0.x, q0.y, q0.z, q0.w,
                              q1.x, q1.y, q1.z, q1.w};
      uint32_t mp[8];
      mask_chunk(fwd, pw, mp);
      int first = 15;
#pragma unroll
      for (int k = 14; k >= 0; --k)
        if (elem(mp, k) == best) first = k;
      col += first;
    } else if (sub != 0) {
      continue;
    }
    cost[row] = best;
    idx[row] = col;
  }
}

// The price-row entry past the shared-memory cap: one warp per row, the
// prices read from global memory a column per lane.
__global__ void __launch_bounds__(kThreads)
score_unstaged(const int8_t* __restrict__ f,
               const __nv_bfloat16* __restrict__ price,
               float* __restrict__ cost, int32_t* __restrict__ idx, int G,
               int C) {
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); row < G;
       row += gridDim.x * (kThreads / 32)) {
    const int8_t* frow = f + static_cast<size_t>(row) * C;
    float best = __int_as_float(0x7f800000);
    int bi = 0x7fffffff;
    for (int c = lane; c < C; c += 32)
      take(masked(frow[c], __bfloat162float(price[c])), c, best, bi);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) {
      cost[row] = best;
      idx[row] = bi;
    }
  }
}

int gcd8_of(int C) {
  int g = 8;
  while (C % g) g >>= 1;
  return g;
}

int stage_stride(int C) { return (C + 8 + 7) & ~7; }

long long stage_bytes(int C) {
  return static_cast<long long>(8 / gcd8_of(C)) * stage_stride(C) * 2;
}

int sm_count() {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cache[dev] == 0)
    cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev] > 0 ? cache[dev] : 1;
}

// Blocks for rows_per_block rows each, at most what the SMs hold at once.
// The occupancy query is remembered per kernel and shared-memory size (a
// launch on the price loop's path then makes no query).
template <typename Kernel>
int grid_for(Kernel kernel, int G, int rows_per_block, int smem,
             int* cached_smem, int* cached_per_sm) {
  if (*cached_smem != smem) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    *cached_per_sm = per_sm;
    *cached_smem = smem;
  }
  const int per_sm = *cached_per_sm;
  const long long want =
      (static_cast<long long>(G) + rows_per_block - 1) / rows_per_block;
  const long long room =
      static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(want < room ? want : room);
}

template <int kLanes, bool kFused>
int launch_staged(const void* f, const void* price, const void* base,
                  const void* prov, const void* mult, void* cost, void* idx,
                  int G, int C, int D, cudaStream_t stream) {
  auto kernel = score_kernel<kLanes, kFused>;
  const int smem = static_cast<int>(stage_bytes(C));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static int cached_smem = -1, cached_per_sm = 0;
  const int blocks = grid_for(kernel, G, kThreads / kLanes, smem,
                              &cached_smem, &cached_per_sm);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(f),
      static_cast<const __nv_bfloat16*>(price),
      static_cast<const float*>(base), static_cast<const int32_t*>(prov),
      static_cast<const float*>(mult), static_cast<float*>(cost),
      static_cast<int32_t*>(idx), G, C, D, gcd8_of(C), stage_stride(C));
  return static_cast<int>(cudaGetLastError());
}

// Lanes per row: at least 8 chunks of 16 bytes per lane where the row has
// them, so the per-row work (head and tail, the reduction, one refine) is
// shared by several rows of a warp; then wider rows while the grid would
// not cover the SMs, so a small G is not left to a few long lanes.
int lanes_for(int G, int C) {
  int lanes = 4;
  while (lanes < 32 && lanes * 16 <= (C >> 4)) lanes <<= 1;
  while (lanes < 32 &&
         static_cast<long long>(G) * lanes <
             static_cast<long long>(sm_count()) * kThreads)
    lanes <<= 1;
  return lanes;
}

template <bool kFused>
int launch(const void* f, const void* price, const void* base,
           const void* prov, const void* mult, void* cost, void* idx, int G,
           int C, int D, void* stream) {
  if (G <= 0 || C <= 0) return 0;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int lanes = lanes_for(G, C);
  switch (lanes) {
    case 32:
      return launch_staged<32, kFused>(f, price, base, prov, mult, cost, idx,
                                       G, C, D, s);
    case 16:
      return launch_staged<16, kFused>(f, price, base, prov, mult, cost, idx,
                                       G, C, D, s);
    case 8:
      return launch_staged<8, kFused>(f, price, base, prov, mult, cost, idx,
                                      G, C, D, s);
    default:
      return launch_staged<4, kFused>(f, price, base, prov, mult, cost, idx,
                                      G, C, D, s);
  }
}

}  // namespace

extern "C" int packed_score_launch(const void* f, const void* price,
                                   void* cost, void* idx, int G, int C,
                                   void* stream) {
  if (stage_bytes(C) <= kMaxSmem)
    return launch<false>(f, price, nullptr, nullptr, nullptr, cost, idx, G, C,
                         0, stream);
  if (G <= 0) return 0;
  static int cached_smem = -1, cached_per_sm = 0;
  const int blocks = grid_for(score_unstaged, G, kThreads / 32, 0,
                              &cached_smem, &cached_per_sm);
  score_unstaged<<<blocks, kThreads, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(f),
      static_cast<const __nv_bfloat16*>(price), static_cast<float*>(cost),
      static_cast<int32_t*>(idx), G, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int price_step_score_launch(const void* f, const void* base,
                                       const void* prov, const void* mult,
                                       void* cost, void* idx, int G, int C,
                                       int D, void* stream) {
  if (D <= 0 || stage_bytes(C) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(f, nullptr, base, prov, mult, cost, idx, G, C, D,
                      stream);
}
