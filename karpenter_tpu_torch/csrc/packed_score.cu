// Packed score reduction of the hierarchical price loop, for Hopper (sm_90a).
//
// Replaces: karpenter_tpu/solver/hierarchy.py::_pallas_score (the repo's one
// Pallas kernel, pl.pallas_call at hierarchy.py:388, wrapped by
// packed_scan_scores).
//
// Computes, for every row g of an int8 feasibility matrix f[G, C] and a bf16
// price row p[C]:
//     cost[g] = min_c (f[g, c] > 0 ? float(p[c]) : 3.0e38f)
//     idx[g]  = the FIRST c attaining cost[g]
// An all-infeasible row gives (3.0e38f, 0) — every column ties at the
// sentinel and the first one wins, exactly the Pallas kernel's
// min-then-min-matching-column rule.
//
// Bound: it reads G*C + 2*C bytes and writes 8*G.  At the hierarchical
// solve's shape (G=40, C=425) that is about 18 KB, well under a microsecond
// at 3.35 TB/s, so the kernel is bound by its launch, not by bytes or
// operations.  The design is therefore the simple one: one warp per row,
// each lane striding over the columns (neighbouring lanes read neighbouring
// bytes) and keeping its own (cost, index) pair, then a shuffle reduction
// in which the lower cost wins and, on equal cost, the lower index.  The
// ragged edge is masked by the loop bound, so nothing is padded (the Pallas
// kernel padded to (32, 128) tiles).  A row whose f or p holds NaN is not a
// case the caller produces (prices are finite or the 3.0e38 sentinel).
//
// Plain C interface, loaded with ctypes: the launcher takes device pointers
// and the caller's stream, launches, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kInfeasible = 3.0e38f;

__global__ void __launch_bounds__(kThreads)
packed_score_kernel(const int8_t* __restrict__ f,
                    const __nv_bfloat16* __restrict__ price,
                    float* __restrict__ cost,
                    int32_t* __restrict__ idx,
                    int G, int C) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= G) return;  // uniform across the warp: the row is per warp

  const int8_t* frow = f + static_cast<size_t>(row) * C;
  // +inf / INT_MAX start: the first visited column always replaces it, so
  // a lane that sees only infeasible columns reports (3.0e38, its first c)
  float best = __int_as_float(0x7f800000);
  int best_i = 0x7fffffff;
  for (int c = lane; c < C; c += 32) {
    const float v = frow[c] > 0 ? __bfloat162float(price[c]) : kInfeasible;
    if (v < best) {  // strict: within a lane c only grows, first c wins
      best = v;
      best_i = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ob < best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (lane == 0) {
    cost[row] = best;
    idx[row] = best_i;
  }
}

}  // namespace

extern "C" int packed_score_launch(const void* f, const void* price,
                                   void* cost, void* idx, int G, int C,
                                   void* stream) {
  if (G <= 0 || C <= 0) return 0;
  const int blocks = (G + kRowsPerBlock - 1) / kRowsPerBlock;
  packed_score_kernel<<<blocks, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(f),
      static_cast<const __nv_bfloat16*>(price), static_cast<float*>(cost),
      static_cast<int32_t*>(idx), G, C);
  return static_cast<int>(cudaGetLastError());
}
