// Zone fills of the group step, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  karpenter_tpu/ops/masks.py's water_fill and
// skew_band_fill are jnp code that XLA fuses into the solve's one program on
// the TPU.  Run eagerly in PyTorch, each fill is a chain of about 1,100
// elementwise and reduce launches on a [rows, Z] tensor (48 bisection rounds
// of the band floor, then 40 of the water level, each about ten ops), and
// the zone-spread group step runs four of them.  This file runs one fill as
// one launch.
//
// Two entries, each a plain C launcher:
//
//   skew_band_fill_launch  current, rows, cap f32 [n, Z], total, skew f32
//                          [n], eligible bool [n, Z] -> alloc i32 [n, Z]
//   water_fill_launch      current, cap f32 [n, Z], total f32 [n],
//                          eligible bool [n, Z] -> alloc i32 [n, Z]
//
// each the function of karpenter_tpu_torch/ops/masks.py's plain body of the
// same name, bit for bit, for row-major [n, Z] inputs (the layout every
// caller passes: the zone axis is the fastest).  That takes:
//
// - float32 throughout, every add, subtract and multiply rounded on its
//   own (__fadd_rn / __fsub_rn / __fmul_rn: nvcc contracts no multiply-add
//   that the separate PyTorch kernels do not);
// - minimum, maximum and clamp as PyTorch's CUDA kernels have them (a NaN
//   operand wins), floor, and the float -> int32 cast as a truncation;
// - every sum over the zones in the order PyTorch's CUDA reduction takes
//   for a contiguous last axis (torch_sum below), since the bisections
//   compare fractional sums against the total;
// - the constants as the Python code rounds them: BIG = float32(3.4e38),
//   the 1e6 skew clamp, the band's 1e-4 and the top-up's 1 - 1e-4.
//
// What bounds it.  One row is a serial chain of about 88 bisection rounds
// of a few dependent float operations per zone: some 1,000 dependent
// operations, a few microseconds of one thread.  Its bytes (about 21 Z + 8
// a row) and its operations are nothing to the card; at the group step's
// shapes (1 to 32 rows, Z = 3) a call is bound by its launch and by that
// one thread's latency.  So the design spends nothing on parallelism inside
// a row: one thread per row, 128 threads a block, each running the whole
// algorithm in registers over the row's zones.  The kernel is instantiated
// for Z = 3, the zone axis of every catalog the port meets, whose constant
// zone loops the compiler unrolls; other Z up to kMaxZones run the same
// code over a runtime bound, their arrays in local memory.  No loop is
// unrolled by pragma: the build is part of a fresh process's set-up, and
// forced unrolling of the runtime-bound variant took it from 4.5 s to
// 10.6 s with nvcc 12.8 for sm_90a (27.5 s with every Z unrolled).
//
// Plain C interface, loaded with ctypes: each launcher takes device pointers
// and the caller's stream, launches, and returns cudaGetLastError().  It
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxZones = 64;
// masks.BIG: float(np.float32(3.4e38)), a double rounded to float
constexpr float kBig = static_cast<float>(3.4e38);
constexpr float kSkewCap = 1e6f;
constexpr float kBandEps = static_cast<float>(1e-4);
constexpr float kWhole = static_cast<float>(1.0 - 1e-4);
constexpr int kWaterRounds = 40;
constexpr int kBandRounds = 48;
// PyTorch's reduction: values per thread (vt0) and the widest block row
constexpr int kReduceUnroll = 4;
constexpr int kWarp = 32;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
// torch.minimum / torch.maximum / torch.clamp: a NaN operand is the result
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// .to(torch.int32): truncation toward zero
__device__ __forceinline__ int to_i32(float x) {
  return static_cast<int>(x);
}

// x.sum(dim=-1) of a contiguous [rows, Z] float32 tensor on CUDA, in the
// order PyTorch's reduction (ATen Reduce.cuh) adds it: the Z inputs of an
// output are split over a block row of w = min(last_pow2(Z), 32) threads;
// thread t adds inputs t, t + w, ... into kReduceUnroll accumulators in
// turn and folds them in order; then the block row folds by shuffles down
// at offsets w / 2, w / 4, ..., 1, thread t taking thread t + offset's sum.
// For Z = 3: (z0 + z2) + z1; for Z = 4: (z0 + z2) + (z1 + z3).
template <int M>
__device__ __forceinline__ float torch_sum(const float (&v)[M], int Z) {
  int w = 1;
  while (w * 2 <= Z && w < kWarp) w *= 2;
  float part[M < kWarp ? M : kWarp];
  for (int t = 0; t < w; ++t) {
    float acc[kReduceUnroll];
    for (int i = 0; i < kReduceUnroll; ++i) acc[i] = 0.0f;
    int idx = t;
    while (idx + (kReduceUnroll - 1) * w < Z) {
      for (int i = 0; i < kReduceUnroll; ++i)
        acc[i] = add(acc[i], v[idx + i * w]);
      idx += kReduceUnroll * w;
    }
    for (int i = 0; i < kReduceUnroll && idx < Z; ++i, idx += w)
      acc[i] = add(acc[i], v[idx]);
    float s = acc[0];
    for (int i = 1; i < kReduceUnroll; ++i) s = add(s, acc[i]);
    part[t] = s;
  }
  for (int off = w >> 1; off > 0; off >>= 1) {
    for (int t = 0; t < off; ++t) part[t] = add(part[t], part[t + off]);
  }
  return part[0];
}

// masks.water_fill_plain for one row, before its final clamp and cast:
// ``current``, ``cap`` and ``total`` as float32, ``el`` the eligible zones.
template <int M>
__device__ __forceinline__ void water_row(const float (&current)[M],
                                          const float (&cap)[M],
                                          float total, const bool (&el)[M],
                                          int Z, float (&alloc)[M]) {
  float cur[M], capf[M], v[M];
  float top = 0.0f;
  for (int z = 0; z < Z; ++z) {
    cur[z] = el[z] ? current[z] : kBig;
    capf[z] = el[z] ? cap[z] : 0.0f;
    const float c = el[z] ? cur[z] : 0.0f;  // amax of where(el, cur, 0)
    top = z == 0 ? c : tmax(top, c);
  }
  float hi = add(add(top, total), 1.0f);
  float lo = 0.0f;
#pragma unroll 1
  for (int round = 0; round < kWaterRounds; ++round) {
    const float mid = mul(0.5f, add(lo, hi));
    for (int z = 0; z < Z; ++z) {
      v[z] = tmin(capf[z], tmax(sub(mid, cur[z]), 0.0f));
    }
    const bool done = torch_sum(v, Z) >= total;
    lo = done ? lo : mid;
    hi = done ? mid : hi;
  }
  for (int z = 0; z < Z; ++z) {
    alloc[z] = floorf(tmin(capf[z], tmax(sub(hi, cur[z]), 0.0f)));
  }
  // trim the excess, highest zone first
  const float excess = tmax(sub(torch_sum(alloc, Z), total), 0.0f);
  float trim = 0.0f;
  for (int k = 0; k < Z; ++k) {
    const int z = Z - 1 - k;
    const float pos = alloc[z] > 0.0f ? 1.0f : 0.0f;
    trim = add(trim, pos);
    alloc[z] = sub(alloc[z], trim <= excess ? pos : 0.0f);
  }
  // top up: zones with room for a whole unit first, then fractional room
  const float shortfall = tmax(sub(total, torch_sum(alloc, Z)), 0.0f);
  float whole[M], frac[M];
  for (int z = 0; z < Z; ++z) {
    const float room = sub(capf[z], alloc[z]);
    whole[z] = room >= kWhole ? 1.0f : 0.0f;
    frac[z] = (room > 0.0f && whole[z] == 0.0f) ? 1.0f : 0.0f;
  }
  const float n_whole = torch_sum(whole, Z);
  float fill_w = 0.0f, fill_f = 0.0f;
  for (int z = 0; z < Z; ++z) {
    fill_w = add(fill_w, whole[z]);
    fill_f = add(fill_f, frac[z]);
    alloc[z] = add(add(alloc[z], fill_w <= shortfall ? whole[z] : 0.0f),
                   add(fill_f, n_whole) <= shortfall ? frac[z] : 0.0f);
  }
}

// One zone's target count at band floor t (skew_band_fill_plain's f_of).
__device__ __forceinline__ float band_count(float t, float cur, float rows,
                                            float fmax, float skew,
                                            bool el) {
  const float lower = tmin(tmax(t, cur), fmax);
  const float upper = tmin(tmax(add(t, skew), cur), fmax);
  const float pref = tmin(tmax(add(cur, rows), lower), upper);
  return el ? pref : cur;
}

template <int M>
__device__ __forceinline__ void load_row(const float* p, int Z,
                                         float (&v)[M]) {
  for (int z = 0; z < Z; ++z) {
    v[z] = p[z];
  }
}

template <int M>
__device__ __forceinline__ void load_el(const uint8_t* p, int Z,
                                        bool (&v)[M]) {
  for (int z = 0; z < Z; ++z) {
    v[z] = p[z] != 0;
  }
}

// ZC > 0: a row of exactly ZC zones, loops unrolled; ZC == 0: Z zones.
template <int ZC>
__global__ void __launch_bounds__(kThreads)
    water_fill_kernel(const float* __restrict__ current,
                      const float* __restrict__ cap,
                      const float* __restrict__ total,
                      const uint8_t* __restrict__ eligible,
                      int* __restrict__ out, int n, int Z) {
  constexpr int M = ZC > 0 ? ZC : kMaxZones;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  if (ZC > 0) Z = ZC;
  const size_t at = static_cast<size_t>(r) * Z;
  float cur[M], capv[M], alloc[M];
  bool el[M];
  load_row(current + at, Z, cur);
  load_row(cap + at, Z, capv);
  load_el(eligible + at, Z, el);
  water_row(cur, capv, total[r], el, Z, alloc);
  for (int z = 0; z < Z; ++z) {
    out[at + z] = to_i32(tmax(alloc[z], 0.0f));
  }
}

template <int ZC>
__global__ void __launch_bounds__(kThreads)
    skew_band_fill_kernel(const float* __restrict__ current,
                          const float* __restrict__ rows,
                          const float* __restrict__ cap,
                          const float* __restrict__ total,
                          const float* __restrict__ skew,
                          const uint8_t* __restrict__ eligible,
                          int* __restrict__ out, int n, int Z) {
  constexpr int M = ZC > 0 ? ZC : kMaxZones;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  if (ZC > 0) Z = ZC;
  const size_t at = static_cast<size_t>(r) * Z;
  float cur[M], capf[M], rowsf[M], fmax[M], v[M];
  bool el[M];
  load_row(current + at, Z, cur);
  load_row(cap + at, Z, capf);
  load_row(rows + at, Z, rowsf);
  load_el(eligible + at, Z, el);
  const float totalf = total[r];
  // float32's ulp at 1e9 would destroy the t + skew arithmetic
  const float skewf = tmin(skew[r], kSkewCap);
  float top = 0.0f;
  for (int z = 0; z < Z; ++z) {
    capf[z] = el[z] ? capf[z] : 0.0f;
    rowsf[z] = tmin(el[z] ? rowsf[z] : 0.0f, capf[z]);
    fmax[z] = add(cur[z], capf[z]);
    const float c = el[z] ? cur[z] : 0.0f;
    top = z == 0 ? c : tmax(top, c);
  }
  float lo = -add(add(skewf, totalf), 1.0f);
  float hi = add(add(top, totalf), 1.0f);
#pragma unroll 1
  for (int round = 0; round < kBandRounds; ++round) {
    const float mid = mul(0.5f, add(lo, hi));
    for (int z = 0; z < Z; ++z) {
      const float f = band_count(mid, cur[z], rowsf[z], fmax[z], skewf,
                                 el[z]);
      v[z] = el[z] ? sub(f, cur[z]) : 0.0f;
    }
    const bool ok = torch_sum(v, Z) <= totalf;
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
  }
  float alloc[M], head[M], level[M];
  const float top_band = add(lo, skewf);
  for (int z = 0; z < Z; ++z) {
    const float f = band_count(lo, cur[z], rowsf[z], fmax[z], skewf, el[z]);
    alloc[z] = tmin(floorf(add(tmax(sub(f, cur[z]), 0.0f), kBandEps)),
                    capf[z]);
    const float upper = tmin(tmax(top_band, cur[z]), fmax[z]);
    level[z] = add(cur[z], alloc[z]);
    head[z] = tmax(sub(upper, level[z]), 0.0f);
  }
  // the integer remainder levels across the band's remaining headroom
  const float rem = tmax(sub(totalf, torch_sum(alloc, Z)), 0.0f);
  water_row(level, head, rem, el, Z, v);
  for (int z = 0; z < Z; ++z) {
    const float extra = static_cast<float>(to_i32(tmax(v[z], 0.0f)));
    out[at + z] = to_i32(tmax(add(alloc[z], extra), 0.0f));
  }
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int water_fill_launch(const void* current, const void* cap,
                                 const void* total, const void* eligible,
                                 void* out, int n, int zones,
                                 void* stream) {
  if (n <= 0 || zones < 1 || zones > kMaxZones) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(current);
  const auto* k = static_cast<const float*>(cap);
  const auto* t = static_cast<const float*>(total);
  const auto* e = static_cast<const uint8_t*>(eligible);
  auto* o = static_cast<int*>(out);
  if (zones == 3)
    water_fill_kernel<3><<<grid_for(n), kThreads, 0, s>>>(c, k, t, e, o, n,
                                                          zones);
  else
    water_fill_kernel<0><<<grid_for(n), kThreads, 0, s>>>(c, k, t, e, o, n,
                                                          zones);
  return cudaGetLastError();
}

extern "C" int skew_band_fill_launch(const void* current, const void* rows,
                                     const void* cap, const void* total,
                                     const void* skew, const void* eligible,
                                     void* out, int n, int zones,
                                     void* stream) {
  if (n <= 0 || zones < 1 || zones > kMaxZones) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(current);
  const auto* r = static_cast<const float*>(rows);
  const auto* k = static_cast<const float*>(cap);
  const auto* t = static_cast<const float*>(total);
  const auto* w = static_cast<const float*>(skew);
  const auto* e = static_cast<const uint8_t*>(eligible);
  auto* o = static_cast<int*>(out);
  if (zones == 3)
    skew_band_fill_kernel<3><<<grid_for(n), kThreads, 0, s>>>(
        c, r, k, t, w, e, o, n, zones);
  else
    skew_band_fill_kernel<0><<<grid_for(n), kThreads, 0, s>>>(
        c, r, k, t, w, e, o, n, zones);
  return cudaGetLastError();
}
