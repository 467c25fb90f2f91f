// The int8-vs-bf16 GEMM probe: a chain of dependent products, whole in one
// launch, on the tensor cores.
//
// Replaces the TPU kernels of scripts/probe_int8_pallas.py: kern_int8 (P1,
// gemm_probe_int8) and kern_bf16 (P2, gemm_probe_bf16).  For `iters` steps
// each computes out = f(x) @ w for x [B, E] and w [E, F], adds out to a
// float32 accumulator and feeds out[:, :E] back as the next x:
//
//   P1: ax = max |x| over the whole tensor, inv = 127 / max(ax, 1e-12),
//       xq = clip(round_half_even(x * inv), -127, 127) int8,
//       out = float(xq @ wq, exact int32) * (ws[col] / inv)
//   P2: out = bf16(x) @ w, bf16 products summed in float32
//
// Bound: operations.  2*B*E*F*iters = 40.3 G operations at the probe's
// B=192, E=256, F=2048 and 200 steps: 0.0204 ms at the H100's 1979 int8
// TOPS and 0.0407 ms at its 989 bf16 TFLOP/s, against 2.3-2.8 MB of inputs
// and output (under a microsecond).  But no step can start before the last
// has ended everywhere (P1 also needs the abs-max of all of the last out),
// so the chain is bound in practice by 200 barriers across the whole grid
// and the latency of each step, far above either bound.
//
// Design.  The TPU kernel runs its fori_loop in one program with x, the
// weight and the accumulator in VMEM.  Here one cooperative launch runs
// the whole chain: a CTA owns a tile of 32 rows by 128 output columns (96
// CTAs at the probe's shapes, all resident, one an SM), loads its column
// slice of the weight into shared memory once, before the loop (int8 32
// KB, bf16 64 KB, transposed to [column][k] so that a fragment's four or two
// k-values are one 32-bit word), and keeps its tile of the accumulator in
// registers for all the steps.  Each step the CTA stages its 32 rows of x
// from L2 into shared memory as the A operand (P1 quantized to int8, P2
// rounded to bf16 by __float2bfloat16_rn), runs mma.sync (P1
// m16n8k32.s32.s8.s8.s32, P2 m16n8k16.f32.bf16.bf16.f32) over the 8 warps'
// 16 x 32 sub-tiles, adds out to the accumulator, and the CTAs of the first
// E/128 column slices write their out tile as the next x and (P1) the bits
// of its abs-max to a slot of their own.  Then one grid barrier.  x and the
// slots are double-buffered by the step's parity: step i reads buffer i%2
// and writes buffer (i+1)%2, whose last readers finished before the barrier
// that ended step i-1, so one barrier a step is enough and no slot needs a
// reset.  Data written inside the launch is read with ld.global.cg (L2),
// never through a possibly stale L1.
//
// Numerics.  P1 rounds each step as the JAX kernel writes it, each in its
// own IEEE operation: __fdiv_rn for 127/ax and ws/inv, __fmul_rn for x*inv
// and a32*(ws/inv), __fadd_rn for acc + out (no FMA contraction, which nvcc
// would otherwise make of acc + a*q), rintf for jnp.round (half to even),
// a clamp that lets NaN through as jnp.clip does.  The int32 sums are
// exact, so P1 equals its plain version bit for bit.  The abs-max is a max
// over the bits of |x| as unsigned integers, exact and order-free for
// non-negative floats, and NaN-propagating (a NaN's bits exceed inf's), as
// is the floor at 1e-12: jnp.maximum(NaN, 1e-12) is NaN where fmaxf gives
// 1e-12.  P2 sums its products in the tensor cores' order, which differs
// from cuBLAS's by float32 rounding.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kE = 256;                  // K of every product, the width fed back
constexpr int kRows = 32;                // rows of x a CTA owns
constexpr int kCols = 128;               // output columns a CTA owns
constexpr int kThreads = 256;            // 8 warps: 2 m16 tiles x 4 groups of 32 columns
constexpr int kFeedSlices = kE / kCols;  // column slices whose out is the next x
constexpr int kStage = kRows * kE / 4 / kThreads;  // float4s of x a thread stages a step

// Operands of P1 (Q = true) and P2 in shared memory: rows of E values
// padded so that the 8 row groups of a fragment load fall in distinct banks
// (a row of 68 or 132 words).
template <bool Q>
struct Op;

template <>
struct Op<true> {
  using T = int8_t;
  using Acc = int;
  static constexpr int kLd = kE + 16;  // elements: 272 bytes a row
  static constexpr int kStep = 32;     // K of one m16n8k32
};

template <>
struct Op<false> {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int kLd = kE + 8;  // elements: 528 bytes a row
  static constexpr int kStep = 16;    // K of one m16n8k16
};

template <bool Q>
constexpr int smem_bytes() {
  return (kCols + kRows) * Op<Q>::kLd * (int)sizeof(typename Op<Q>::T);
}

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// max(a, b) that returns a NaN a, as jnp.maximum does
__device__ __forceinline__ float nan_max(float a, float b) { return a != a ? a : fmaxf(a, b); }

// jnp.clip(jnp.round(v * inv), -127, 127).astype(int8)
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);  // NaN passes, as in jnp.clip
  return (uint32_t)(uint8_t)(int8_t)(int)r;
}

// four float32 values of x into the A operand, as int8 (P1) or bf16 (P2)
__device__ __forceinline__ void stage(int8_t* dst, float4 v, float inv) {
  *reinterpret_cast<uint32_t*>(dst) = quantize(v.x, inv) | quantize(v.y, inv) << 8 |
                                      quantize(v.z, inv) << 16 | quantize(v.w, inv) << 24;
}

__device__ __forceinline__ void stage(__nv_bfloat16* dst, float4 v, float) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// acc + a * s in the JAX order: the product rounded, then the sum; returns
// the product (this step's out)
__device__ __forceinline__ float dequant_add(float& acc, int a, float s) {
  const float o = __fmul_rn((float)a, s);
  acc = __fadd_rn(acc, o);
  return o;
}

// The CTA's max of m to *slot (thread 0 writes it).
__device__ __forceinline__ void publish_max(unsigned* slot, unsigned m, unsigned* warp_max) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    *slot = m;
  }
}

template <bool Q>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x0, const typename Op<Q>::T* __restrict__ w,
             const float* __restrict__ wscale, float* __restrict__ out, float* xbuf,
             unsigned* slots, int B, int F, int iters) {
  using T = typename Op<Q>::T;
  using Acc = typename Op<Q>::Acc;
  constexpr int ld = Op<Q>::kLd;
  constexpr int kq = 4 / (int)sizeof(T);    // k-values in a 32-bit fragment word
  constexpr int kh = Op<Q>::kStep / 2;      // k offset of a fragment's second half
  extern __shared__ __align__(16) unsigned char smem[];
  T* wt = reinterpret_cast<T*>(smem);  // [kCols][ld]: the weight slice, column-major
  T* xs = wt + kCols * ld;             // [kRows][ld]: this step's A operand
  __shared__ unsigned warp_max[kThreads / 32];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int col0 = blockIdx.x * kCols, row0 = blockIdx.y * kRows;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 32;  // the warp's 16 x 32 sub-tile
  const bool feeds = blockIdx.x < kFeedSlices;
  const int nslots = gridDim.y * kFeedSlices;
  const int slot = blockIdx.y * kFeedSlices + blockIdx.x;
  const size_t xsize = (size_t)B * kE;

  for (int i = tid; i < kE * kCols; i += kThreads) {
    const int k = i / kCols, n = i % kCols;
    wt[n * ld + k] = w[(size_t)k * F + col0 + n];
  }
  float wsc[8];  // P1: the weight scales of this thread's 8 columns
  if constexpr (Q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wsc[2 * j] = wscale[col0 + wn + j * 8 + t * 2];
      wsc[2 * j + 1] = wscale[col0 + wn + j * 8 + t * 2 + 1];
    }
  }

  // the feeding CTAs put their tile of x in buffer 0 (and its abs-max bits
  // in slot 0) for step 0
  if (feeds) {
    unsigned m = 0;
    for (int i = tid; i < kRows * kCols / 4; i += kThreads) {
      const int r = i / (kCols / 4), c = i % (kCols / 4) * 4;
      const size_t at = (size_t)(row0 + r) * kE + col0 + c;
      const float4 v = *reinterpret_cast<const float4*>(x0 + at);
      __stcg(reinterpret_cast<float4*>(xbuf + at), v);
      m = max(max(m, max(abs_bits(v.x), abs_bits(v.y))), max(abs_bits(v.z), abs_bits(v.w)));
    }
    if constexpr (Q) publish_max(slots + slot, m, warp_max);
  }
  float acc[4][4] = {};
  grid.sync();

  for (int it = 0; it < iters; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const float* xc = xbuf + cur * xsize;
    float* xn = xbuf + nxt * xsize;
    // this CTA's rows of x into registers first, so that their L2 round
    // trip overlaps the one for the abs-max slots
    float4 xv[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads, r = i / (kE / 4), k = i % (kE / 4) * 4;
      xv[u] = __ldcg(reinterpret_cast<const float4*>(xc + (size_t)(row0 + r) * kE + k));
    }
    float inv = 1.0f;
    if constexpr (Q) {
      unsigned m = 0;  // the lanes of each warp read the slots at once
      for (int s = lane; s < nslots; s += 32) m = max(m, __ldcg(slots + cur * nslots + s));
      m = __reduce_max_sync(0xffffffffu, m);
      inv = __fdiv_rn(127.0f, nan_max(__uint_as_float(m), 1e-12f));
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads, r = i / (kE / 4), k = i % (kE / 4) * 4;
      stage(xs + r * ld + k, xv[u], inv);
    }
    __syncthreads();

    Acc c[4][4] = {};
#pragma unroll
    for (int kb = 0; kb < kE; kb += Op<Q>::kStep) {
      const T* ar = xs + (wm + g) * ld + kb + t * kq;
      const uint32_t a[4] = {word(ar), word(ar + 8 * ld), word(ar + kh), word(ar + 8 * ld + kh)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* br = wt + (wn + j * 8 + g) * ld + kb + t * kq;
        const uint32_t b[2] = {word(br), word(br + kh)};
        mma(c[j], a, b);
      }
    }

    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float o[4];
      if constexpr (Q) {
        const float s0 = __fdiv_rn(wsc[2 * j], inv), s1 = __fdiv_rn(wsc[2 * j + 1], inv);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = dequant_add(acc[j][e], c[j][e], e & 1 ? s1 : s0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = c[j][e];
          acc[j][e] = __fadd_rn(acc[j][e], o[e]);
        }
      }
      if (feeds) {
        const size_t at = (size_t)(row0 + wm + g) * kE + col0 + wn + j * 8 + t * 2;
        __stcg(reinterpret_cast<float2*>(xn + at), make_float2(o[0], o[1]));
        __stcg(reinterpret_cast<float2*>(xn + at + 8 * kE), make_float2(o[2], o[3]));
#pragma unroll
        for (int e = 0; e < 4; ++e) m = max(m, abs_bits(o[e]));
      }
    }
    if constexpr (Q) {
      if (feeds) publish_max(slots + nxt * nslots + slot, m, warp_max);
    }
    if (it + 1 < iters) grid.sync();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t at = (size_t)(row0 + wm + g) * F + col0 + wn + j * 8 + t * 2;
    *reinterpret_cast<float2*>(out + at) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + at + 8 * (size_t)F) = make_float2(acc[j][2], acc[j][3]);
  }
}

// A cooperative launch of the whole chain; refused, with the error
// returned, where the grid's CTAs cannot all be resident at once.
template <bool Q>
int run(const float* x, const typename Op<Q>::T* w, const float* ws, float* out, float* xbuf,
        unsigned* slots, int B, int F, int iters, cudaStream_t stream) {
  if (B <= 0 || B % kRows || F < kE || F % kCols || iters < 0) return (int)cudaErrorInvalidValue;
  const auto kernel = chain_kernel<Q>;
  const int smem = smem_bytes<Q>();
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const dim3 grid(F / kCols, B / kRows);
  if ((long long)per_sm * sms < (long long)grid.x * grid.y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&x, &w, &ws, &out, &xbuf, &slots, &B, &F, &iters};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(kThreads), args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// P1: x f32 [B, 256], wq int8 [256, F], ws f32 [1, F] -> out f32 [B, F];
// xbuf f32 [2, B, 256] and slots [2, B/32 * 2] 32-bit are scratch.
extern "C" int gemm_probe_int8(const void* x, const void* wq, const void* ws, void* out,
                               void* xbuf, void* slots, int B, int F, int iters,
                               void* stream) {
  return run<true>((const float*)x, (const int8_t*)wq, (const float*)ws, (float*)out,
                   (float*)xbuf, (unsigned*)slots, B, F, iters, (cudaStream_t)stream);
}

// P2: x f32 [B, 256], w bf16 [256, F] -> out f32 [B, F]; xbuf as P1's.
extern "C" int gemm_probe_bf16(const void* x, const void* w, void* out, void* xbuf, int B,
                               int F, int iters, void* stream) {
  return run<false>((const float*)x, (const __nv_bfloat16*)w, nullptr, (float*)out,
                    (float*)xbuf, nullptr, B, F, iters, (cudaStream_t)stream);
}
