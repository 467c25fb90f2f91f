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
// has ended (P1 also needs the abs-max of all of the last out), so the
// chain is bound in practice by the latency of one step, far above either.
//
// Design.  The chain's true dependency is narrow: step i+1 needs only
// out_i[:, :E]; in P2 rows never interact, in P1 only through the one
// abs-max a step.  The other F - E columns feed only the accumulator.  So
// one cooperative launch has two kinds of CTA, each of 8 warps that
// multiply (32-column output tiles, A fragments by ldmatrix) and a ninth,
// the signal warp:
//
// * Chain CTAs, one per 16 rows of x (B/16), own columns 0..E.  Each warp
//   holds its 32 columns of w[:, :E] as mma.sync B fragments in registers
//   for the whole call (P1 m16n8k32.s32.s8.s8.s32, 64 registers; P2
//   m16n8k16.f32.bf16.bf16.f32, 112, its last two k-steps read from the
//   staged weight: 288 threads leave 168 registers a thread), so a step
//   reads little but the A operand from shared memory, and keeps its rows
//   of x in registers at the positions of its accumulator fragment.  A
//   step rounds x into the A operand in a ring of kChainRing buffers (P1
//   quantized, P2 bf16 by __float2bfloat16_rn), meets the other multiplying
//   warps at a barrier of their own, multiplies, adds out to the
//   accumulator and keeps out[:, :E] as the next x.  P2's chain CTAs never
//   wait on each other.  P1's form one thread-block cluster (B/16 <= 16
//   CTAs): each warp stores the bits of its abs-max into a slot of every
//   CTA of the cluster with st.async, counted on that CTA's mbarrier of the
//   step's parity, and each CTA takes the max over the slots once all have
//   arrived: no cluster barrier a step (one cost ~0.87 us a step, PERF.md).
//   A slot and a phase of step i are used again at step i+2, after every
//   CTA has sent step i+1's maxima, which each sends only after reading
//   step i's.
// * Wide CTAs, one per tile of 128 of the columns E..F by 32 rows (P2) or
//   64 (P1: two m16 tiles a warp, so that its grid of whole 12-CTA
//   clusters fits the card), hold their weight fragments likewise and read
//   each step's A operand (P1 also its inv) from a history in global
//   memory [iters][B][E] (9.8 MB int8, 19.7 MB bf16 at the probe's shapes:
//   both stay in the 50 MB L2) through a ring of kStages buffers: the
//   signal warp fills them with cp.async (cp.async.mbarrier.arrive on a
//   `full` mbarrier), the multiplying warps free them (an `empty`
//   mbarrier).  A wide CTA dequantizes and adds in step order with the
//   chain's operations, so every element of acc is the same sequence of
//   roundings as in the plain version.
//
// A chain CTA's signal warp copies each staged A operand (and P1's inv) to
// the history and frees its buffer (mbarriers `staged`, `copied`), and
// publishes the steps copied so far with one __threadfence and a relaxed
// store of their count to ready[chain CTA], once for as many steps as were
// staged by then: the fence's latency stays off the chain.  A wide CTA's
// signal warp reads those counts (ld.acquire.gpu) only when it has used up
// what it last saw; history is read through L2 (cp.async.cg), never a
// possibly stale L1.  A CTA that spins on another must know it is
// resident, so the launch is cooperative (P1's with the cluster
// dimension), refused where its CTAs cannot all be resident at once.
//
// Numerics.  P1 rounds each step as the JAX kernel writes it, each in its
// own IEEE operation: an IEEE quotient for 127/ax and ws/inv, __fmul_rn for
// x*inv and a32*(ws/inv), __fadd_rn for acc + out (no FMA contraction,
// which nvcc would otherwise make of acc + a*q), the adder's own rounding
// of x*inv + 1.5*2^23 for jnp.round (half to even), a clamp, and 0 for a
// NaN as its conversion gives.  The int32 sums are exact and reach float32
// exactly, so P1 equals its plain version bit for bit.  The abs-max
// is a max over the bits of |x| as unsigned integers, exact and order-free
// for non-negative floats, and NaN-propagating (a NaN's bits exceed
// inf's), as is the floor at 1e-12: jnp.maximum(NaN, 1e-12) is NaN where
// fmaxf gives 1e-12.  Every chain CTA computes the same inv, so the copies
// never diverge.  P2 sums its products in the tensor cores' order, which
// differs from cuBLAS's by float32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kE = 256;          // K of every product, the width fed back
constexpr int kChainRows = 16;   // rows of x a chain CTA owns
constexpr int kWideCols = 128;   // columns of a wide tile
constexpr int kMmaWarps = 8;     // warps that multiply; one more signals
constexpr int kThreads = (kMmaWarps + 1) * 32;
constexpr int kMaxCluster = 16;  // P1's chain CTAs (non-portable cluster size)
constexpr int kStages = 4;       // a wide CTA's ring of A operands
constexpr int kChainRing = 8;    // a chain CTA's ring of A operands
constexpr int kSlots = kMaxCluster * kMmaWarps;  // P1: abs-max slots a step parity
constexpr int kInvStride = 4;    // floats a step and chain CTA in P1's inv history

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
constexpr int kKSteps = kE / Op<Q>::kStep;  // mma k-steps a product

// k-steps whose B fragments a warp reads from the staged weight in shared
// memory each step; the others it holds in registers for the whole call.
// 288 threads leave 168 registers a thread: P2's 16 k-steps of B would
// take 128 of them, and spill.
template <bool Q>
constexpr int kSmemSteps = Q ? 0 : 2;

// m16 tiles a warp of a wide CTA multiplies a step, and so the rows of a
// wide tile (two warps a column group): P1's tiles are 64 rows, so that
// its grid of whole 12-CTA clusters stays within what the card holds at
// once; P2's 32
template <bool Q>
constexpr int kWideM = Q ? 2 : 1;
template <bool Q>
constexpr int kWideRows = 32 * kWideM<Q>;

// dynamic shared memory of a chain CTA (the weight staged, its ring) and
// of a wide CTA (its weight slice staged, its ring)
template <bool Q>
constexpr int chain_smem() {
  return (kE + kChainRing * kChainRows) * Op<Q>::kLd * (int)sizeof(typename Op<Q>::T);
}
template <bool Q>
constexpr int wide_smem() {
  return (kWideCols + kStages * kWideRows<Q>) * Op<Q>::kLd * (int)sizeof(typename Op<Q>::T);
}

template <bool Q>
struct Args {
  const float* x0;                    // [B][E]
  const typename Op<Q>::T* w;         // [E][F]
  const float* ws;                    // P1: [F]
  float* out;                         // [B][F]
  typename Op<Q>::T* hist;            // [iters][B][E]: each step's A operand (wide CTAs only)
  float* inv_hist;                    // P1: [iters][B/16][kInvStride], each chain CTA's inv
  unsigned* ready;                    // [B/16]: steps each chain CTA has published, zeroed
  int B, F, iters;
  int chain, wide;                    // chain CTAs at the front of the grid, wide CTAs after
};

// The block's barriers and small buffers besides the dynamic ones
// (ops/gemm_probe._STATIC_SMEM is its size).
struct Shared {
  unsigned slots[2][kSlots];              // P1 chain: abs-max bits by step parity
  unsigned long long amax_bar[2];         // P1 chain: their mbarriers
  unsigned long long staged[kChainRing];  // chain: a ring buffer holds its step's A operand
  unsigned long long copied[kChainRing];  // chain: the signal warp has copied it out
  float inv[kChainRing];                  // P1 chain: the step's inv, for the signal warp
  unsigned long long full[kStages];       // wide: a ring buffer filled
  unsigned long long empty[kStages];      // wide: a ring buffer read
  __align__(16) float ring_inv[kStages][kInvStride];  // wide P1: inv by ring buffer
};

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// max(a, b) that returns a NaN a, as jnp.maximum does
__device__ __forceinline__ float nan_max(float a, float b) { return a != a ? a : fmaxf(a, b); }

// a / b rounded to nearest even.  __fdiv_rn leaves its fast path (for a
// called routine) where b is 0, inf or NaN, every step once P1's chain has
// overflowed; those quotients are exact, and a * (1 / b) gives them too.
__device__ __forceinline__ float div_rn(float a, float b) {
  return isfinite(b) && b != 0.0f ? __fdiv_rn(a, b) : __fmul_rn(a, __frcp_rn(b));
}

// 1.5 * 2^23 and its bits: y + kRound holds the integer nearest to y (half
// to even, the adder's own rounding) in its low mantissa bits for |y| <
// 2^22, and an integer n below 2^22 in magnitude is the float with bits
// kRoundBits + n, less kRound.  Both are exact, and run on the full-rate
// pipes where rintf and the int/float conversions take the quarter-rate
// one.
constexpr float kRound = 12582912.0f;
constexpr int kRoundBits = 0x4B400000;

// jnp.clip(jnp.round(v * inv), -127, 127).astype(int8): |v * inv| <= 127
// or NaN, and a NaN (kept by jnp.clip) converts to 0, as on the card
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  const float y = __fmul_rn(v, inv);
  int q = __float_as_int(__fadd_rn(y, kRound)) - kRoundBits;
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return y != y ? 0u : (uint32_t)q & 0xffu;
}

// float(a) for |a| < 2^22: the int32 sums of a step, below 127 * 127 * 256
__device__ __forceinline__ float to_float(int a) {
  return __fadd_rn(__int_as_float(a + kRoundBits), -kRound);
}

// two neighbouring values of x into the A operand, as int8 (P1) or bf16 (P2)
__device__ __forceinline__ void stage(int8_t* dst, float a, float b, float inv) {
  *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(quantize(a, inv) | quantize(b, inv) << 8);
}

__device__ __forceinline__ void stage(__nv_bfloat16* dst, float a, float b, float) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// acc + a * s in the JAX order: the product rounded, then the sum; returns
// the product (this step's out)
__device__ __forceinline__ float dequant_add(float& acc, int a, float s) {
  const float o = __fmul_rn(to_float(a), s);
  acc = __fadd_rn(acc, o);
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// the phase of `bar` now running expects `bytes` more (one arrival)
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival on `bar` once the thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// whether the phase of `bar` with this parity has completed (no wait)
__device__ __forceinline__ bool mbar_done(unsigned long long* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// the 256 threads of the multiplying warps, without the signal warp
__device__ __forceinline__ void sync_mma_warps() {
  asm volatile("bar.sync 1, %0;" ::"n"(kMmaWarps * 32) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster, once
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// v into *p of CTA `rank` of the cluster, its 4 bytes counted on that CTA's
// mbarrier `bar`
__device__ __forceinline__ void st_async(unsigned* p, unsigned long long* bar, unsigned rank,
                                         unsigned v) {
  uint32_t a = smem_u32(p), b = smem_u32(bar);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %2;\nmapa.shared::cluster.u32 %1, %1, %2;"
               : "+r"(a), "+r"(b)
               : "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   a),
               "r"(v), "r"(b)
               : "memory");
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t v);
template <>
__device__ __forceinline__ int8_t from_bits<int8_t>(uint32_t v) {
  return (int8_t)(v & 0xffu);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(uint32_t v) {
  return __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
}

// w[:, col0 : col0 + ncols] into wt [ncols][ld], transposed, 16 bytes a
// load, kBatch loads in flight a thread
template <bool Q>
__device__ void stage_weight(const typename Op<Q>::T* w, int F, int col0, int ncols,
                             typename Op<Q>::T* wt) {
  using T = typename Op<Q>::T;
  constexpr int per = 16 / (int)sizeof(T), kBatch = 8;
  const int n = kE * ncols / per;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, k = i / (ncols / per), c = i % (ncols / per) * per;
      if (i < n) v[u] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * F + col0 + c));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, k = i / (ncols / per), c = i % (ncols / per) * per;
      if (i < n)
#pragma unroll
        for (int q = 0; q < per; ++q) {
          const uint32_t word = q * 4 / per == 0 ? v[u].x
                                : q * 4 / per == 1 ? v[u].y
                                : q * 4 / per == 2 ? v[u].z : v[u].w;
          const int shift = q % (per / 4) * 32 / (per / 4);
          wt[(c + q) * Op<Q>::kLd + k] = from_bits<T>(word >> shift);
        }
    }
  }
}

// The warp's B fragments of its 32 columns from wn of the staged slice wt
// (in registers but for the last kSmemSteps k-steps), and (P1) the weight
// scale of one of them, col0 + wn + 8 (g / 2) + 2t + g % 2: the lane's
// share of the 32 quotients ws / inv of a step, which the warp passes
// round by shuffles.
template <bool Q>
struct Weights {
  static constexpr int kRegSteps = kKSteps<Q> - kSmemSteps<Q>;
  uint32_t b[kRegSteps][4][2];
  const typename Op<Q>::T* wt;  // the staged slice, for the other k-steps
  int wn;
  float wsc;

  // the B fragments of k-step s, columns wn + 8j.. of the staged slice
  __device__ __forceinline__ void fragment(int s, int j, uint32_t (&f)[2]) const {
    using T = typename Op<Q>::T;
    constexpr int kq = 4 / (int)sizeof(T);  // k-values in a 32-bit fragment word
    constexpr int kh = Op<Q>::kStep / 2;    // k offset of a fragment's second half
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* br = wt + (wn + j * 8 + g) * Op<Q>::kLd + s * Op<Q>::kStep + t * kq;
    f[0] = word(br);
    f[1] = word(br + kh);
  }

  __device__ __forceinline__ void load(const typename Op<Q>::T* slice, int col, const float* ws,
                                       int col0) {
    wt = slice;
    wn = col;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < kRegSteps; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) fragment(s, j, b[s][j]);
    if constexpr (Q) wsc = __ldg(ws + col0 + wn + (g >> 1) * 8 + t * 2 + (g & 1));
  }

  // c = the warp's M x 16 rows by 32 columns of a @ w: a [16 M][ld] its
  // rows of the A operand, whose fragments ldmatrix loads (lanes 0-15 give
  // the rows' first 16 bytes of a k-step, lanes 16-31 the next 16)
  template <int M>
  __device__ __forceinline__ void product(const typename Op<Q>::T* a,
                                          typename Op<Q>::Acc (&c)[M][4][4]) const {
    constexpr int ld = Op<Q>::kLd;
    const int lane = threadIdx.x & 31;
    const uint32_t a0 = smem_u32(a + (lane & 15) * ld) + (lane >> 4) * 16;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][j][e] = 0;
#pragma unroll
    for (int s = 0; s < kKSteps<Q>; ++s) {
      uint32_t bs[4][2];
      if (s >= kRegSteps)
#pragma unroll
        for (int j = 0; j < 4; ++j) fragment(s, j, bs[j]);
      const uint32_t(*bk)[2] = s < kRegSteps ? b[s < kRegSteps ? s : 0] : bs;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        uint32_t af[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
                     : "r"(a0 + (m * 16 * ld + s * Op<Q>::kStep) * (int)sizeof(a[0])));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(c[m][j], af, bk[j]);
      }
    }
  }

  // the lane's quotient ws / inv (P1), computed before the product so that
  // its latency hides behind it
  __device__ __forceinline__ float scale(float inv) const { return Q ? div_rn(wsc, inv) : 0.0f; }

  // this step's out from the products c (P1 dequantized: `mine` from
  // scale) into o, added to acc
  template <int M>
  __device__ __forceinline__ void accumulate(const typename Op<Q>::Acc (&c)[M][4][4], float mine,
                                             float (&acc)[M][4][4], float (&o)[M][4][4]) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (Q) {
        const float s0 = __shfl_sync(0xffffffffu, mine, 8 * j + t);
        const float s1 = __shfl_sync(0xffffffffu, mine, 8 * j + 4 + t);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[m][j][e] = dequant_add(acc[m][j][e], c[m][j][e], e & 1 ? s1 : s0);
      } else {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[m][j][e] = c[m][j][e];
            acc[m][j][e] = __fadd_rn(acc[m][j][e], o[m][j][e]);
          }
      }
    }
  }
};

// the thread's accumulator fragments (rows r + 16m and r + 16m + 8,
// columns c + 8j and c + 8j + 1) to out
template <int M>
__device__ __forceinline__ void write_acc(float* out, int F, int r, int c,
                                          const float (&acc)[M][4][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t at = (size_t)(r + 16 * m) * F + c + j * 8;
      *reinterpret_cast<float2*>(out + at) = make_float2(acc[m][j][0], acc[m][j][1]);
      *reinterpret_cast<float2*>(out + at + 8 * (size_t)F) =
          make_float2(acc[m][j][2], acc[m][j][3]);
    }
}

// The chain: rows c*16.. of x through every step, columns 0..E of acc.
// The multiplying warps stage step it's A operand into ring buffer
// it % kChainRing, meet at a barrier of their own and multiply; the signal
// warp copies each staged buffer to the history and frees it, and
// publishes the steps copied so far with one fence for as many as were
// staged by then, so the fence's latency stays off the chain.
template <bool Q>
__device__ void chain_cta(const Args<Q>& p, unsigned char* smem, Shared& sh, int c) {
  using T = typename Op<Q>::T;
  using Acc = typename Op<Q>::Acc;
  constexpr int ld = Op<Q>::kLd;
  constexpr int per = 16 / (int)sizeof(T);
  T* wt = reinterpret_cast<T*>(smem);  // [kE][ld]: the weight, staged once
  T* xs = wt + kE * ld;                // [kChainRing][kChainRows][ld]: the A operands
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wn = warp * 32;
  const int row0 = c * kChainRows, G = p.B / kChainRows;
  const unsigned rank = Q ? cluster_rank() : 0;
  const unsigned amax_bytes = 4u * kMmaWarps * G;  // P1: a step's maxima into each CTA

  stage_weight<Q>(p.w, p.F, 0, kE, wt);
  if (tid == 0) {
    for (int b = 0; b < kChainRing; ++b) {
      mbar_init(&sh.staged[b], 1);
      mbar_init(&sh.copied[b], 1);
    }
    if constexpr (Q) {
      mbar_init(&sh.amax_bar[0], 1);
      mbar_init(&sh.amax_bar[1], 1);
      mbar_expect(&sh.amax_bar[0], amax_bytes);  // steps 0 and 1
      mbar_expect(&sh.amax_bar[1], amax_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (Q) {
    for (int i = tid; i < kSlots; i += kThreads) sh.slots[0][i] = sh.slots[1][i] = 0;
    cluster_sync();  // every CTA of the cluster set up before any stores into it
  }
  __syncthreads();  // the weight staged

  if (warp == kMmaWarps) {
    // the signal warp
    if (p.hist != nullptr) {
      for (int done = 0; done < p.iters;) {
        do {
          const int b = done % kChainRing;
          mbar_wait(&sh.staged[b], (done / kChainRing) & 1);
          const T* from = xs + b * kChainRows * ld;
          T* to = p.hist + ((size_t)done * p.B + row0) * kE;
          for (int i = lane; i < kChainRows * kE / per; i += 32) {
            const int r = i / (kE / per), k = i % (kE / per) * per;
            __stcg(reinterpret_cast<uint4*>(to + r * kE + k),
                   *reinterpret_cast<const uint4*>(from + r * ld + k));
          }
          if (Q && lane == 0)
            __stcg(p.inv_hist + ((size_t)done * G + c) * kInvStride, sh.inv[b]);
          __syncwarp();
          if (lane == 0) mbar_arrive(&sh.copied[b]);
          ++done;
        } while (done < p.iters &&
                 mbar_done(&sh.staged[done % kChainRing], (done / kChainRing) & 1));
        if (lane == 0) {
          __threadfence();
          st_relaxed(p.ready + c, done);
        }
      }
    }
  } else {
    Weights<Q> wgt;
    float x[1][4][4];  // this step's x at the thread's fragment positions
    float acc[1][4][4] = {};
    wgt.load(wt, wn, p.ws, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* src = p.x0 + (size_t)(row0 + g) * kE + wn + j * 8 + t * 2;
      const float2 lo = *reinterpret_cast<const float2*>(src);
      const float2 hi = *reinterpret_cast<const float2*>(src + 8 * kE);
      x[0][j][0] = lo.x, x[0][j][1] = lo.y, x[0][j][2] = hi.x, x[0][j][3] = hi.y;
    }
    for (int it = 0; it < p.iters; ++it) {
      const int b = it % kChainRing, q = it & 1;
      T* xb = xs + b * kChainRows * ld;
      float inv = 1.0f;
      if constexpr (Q) {
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m = max(m, abs_bits(x[0][j][e]));
        m = __reduce_max_sync(0xffffffffu, m);
        if (lane < G) st_async(&sh.slots[q][rank * kMmaWarps + warp], &sh.amax_bar[q], lane, m);
        mbar_wait(&sh.amax_bar[q], (it >> 1) & 1);
        m = 0;  // the max over every warp of the cluster
        for (int s = lane; s < G * kMmaWarps; s += 32) m = max(m, sh.slots[q][s]);
        m = __reduce_max_sync(0xffffffffu, m);
        inv = div_rn(127.0f, nan_max(__uint_as_float(m), 1e-12f));
        if (tid == 0 && it + 2 < p.iters) mbar_expect(&sh.amax_bar[q], amax_bytes);  // step it + 2
      }
      // the buffer's last step (its A operand and inv) copied out before
      // either is overwritten
      if (p.hist != nullptr && it >= kChainRing)
        mbar_wait(&sh.copied[b], (it / kChainRing - 1) & 1);
      if (Q && tid == 0) sh.inv[b] = inv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        stage(xb + g * ld + wn + j * 8 + t * 2, x[0][j][0], x[0][j][1], inv);
        stage(xb + (g + 8) * ld + wn + j * 8 + t * 2, x[0][j][2], x[0][j][3], inv);
      }
      sync_mma_warps();
      if (tid == 0) mbar_arrive(&sh.staged[b]);
      const float mine = wgt.scale(inv);
      Acc cc[1][4][4];
      wgt.product(xb, cc);
      wgt.accumulate(cc, mine, acc, x);  // out[:, :E] is the next x
    }
    write_acc(p.out, p.F, row0 + g, wn + t * 2, acc);
  }
  if constexpr (Q) cluster_sync();  // no CTA leaves while a peer may store into it
}

// A wide tile: kWideRows rows from kWideRows * (wi / tiles a row) (fewer
// where B ends first), 128 columns from E, through every step's A operand
// from the history.
template <bool Q>
__device__ void wide_cta(const Args<Q>& p, unsigned char* smem, Shared& sh, int wi) {
  using T = typename Op<Q>::T;
  using Acc = typename Op<Q>::Acc;
  constexpr int ld = Op<Q>::kLd;
  constexpr int per = 16 / (int)sizeof(T);
  constexpr int M = kWideM<Q>, R = kWideRows<Q>;
  T* wt = reinterpret_cast<T*>(smem);  // [kWideCols][ld]: the weight slice, staged once
  T* ring = wt + kWideCols * ld;       // [kStages][R][ld]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  const int tiles = (p.F - kE) / kWideCols;
  const int row0 = wi / tiles * R, col0 = kE + wi % tiles * kWideCols;
  const int rows = min(R, p.B - row0);  // a multiple of 16
  const int src = row0 / kChainRows, G = p.B / kChainRows;
  const int wm = (warp & 1) * 16 * M, wn = (warp >> 1) * 32;  // the warp's rows and columns

  stage_weight<Q>(p.w, p.F, col0, kWideCols, wt);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sh.full[s], 32);  // the signal warp's lanes, once their copies land
      mbar_init(&sh.empty[s], kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kMmaWarps) {
    // the signal warp: step it into ring buffer it % kStages once the
    // tile's chain CTAs have published it and the buffer's last step has
    // been read
    int seen = 0;  // steps all the tile's chain CTAs had published at the last look
    for (int it = 0; it < p.iters; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&sh.empty[s], (it / kStages - 1) & 1);
      while (seen <= it) {
        const unsigned n = lane < rows / kChainRows ? ld_acquire(p.ready + src + lane) : ~0u;
        seen = (int)__reduce_min_sync(0xffffffffu, n);
      }
      __syncwarp();
      const T* from = p.hist + ((size_t)it * p.B + row0) * kE;
      T* to = ring + s * R * ld;
      for (int i = lane; i < rows * kE / per; i += 32) {
        const int r = i / (kE / per), k = i % (kE / per) * per;
        cp_async16(to + r * ld + k, from + r * kE + k);
      }
      if (Q && lane == 0)
        cp_async16(sh.ring_inv[s], p.inv_hist + ((size_t)it * G + src) * kInvStride);
      mbar_arrive_cp_async(&sh.full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  const bool active = wm < rows;  // the warp's rows are in the batch
  Weights<Q> wgt;
  if (active) wgt.load(wt, wn, p.ws, col0);
  float acc[M][4][4] = {};
  for (int it = 0; it < p.iters; ++it) {
    const int s = it % kStages;
    mbar_wait(&sh.full[s], (it / kStages) & 1);
    Acc cc[M][4][4];
    float o[M][4][4];
    const float mine = active ? wgt.scale(Q ? sh.ring_inv[s][0] : 1.0f) : 0.0f;
    if (active) wgt.product(ring + s * R * ld + wm * ld, cc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[s]);
    if (active) wgt.accumulate(cc, mine, acc, o);
  }
  if (active) write_acc(p.out, p.F, row0 + wm + g, col0 + wn + (lane & 3) * 2, acc);
}

template <bool Q>
__global__ void __launch_bounds__(kThreads, 1) probe_kernel(Args<Q> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int b = blockIdx.x;
  if (b < p.chain)
    chain_cta<Q>(p, smem, sh, b);
  else if (b - p.chain < p.wide)
    wide_cta<Q>(p, smem, sh, b - p.chain);
}

// The launch's residency, by device and cluster size, found once.
int resident_ctas(int Q, int cluster, int smem) {
  static int cache[2][8][kMaxCluster + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 8 && cache[Q][dev][cluster] > 0) return cache[Q][dev][cluster];
  int sms = 0, n = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    if (Q) {
      const auto kernel = probe_kernel<true>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = cluster;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cluster);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      n *= cluster;
    } else {
      const auto kernel = probe_kernel<false>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
      n *= sms;
    }
  }
  if (err != cudaSuccess) return -(int)err;
  if (dev < 8) cache[Q][dev][cluster] = n;
  return n;
}

// One cooperative launch of the chain CTAs and the wide CTAs (P1 in
// clusters of B/16, the first cluster the chain's), refused, with the error
// returned, where its CTAs cannot all be resident at once.
template <bool Q>
int run(Args<Q> p, cudaStream_t stream) {
  const int G = p.B / kChainRows;
  if (p.B <= 0 || p.B % 32 || p.F < kE || p.F % kWideCols || p.iters < 0 ||
      (Q && G > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  p.chain = G;
  p.wide = (p.B + kWideRows<Q> - 1) / kWideRows<Q> * ((p.F - kE) / kWideCols);
  if (p.wide == 0) p.hist = nullptr;  // nothing reads a history
  if (p.ready == nullptr ||
      (p.wide > 0 && (p.hist == nullptr || (Q && p.inv_hist == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int smem = chain_smem<Q>() > wide_smem<Q>() ? chain_smem<Q>() : wide_smem<Q>();
  const int cluster = Q ? G : 1;
  const int grid = (p.chain + p.wide + cluster - 1) / cluster * cluster;
  const int resident = resident_ctas(Q, cluster, smem);
  if (resident < 0) return -resident;
  if (resident < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = Q ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, probe_kernel<Q>, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// P1: x f32 [B, 256], wq int8 [256, F], ws f32 [1, F] -> out f32 [B, F];
// scratch: hist int8 [iters, B, 256] and inv_hist f32 [iters, B/16, 4]
// (none needed where F = 256), ready 32-bit [B/16], zero before the call.
extern "C" int gemm_probe_int8(const void* x, const void* wq, const void* ws, void* out,
                               void* hist, void* inv_hist, void* ready, int B, int F, int iters,
                               void* stream) {
  Args<true> p = {(const float*)x, (const int8_t*)wq, (const float*)ws, (float*)out,
                  (int8_t*)hist, (float*)inv_hist, (unsigned*)ready, B, F, iters, 0, 0};
  return run<true>(p, (cudaStream_t)stream);
}

// P2: x f32 [B, 256], w bf16 [256, F] -> out f32 [B, F]; scratch: hist
// bf16 [iters, B, 256] and ready as P1's.
extern "C" int gemm_probe_bf16(const void* x, const void* w, void* out, void* hist, void* ready,
                               int B, int F, int iters, void* stream) {
  Args<false> p = {(const float*)x, (const __nv_bfloat16*)w, nullptr, (float*)out,
                   (__nv_bfloat16*)hist, nullptr, (unsigned*)ready, B, F, iters, 0, 0};
  return run<false>(p, (cudaStream_t)stream);
}
