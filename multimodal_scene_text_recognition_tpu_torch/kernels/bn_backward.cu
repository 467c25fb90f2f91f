// Train-mode BatchNorm backward over channels-last (NHWC) activations, the
// whole of it in one cooperative launch:
//
//   dgamma[c] = sum over rows n of dy[n, c] * xhat[n, c]
//   dbeta[c]  = sum over rows n of dy[n, c]
//   dx[n, c]  = (w[c] * rstd[c]) * (dy[n, c] - dbeta[c] / N - xhat[n, c] * (dgamma[c] / N))
//   xhat[n, c] = (x[n, c] - mean[c]) * rstd[c]
//
// with x, dy, dx [N, C] row-major, N = B*H*W: the memory of a [B, C, H, W]
// tensor in torch's channels_last format, which is how the port's cuDNN
// convs hand their outputs over and take their input gradients back (no
// layout copy on either side).  dx is float32 in the order written, each
// operation rounded on its own (no contraction), cast once to x's type.
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// batchnorm.py::_bn_bwd_reduce_kernel, which walks the [N, C] rows in a
// sequential grid of 1024-row tiles carrying the two sums in VMEM, and the
// dx pass the JAX package leaves to XLA (ops/batchnorm.py::_bn_bwd): x and
// dy are read twice there, once for the sums and once for dx.
//
// Bound: bytes.  x and dy are read once and dx written once, ~12 flops an
// element: 3 * N*C * sizeof(T) over the card's memory rate, 236 MB or
// 0.070 ms at 3.35 TB/s for the largest launch of a training step,
// [192, 64, 32, 100] in bfloat16.  dx needs the finished sums, so every
// element is either held on chip between the passes or read twice.  The
// design keeps what it can on chip and orders the rest for the L2:
//
//   * one CTA an SM (ctas = spans * channel groups, one wave), each thread
//     owning one 16-byte column (8 bfloat16 or 4 float32 channels; one
//     channel on the scalar path) of every lanes-th row of its CTA's span
//     of rows, so a warp reads whole rows of consecutive memory;
//   * pass 1: each thread streams its rows in with cp.async, two an
//     iteration and kAhead in flight, into a ring of `slots` rows of its own
//     in shared memory (row j in slot j % slots), and sums in float32
//     registers.  The ring ends holding the thread's last `slots` rows:
//     ~208 KB a CTA, ~27 MB across the grid;
//   * the sums, bit-equal from run to run (no float atomics): the CTA adds
//     its threads' sums per channel in a fixed order and writes one partial
//     pair per channel; a grid barrier; CTA b adds the partials of its
//     slice of the channels in a fixed order (a warp a channel: each lane
//     every 32nd partial in order, then the lanes in a fixed shuffle tree)
//     and writes dgamma, dbeta, dbeta / N and dgamma / N; a second grid
//     barrier, after which every thread reads the last two for its channels
//     (16-byte loads, as mean, rstd and w at the start: scalar loads of a
//     thread's 8 channels, 32 lines a warp instruction, cost 3-6 us a
//     launch on an H100);
//   * pass 2: each thread writes dx for its kept rows first, then reads the
//     rest again newest first through the same ring: the slot a row frees
//     takes the row `slots` older at once, kAhead rows in flight.  The
//     newest rows are the ones the L2 still holds: for the launches whose x
//     and dy fit the 50 MB L2 the re-read comes mostly from it.  Stores are
//     16 bytes a thread, marked evict-first (st.global.cs) so that dx does
//     not push the rows still to be read out of the L2.
//
// The scalar path (C not a multiple of 16 / sizeof(T), or x, dy, mean, rstd
// or w not 16-byte aligned) keeps nothing on chip: it loads its elements
// directly in both passes.
//
// The two-pass mode, for BatchNorm over a batch split across processes
// (parallel/mesh.py): dx needs the sums over the whole batch, and a
// collective cannot run between the grid barriers of one launch.  So:
//
//   * pass 1, bn_backward_sums: this kernel up to its final sums, which it
//     writes and stops (the same CTAs, ring and fixed-order sums, so its
//     dgamma and dbeta are bit-equal to the one-launch mode's);
//   * the caller all-reduces dgamma and dbeta over the processes;
//   * pass 2, bn_backward_dx: dx from the global sums and the global row
//     count, xhat recomputed, each thread one 16-byte column of every
//     lanes-th row of its CTA's rows.  Nothing is kept between the passes:
//     x and dy are read twice, 5 * N*C * sizeof(T) bytes in all.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 12;  // copy groups a thread keeps in flight; the ring holds more
constexpr int kFinalLanes = 32;  // a warp's lanes sum the partials of one channel
constexpr int kFinalLoads = 8;   // and each loads up to 8 of them at once

// One load of kN channels of T, widened to float32, and one store.
template <typename T, bool kVec>
struct Access;

template <>
struct Access<float, false> {
  using Raw = float;
  static constexpr int kN = 1;
  __device__ static void unpack(const Raw& v, float* out) { out[0] = v; }
  __device__ static Raw pack(const float* v) { return v[0]; }
};

template <>
struct Access<__nv_bfloat16, false> {
  using Raw = __nv_bfloat16;
  static constexpr int kN = 1;
  __device__ static void unpack(const Raw& v, float* out) { out[0] = __bfloat162float(v); }
  __device__ static Raw pack(const float* v) { return __float2bfloat16_rn(v[0]); }
};

template <>
struct Access<float, true> {
  using Raw = float4;
  static constexpr int kN = 4;
  __device__ static void unpack(const Raw& v, float* out) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static Raw pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
};

template <>
struct Access<__nv_bfloat16, true> {
  using Raw = uint4;
  static constexpr int kN = 8;
  __device__ static void unpack(const Raw& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static Raw pack(const float* v) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    return r;
  }
};

// v[0..V) = p[0..V): 16-byte loads where V is a multiple of 4 (p then
// 16-byte aligned), so that a warp reads its threads' channels in whole
// lines; kCg reads through L2 only (values written during the launch)
template <int V, bool kCg = false>
__device__ __forceinline__ void load_channels(const float* p, float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4* q = reinterpret_cast<const float4*>(p) + i;
      const float4 f = kCg ? __ldcg(q) : *q;
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = kCg ? __ldcg(p + i) : p[i];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but the n newest groups of this thread's copies have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

struct Params {
  const void* x;
  const void* dy;
  const float* mean;
  const float* rstd;
  const float* weight;
  void* dx;
  float* dgamma;
  float* dbeta;
  float* partial;  // [spans + 1, 2, C] scratch: the partial sums, then dbeta / N, dgamma / N
  long long N;
  int C;
  int spans;
  int groups;
  int slots;  // ring rows a thread (0 on the scalar path)
};

// kSumsOnly: pass 1 of the two-pass mode (writes dgamma and dbeta, then ends)
template <typename T, bool kVec, bool kSumsOnly>
__global__ void __launch_bounds__(kThreads, 1) bn_backward_kernel(const Params p) {
  using A = Access<T, kVec>;
  using Raw = typename A::Raw;
  constexpr int V = A::kN;
  // shared: the ring, [slots][kThreads] of x then of dy; then the
  // reduction buffer, [2][kThreads * V] float32
  extern __shared__ __align__(16) unsigned char smem[];
  Raw* xs = reinterpret_cast<Raw*>(smem);
  Raw* ds = xs + p.slots * kThreads;
  float* red = reinterpret_cast<float*>(ds + p.slots * kThreads);
  cg::grid_group grid = cg::this_grid();

  // this CTA: 16-byte columns [col0, col0 + ncols) of rows [r0, r1)
  const int tid = threadIdx.x;
  const int row_cols = p.C / V;  // columns in a row
  const int group = blockIdx.x % p.groups;
  const int span = blockIdx.x / p.groups;
  const int col0 = group * kThreads;
  const int ncols = min(kThreads, row_cols - col0);
  const int lanes = kThreads / ncols;  // rows read side by side
  const int col = tid % ncols;
  const int sub = tid / ncols;
  const long long r0 = p.N * span / p.spans;
  const long long r1 = p.N * (span + 1) / p.spans;
  // this thread: rows r0 + sub + j * lanes for j < n
  const int n = sub < lanes && r0 + sub < r1 ? (int)((r1 - r0 - sub + lanes - 1) / lanes) : 0;
  const Raw* xg = reinterpret_cast<const Raw*>(p.x) + col0 + col;
  const Raw* dg = reinterpret_cast<const Raw*>(p.dy) + col0 + col;
  Raw* dxg = reinterpret_cast<Raw*>(p.dx) + col0 + col;
  const int c0 = (col0 + col) * V;  // first channel of this thread
  auto at = [&](int j) { return (r0 + sub + (long long)j * lanes) * row_cols; };
  // the ring: row j of this thread in slot j % slots, at xs[s], ds[s] with
  // s = slot * kThreads + tid
  auto fetch = [&](int s, int j) {
    cp_async16(xs + s, xg + at(j));
    cp_async16(ds + s, dg + at(j));
  };
  auto next_slot = [&](int s) { return s + kThreads < p.slots * kThreads ? s + kThreads : tid; };
  auto prev_slot = [&](int s) { return (s == tid ? p.slots * kThreads + tid : s) - kThreads; };

  float m[V], r[V], a[V], acc_g[V], acc_b[V];  // a: w, then w * rstd
  load_channels<V>(p.mean + c0, m);
  load_channels<V>(p.rstd + c0, r);
  if constexpr (!kSumsOnly) load_channels<V>(p.weight + c0, a);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (!kSumsOnly) a[k] = __fmul_rn(a[k], r[k]);
    acc_g[k] = 0.0f;
    acc_b[k] = 0.0f;
  }
  auto accumulate = [&](const Raw& xv, const Raw& dv) {
    float xf[V], df[V];
    A::unpack(xv, xf);
    A::unpack(dv, df);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      acc_g[k] = fmaf(df[k], (xf[k] - m[k]) * r[k], acc_g[k]);
      acc_b[k] += df[k];
    }
  };

  // pass 1: the sums, oldest row first
  if constexpr (kVec) {
    // two rows an iteration, one copy group a row, kAhead groups in flight;
    // a row's slot is refilled once the row is summed (slots > kAhead + 1)
    int sf = tid, sc = tid;  // the slots of the next row fetched and summed
    auto refill = [&](int j) {
      if (j < n) {
        fetch(sf, j);
        sf = next_slot(sf);
      }
      cp_async_commit();
    };
    for (int j = 0; j < kAhead; ++j) refill(j);
    for (int j = 0; j < n; j += 2) {
      refill(j + kAhead);
      refill(j + 1 + kAhead);
      cp_async_wait<kAhead>();  // rows j and j + 1 have landed
      const int s1 = next_slot(sc);
      const Raw x0 = xs[sc], d0 = ds[sc];
      if (j + 1 < n) {
        const Raw x1 = xs[s1], d1 = ds[s1];
        accumulate(x0, d0);
        accumulate(x1, d1);
      } else {
        accumulate(x0, d0);
      }
      sc = next_slot(s1);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < n; ++j) accumulate(xg[at(j)], dg[at(j)]);
  }

  // this CTA's sums per channel, the threads' in the order of their row lane
  if (n > 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[tid * V + k] = acc_g[k];
      red[kThreads * V + tid * V + k] = acc_b[k];
    }
  }
  __syncthreads();
  const int width = ncols * V;  // channels of this CTA
  // a row lane past the span's rows summed nothing and wrote nothing
  const int summed = (int)min((long long)lanes, r1 - r0);
  for (int j = tid; j < width; j += kThreads) {
    float g = 0.0f, b = 0.0f;
#pragma unroll 8
    for (int s = 0; s < summed; ++s) {
      g += red[s * width + j];
      b += red[kThreads * V + s * width + j];
    }
    p.partial[(2LL * span) * p.C + col0 * V + j] = g;
    p.partial[(2LL * span + 1) * p.C + col0 * V + j] = b;
  }
  grid.sync();  // every CTA's partial sums are written

  // CTA b: the final sums of channels [cbeg, cend), a warp a channel: each
  // lane adds every 32nd span's partial in order, then the lanes add in a
  // fixed tree; lane 0 also writes dbeta / N and dgamma / N for pass 2
  const int per_cta = (p.C + gridDim.x - 1) / gridDim.x;
  const int cbeg = min(p.C, (int)blockIdx.x * per_cta);
  const int cend = min(p.C, cbeg + per_cta);
  float* coef = p.partial + 2LL * p.spans * p.C;
  const float fN = (float)p.N;
  for (int c = cbeg + tid / kFinalLanes; c < cend; c += kThreads / kFinalLanes) {
    const int lane = tid % kFinalLanes;
    float g = 0.0f, b = 0.0f;
    // kFinalLoads partials a lane loaded at once, then added in order
    for (int s0 = lane; s0 < p.spans; s0 += kFinalLoads * kFinalLanes) {
      float pg[kFinalLoads], pb[kFinalLoads];
#pragma unroll
      for (int i = 0; i < kFinalLoads; ++i) {
        const int s = s0 + i * kFinalLanes;
        pg[i] = s < p.spans ? __ldcg(p.partial + (2LL * s) * p.C + c) : 0.0f;
        pb[i] = s < p.spans ? __ldcg(p.partial + (2LL * s + 1) * p.C + c) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kFinalLoads; ++i) {
        g += pg[i];
        b += pb[i];
      }
    }
#pragma unroll
    for (int o = kFinalLanes / 2; o > 0; o /= 2) {
      g += __shfl_xor_sync(0xffffffffu, g, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      p.dgamma[c] = g;
      p.dbeta[c] = b;
      if constexpr (!kSumsOnly) {
        coef[c] = __fdiv_rn(b, fN);
        coef[p.C + c] = __fdiv_rn(g, fN);
      }
    }
  }
  if constexpr (kSumsOnly) return;
  grid.sync();  // the sums are final

  // pass 2: dx, newest row first
  float bn[V], gn[V];  // dbeta / N, dgamma / N
  load_channels<V, true>(coef + c0, bn);
  load_channels<V, true>(coef + p.C + c0, gn);
  auto dx_row = [&](const Raw& xv, const Raw& dv, long long off) {
    float xf[V], df[V], o[V];
    A::unpack(xv, xf);
    A::unpack(dv, df);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = __fmul_rn(__fsub_rn(xf[k], m[k]), r[k]);
      o[k] = __fmul_rn(a[k], __fsub_rn(__fsub_rn(df[k], bn[k]), __fmul_rn(xhat, gn[k])));
    }
    __stcs(dxg + off, A::pack(o));  // evict-first: x and dy keep the L2
  };
  if constexpr (kVec) {
    // the q-th row written is j = n - 1 - q, two an iteration.  The newest
    // `slots` rows are in the ring; once row j is written its slot takes row
    // j - slots.  Row j's copy, if any, is at least slots - 1 groups old when
    // it is read, and slots > kAhead + 1 wherever a thread has more rows than
    // slots (bn_bwd_plan).
    int s = ((n - 1) % max(p.slots, 1)) * kThreads + tid;  // the slot of row n - 1
    auto refill = [&](int s, int j) {
      if (j >= p.slots) fetch(s, j - p.slots);
      cp_async_commit();
    };
    for (int q = 0; q < n; q += 2) {
      const int j = n - 1 - q;
      const int s1 = prev_slot(s);
      cp_async_wait<kAhead>();
      const Raw x0 = xs[s], d0 = ds[s];
      if (j > 0) {
        const Raw x1 = xs[s1], d1 = ds[s1];
        dx_row(x0, d0, at(j));
        dx_row(x1, d1, at(j - 1));
        refill(s, j);
        refill(s1, j - 1);
      } else {
        dx_row(x0, d0, at(j));
      }
      s = prev_slot(s1);
    }
  } else {
#pragma unroll 4
    for (int j = n - 1; j >= 0; --j) dx_row(xg[at(j)], dg[at(j)], at(j));
  }
}

// pass 2 of the two-pass mode: dx for rows [0, N) from the global sums
// dgamma, dbeta and the global row count n_total
struct DxParams {
  const void* x;
  const void* dy;
  const float* mean;
  const float* rstd;
  const float* weight;
  const float* dgamma;
  const float* dbeta;
  void* dx;
  long long N;
  int C;
  float n_total;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) bn_dx_kernel(const DxParams p) {
  using A = Access<T, kVec>;
  using Raw = typename A::Raw;
  constexpr int V = A::kN;
  // this CTA: 16-byte columns [col0, col0 + ncols) of channel group
  // blockIdx.y, rows blockIdx.x * lanes + sub, then every gridDim.x * lanes-th
  const int row_cols = p.C / V;
  const int col0 = blockIdx.y * kThreads;
  const int ncols = min(kThreads, row_cols - col0);
  const int lanes = kThreads / ncols;
  const int sub = threadIdx.x / ncols;
  if (sub >= lanes) return;
  const int col = col0 + threadIdx.x % ncols;
  const int c0 = col * V;
  float mu[V], rs[V], wr[V], cb[V], cg[V];  // wr: w * rstd; cb, cg: dbeta / n, dgamma / n
  load_channels<V>(p.mean + c0, mu);
  load_channels<V>(p.rstd + c0, rs);
  load_channels<V>(p.weight + c0, wr);
  load_channels<V>(p.dbeta + c0, cb);
  load_channels<V>(p.dgamma + c0, cg);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    wr[k] = __fmul_rn(wr[k], rs[k]);
    cb[k] = __fdiv_rn(cb[k], p.n_total);
    cg[k] = __fdiv_rn(cg[k], p.n_total);
  }
  const Raw* xg = reinterpret_cast<const Raw*>(p.x);
  const Raw* dg = reinterpret_cast<const Raw*>(p.dy);
  Raw* dxg = reinterpret_cast<Raw*>(p.dx);
  const long long stride = (long long)gridDim.x * lanes;
  for (long long row = (long long)blockIdx.x * lanes + sub; row < p.N; row += stride) {
    const long long off = row * row_cols + col;
    float xf[V], d[V], o[V];
    A::unpack(xg[off], xf);
    A::unpack(dg[off], d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = __fmul_rn(__fsub_rn(xf[k], mu[k]), rs[k]);
      const float centred = __fsub_rn(d[k], cb[k]);
      o[k] = __fmul_rn(wr[k], __fsub_rn(centred, __fmul_rn(xh, cg[k])));
    }
    dxg[off] = A::pack(o);
  }
}

template <typename T, bool kVec, bool kSumsOnly>
int launch(const Params& p, int smem, cudaStream_t stream) {
  const void* kernel = (const void*)bn_backward_kernel<T, kVec, kSumsOnly>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(p.spans * p.groups), dim3(kThreads), args,
                                    (size_t)smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x, dy, dx [N, C] row-major (channels-last activations, N = B*H*W) of one
// type (dtype 0 = float32, 1 = bfloat16); mean, rstd, weight float32 [C];
// dgamma, dbeta float32 [C] outputs; partial float32 [spans + 1, 2, C]
// scratch.
// The launch is ops/batchnorm.py::bn_bwd_plan's: spans * groups CTAs of
// 256 threads, `slots` ring rows a thread and `smem` bytes of shared memory
// (2 * 16 * 256 * slots + the reduction buffer); spans * groups CTAs must
// all be resident (the launch is refused otherwise), and slots must exceed
// kAhead wherever a thread has more rows than slots.  vec = 1 takes 16-byte
// loads and stores, which needs C to be a multiple of 16 / sizeof(T) and x,
// dy, dx, mean, rstd and weight 16-byte aligned; the caller checks.  All on the device of
// `stream`, which the caller makes the current device.  Returns the CUDA
// error of the launch (0 = none).
extern "C" int bn_backward(const void* x, const void* dy, const void* mean, const void* rstd,
                           const void* weight, void* dx, void* dgamma, void* dbeta,
                           void* partial, long long N, int C, int spans, int groups, int slots,
                           int smem, int dtype, int vec, void* stream) {
  Params p{x,
           dy,
           (const float*)mean,
           (const float*)rstd,
           (const float*)weight,
           dx,
           (float*)dgamma,
           (float*)dbeta,
           (float*)partial,
           N,
           C,
           spans,
           groups,
           vec ? slots : 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vec) return launch<float, true, false>(p, smem, s);
  if (dtype == 0) return launch<float, false, false>(p, smem, s);
  if (vec) return launch<__nv_bfloat16, true, false>(p, smem, s);
  return launch<__nv_bfloat16, false, false>(p, smem, s);
}

// Pass 1 of the two-pass mode: bn_backward's launch (the same plan and
// arguments, weight and dx unread) up to dgamma and dbeta, which are
// bit-equal to bn_backward's.
extern "C" int bn_backward_sums(const void* x, const void* dy, const void* mean,
                                const void* rstd, void* dgamma, void* dbeta, void* partial,
                                long long N, int C, int spans, int groups, int slots, int smem,
                                int dtype, int vec, void* stream) {
  Params p{x,       dy,      (const float*)mean, (const float*)rstd, nullptr, nullptr,
           (float*)dgamma, (float*)dbeta, (float*)partial, N, C, spans, groups,
           vec ? slots : 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vec) return launch<float, true, true>(p, smem, s);
  if (dtype == 0) return launch<float, false, true>(p, smem, s);
  if (vec) return launch<__nv_bfloat16, true, true>(p, smem, s);
  return launch<__nv_bfloat16, false, true>(p, smem, s);
}

template <typename T, bool kVec>
int launch_dx(const DxParams& p, int ctas, cudaStream_t stream) {
  const int groups = (p.C / Access<T, kVec>::kN + kThreads - 1) / kThreads;
  bn_dx_kernel<T, kVec><<<dim3(ctas, groups), dim3(kThreads), 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// Pass 2 of the two-pass mode: dx [N, C] (x's layout and type) from x, dy,
// mean, rstd, weight and the global dgamma, dbeta (float32 [C], summed over
// every process's rows) and the global row count n_total; `ctas` CTAs of
// 256 threads for each group of 256 16-byte columns (vec, as bn_backward's)
// or channels.  Returns the CUDA error of the launch (0 = none).
extern "C" int bn_backward_dx(const void* x, const void* dy, const void* mean, const void* rstd,
                              const void* weight, const void* dgamma, const void* dbeta,
                              void* dx, long long N, int C, float n_total, int ctas, int dtype,
                              int vec, void* stream) {
  DxParams p{x,  dy, (const float*)mean, (const float*)rstd, (const float*)weight,
             (const float*)dgamma, (const float*)dbeta, dx, N, C, n_total};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vec) return launch_dx<float, true>(p, ctas, s);
  if (dtype == 0) return launch_dx<float, false>(p, ctas, s);
  if (vec) return launch_dx<__nv_bfloat16, true>(p, ctas, s);
  return launch_dx<__nv_bfloat16, false>(p, ctas, s);
}
