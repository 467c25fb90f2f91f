// BatchNorm backward reduction over channels-last (NHWC) activations:
//
//   dgamma[c] = sum over rows n of dy[n, c] * (x[n, c] - mean[c]) * rstd[c]
//   dbeta[c]  = sum over rows n of dy[n, c]
//
// with x, dy [N, C] row-major, N = B*H*W: the memory of a [B, C, H, W]
// tensor in torch's channels_last format, which is how the port's cuDNN
// convs hand their outputs over (and read as they are: no layout copy).
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// batchnorm.py::_bn_bwd_reduce_kernel, which walks the same [N, C] rows in a
// sequential grid of 1024-row tiles and carries the two sums in VMEM scratch
// from one grid step to the next.  CTAs run in parallel and in no order, so
// here the sum is split in two passes with no float atomics, which keeps the
// result the same from run to run:
//
//   1. a grid (channel group, chunk of rows): each thread owns one 16-byte
//      column of a row (8 bfloat16 or 4 float32 channels; one element where
//      C is not a multiple of that) and walks the chunk's rows a CTA-width
//      apart, keeping float32 sums in registers; the CTA adds its threads'
//      sums per channel in a fixed order through shared memory and writes one
//      partial pair per channel to a [chunks, 2, C] workspace;
//   2. a CTA per 8 channels adds the chunks' partials: 32 lanes of threads
//      each sum a fixed stride of chunks in order (32-byte reads of 8
//      adjacent channels), then the lanes' sums are added in lane order.
//
// Where a channel group is the whole row (C up to 512 bfloat16 or 256
// float32 channels), a CTA's reads are one contiguous span of memory.
//
// Bound: bytes.  Each element of x and dy is read once (~4 flops per
// element pair), so the least time is 2 * N*C * sizeof(T) over the card's
// memory rate: 157 MB, 0.047 ms at 3.35 TB/s for the largest launch of a
// training step, [192, 64, 32, 100] in bfloat16.  The caller picks the
// chunks: about eight CTAs an SM, but at least 16 rows a thread, so that the
// workspace stays small beside the input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;  // 16-byte columns per channel group
constexpr int kUnroll = 4;    // rows of x and of dy in flight per thread

// One load of kN channels of T, widened to float32.
template <typename T, bool kVec>
struct Access;

template <>
struct Access<float, false> {
  using Raw = float;
  static constexpr int kN = 1;
  __device__ static void unpack(const Raw& v, float* out) { out[0] = v; }
};

template <>
struct Access<__nv_bfloat16, false> {
  using Raw = __nv_bfloat16;
  static constexpr int kN = 1;
  __device__ static void unpack(const Raw& v, float* out) {
    out[0] = __bfloat162float(v);
  }
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
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          float* __restrict__ partial, long long N, int C,
                          long long rows_per_chunk) {
  using A = Access<T, kVec>;
  using Raw = typename A::Raw;
  constexpr int V = A::kN;
  // this CTA: 16-byte columns [col0, col0 + ncols) of rows [r0, r1)
  const int row_cols = C / V;  // columns in a row
  const int col0 = blockIdx.x * kMaxCols;
  const int ncols = min(kMaxCols, row_cols - col0);
  const int lanes_rows = kThreads / ncols;  // rows read side by side
  const int col = threadIdx.x % ncols;
  const int sub = threadIdx.x / ncols;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(N, r0 + rows_per_chunk);
  const Raw* xr = reinterpret_cast<const Raw*>(x) + col0 + col;
  const Raw* dr = reinterpret_cast<const Raw*>(dy) + col0 + col;
  const int c0 = (col0 + col) * V;  // first channel of this thread

  float m[V], r[V], acc_g[V], acc_b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = mean[c0 + k];
    r[k] = rstd[c0 + k];
    acc_g[k] = 0.0f;
    acc_b[k] = 0.0f;
  }
  if (sub < lanes_rows) {
    for (long long row = r0 + sub; row < r1; row += (long long)lanes_rows * kUnroll) {
      Raw xv[kUnroll], dv[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long n = row + (long long)u * lanes_rows;
        ok[u] = n < r1;
        if (ok[u]) {
          xv[u] = xr[n * row_cols];
          dv[u] = dr[n * row_cols];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        float xf[V], df[V];
        A::unpack(xv[u], xf);
        A::unpack(dv[u], df);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc_g[k] = fmaf(df[k], (xf[k] - m[k]) * r[k], acc_g[k]);
          acc_b[k] += df[k];
        }
      }
    }
  }

  // per channel, the threads' sums in the order of their row lane
  __shared__ float red[2][kThreads * V];
  if (sub < lanes_rows) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][sub * ncols * V + col * V + k] = acc_g[k];
      red[1][sub * ncols * V + col * V + k] = acc_b[k];
    }
  }
  __syncthreads();
  const int width = ncols * V;  // channels of this CTA
  for (int j = threadIdx.x; j < width; j += kThreads) {
    float g = 0.0f, b = 0.0f;
    for (int s = 0; s < lanes_rows; ++s) {
      g += red[0][s * width + j];
      b += red[1][s * width + j];
    }
    const int c = col0 * V + j;
    partial[(2LL * blockIdx.y) * C + c] = g;
    partial[(2LL * blockIdx.y + 1) * C + c] = b;
  }
}

constexpr int kFinalChannels = 8;  // channels per finalize CTA
constexpr int kFinalLanes = 32;    // chunk lanes per channel

__global__ void __launch_bounds__(kFinalChannels * kFinalLanes)
    bn_bwd_finalize_kernel(const float* __restrict__ partial,
                           float* __restrict__ dgamma,
                           float* __restrict__ dbeta, int C, int chunks) {
  const int cc = threadIdx.x % kFinalChannels;
  const int lane = threadIdx.x / kFinalChannels;
  const int c = blockIdx.x * kFinalChannels + cc;
  float g = 0.0f, b = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (int k = lane; k < chunks; k += kFinalLanes) {  // the same order every run
      g += partial[(2LL * k) * C + c];
      b += partial[(2LL * k + 1) * C + c];
    }
  }
  __shared__ float sg[kFinalLanes][kFinalChannels], sb[kFinalLanes][kFinalChannels];
  sg[lane][cc] = g;
  sb[lane][cc] = b;
  __syncthreads();
  if (lane == 0 && c < C) {
    for (int l = 1; l < kFinalLanes; ++l) {
      g += sg[l][cc];
      b += sb[l][cc];
    }
    dgamma[c] = g;
    dbeta[c] = b;
  }
}

template <typename T, bool kVec>
void launch(const void* x, const void* dy, const float* mean,
            const float* rstd, float* partial, long long N, int C, int chunks,
            long long rows_per_chunk, cudaStream_t stream) {
  const int row_cols = C / Access<T, kVec>::kN;
  dim3 grid((row_cols + kMaxCols - 1) / kMaxCols, chunks);
  bn_bwd_partial_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dy, mean, rstd, partial, N, C, rows_per_chunk);
}

}  // namespace

// x, dy [N, C] row-major (channels-last activations, N = B*H*W), of one
// type (dtype 0 = float32, 1 = bfloat16); mean, rstd float32 [C]; partial
// float32 [chunks, 2, C] scratch; dgamma, dbeta float32 [C] outputs.
// chunks * rows_per_chunk >= N and chunks <= 65535.  vec = 1 takes 16-byte
// loads, which needs C to be a multiple of 16 / sizeof(T) and x, dy 16-byte
// aligned; the caller checks.  All on the device of `stream`, which the
// caller makes the current device.  Returns the CUDA error of the launches
// (0 = none).
extern "C" int bn_bwd_reduce(const void* x, const void* dy, const void* mean,
                             const void* rstd, void* partial, void* dgamma,
                             void* dbeta, long long N, int C, int chunks,
                             long long rows_per_chunk, int dtype, int vec,
                             void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mean;
  const float* r = (const float*)rstd;
  float* p = (float*)partial;
  if (dtype == 0 && vec)
    launch<float, true>(x, dy, m, r, p, N, C, chunks, rows_per_chunk, s);
  else if (dtype == 0)
    launch<float, false>(x, dy, m, r, p, N, C, chunks, rows_per_chunk, s);
  else if (vec)
    launch<__nv_bfloat16, true>(x, dy, m, r, p, N, C, chunks, rows_per_chunk, s);
  else
    launch<__nv_bfloat16, false>(x, dy, m, r, p, N, C, chunks, rows_per_chunk, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_bwd_finalize_kernel<<<(C + kFinalChannels - 1) / kFinalChannels,
                           kFinalChannels * kFinalLanes, 0, s>>>(
      p, (float*)dgamma, (float*)dbeta, C, chunks);
  return (int)cudaGetLastError();
}
