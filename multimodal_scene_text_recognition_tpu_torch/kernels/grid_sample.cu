// Bilinear warp for single-channel images: border padding, align_corners.
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// grid_sample.py::_grid_sample_kernel, which forms the warp as a dense
// hat-weight matmul  out[n] = sum_r sum_c wy[n,r] * wx[n,c] * I[r,c]  with
// w = relu(1 - |src - idx|) so that the TPU's matrix unit does the work.
// Only the floor and ceil taps of each hat are non-zero, so here each output
// pixel reads those four taps directly: the same function without the
// H*W-wide sums.
//
// Bound: bytes.  Each output pixel reads two grid coordinates and writes one
// value (12 bytes) and does ~20 flops; each crop's image (12.8 KB at 32x100)
// is read once.  At B=192 the whole call moves ~9.8 MB, about 3 us at
// 3.35 TB/s.
//
// Design: one CTA a crop.  Thread 0 stages the crop's image in shared memory
// with one bulk asynchronous copy (cp.async.bulk, counted on an mbarrier)
// while every thread loads its first grid coordinates; the four taps of a
// pixel are then shared-memory reads, not dependent global gathers.  Each
// thread takes 4 consecutive output pixels: two 16-byte grid loads and one
// 16-byte store.  Where the pixels of a crop are not a multiple of 4 (the
// crops' rows of the output and grid are then not 16-byte aligned) a thread
// takes one pixel at a time; where the image's bytes are not a multiple of
// 16 the threads stage it with plain loads.
//
// All arithmetic is float32 and follows the TPU kernel's order: the source
// coordinate is ((g + 1) * 0.5) * (S - 1) clamped to [0, S - 1]; the row taps
// are combined first, then the column taps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  // the barrier's initialisation, visible to the copy engine
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` from global `src` into shared `dst`, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

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

__device__ __forceinline__ float sample(const float* im, float gx, float gy, int H, int W) {
  float sx = (gx + 1.0f) * 0.5f * (float)(W - 1);
  float sy = (gy + 1.0f) * 0.5f * (float)(H - 1);
  // border padding: clamp the source coordinate (fminf/fmaxf also map a
  // NaN coordinate into range, so no read ever leaves the image)
  sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
  sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));

  int x0 = (int)floorf(sx);
  int y0 = (int)floorf(sy);
  int x1 = min(x0 + 1, W - 1);
  int y1 = min(y0 + 1, H - 1);
  float fx = sx - (float)x0;  // weight of the ceil tap
  float fy = sy - (float)y0;
  float wx0 = 1.0f - fx, wy0 = 1.0f - fy;

  // rows first (wy over r), then columns (wx over c), as the hat-weight
  // matmul sums
  float c0 = wy0 * im[y0 * W + x0] + fy * im[y1 * W + x0];
  float c1 = wy0 * im[y0 * W + x1] + fy * im[y1 * W + x1];
  return wx0 * c0 + fx * c1;
}

// crop blockIdx.x: img [H, W], grid [N, 2] (x, y), out [N]
template <bool kQuad>
__global__ void __launch_bounds__(kMaxThreads)
    grid_sample_kernel(const float* __restrict__ img, const float* __restrict__ grid,
                       float* __restrict__ out, int H, int W, int N, int bulk) {
  extern __shared__ __align__(16) float im[];
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* src = img + b * H * W;
  if (bulk) {
    if (tid == 0) mbar_init(&bar, 1);
    __syncthreads();
    if (tid == 0) bulk_copy(im, src, (unsigned)(H * W * 4), &bar);
  } else {
    for (int i = tid; i < H * W; i += blockDim.x) im[i] = __ldg(src + i);
  }

  if constexpr (kQuad) {
    const float4* g4 = reinterpret_cast<const float4*>(grid + b * N * 2);
    float4* o4 = reinterpret_cast<float4*>(out + b * N);
    const int quads = N / 4;
    int q = tid;
    float4 ga, gb;  // the quad's (x, y) pairs, loaded while the image lands
    if (q < quads) {
      ga = __ldg(g4 + 2 * q);
      gb = __ldg(g4 + 2 * q + 1);
    }
    if (bulk)
      mbar_wait(&bar, 0);
    else
      __syncthreads();
    for (; q < quads; q += blockDim.x) {
      float4 na, nb;
      const int nq = q + blockDim.x;
      if (nq < quads) {
        na = __ldg(g4 + 2 * nq);
        nb = __ldg(g4 + 2 * nq + 1);
      }
      float4 o;
      o.x = sample(im, ga.x, ga.y, H, W);
      o.y = sample(im, ga.z, ga.w, H, W);
      o.z = sample(im, gb.x, gb.y, H, W);
      o.w = sample(im, gb.z, gb.w, H, W);
      o4[q] = o;
      ga = na;
      gb = nb;
    }
  } else {
    const float* g = grid + b * N * 2;
    float* o = out + b * N;
    if (bulk)
      mbar_wait(&bar, 0);
    else
      __syncthreads();
    for (int i = tid; i < N; i += blockDim.x)
      o[i] = sample(im, __ldg(g + 2 * i), __ldg(g + 2 * i + 1), H, W);
  }
}

}  // namespace

// img [B, H, W] float32, grid [B, N, 2] float32 (x, y), out [B, N] float32,
// all on the device of `stream`, which the caller makes the current device.
// One CTA a crop, with H * W * 4 bytes of shared memory (at most 227 KB;
// the caller checks).  quad = 1 takes 4 pixels a thread with 16-byte loads
// and stores, which needs N to be a multiple of 4 and grid and out 16-byte
// aligned; bulk = 1 stages the image with one bulk copy, which needs H * W
// to be a multiple of 4 and img 16-byte aligned.  The caller checks both.
extern "C" int grid_sample_f32(const void* img, const void* grid, void* out, int B, int H,
                               int W, int N, int quad, int bulk, void* stream) {
  if ((long long)B * N == 0) return 0;
  const int work = quad ? N / 4 : N;
  const int threads = min(kMaxThreads, max(32, (work + 31) / 32 * 32));
  const int smem = H * W * 4;
  const void* kernel = quad ? (const void*)grid_sample_kernel<true>
                            : (const void*)grid_sample_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (quad)
    grid_sample_kernel<true><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)grid, (float*)out, H, W, N, bulk);
  else
    grid_sample_kernel<false><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)grid, (float*)out, H, W, N, bulk);
  return (int)cudaGetLastError();
}
