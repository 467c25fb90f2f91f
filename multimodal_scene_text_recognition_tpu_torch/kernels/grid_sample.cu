// Bilinear warp for single-channel images: border padding, align_corners.
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// grid_sample.py::_grid_sample_kernel, which forms the warp as a dense
// hat-weight matmul  out[n] = sum_r sum_c wy[n,r] * wx[n,c] * I[r,c]  with
// w = relu(1 - |src - idx|) so that the TPU's matrix unit does the work.
// Only the floor and ceil taps of each hat are non-zero, so here one thread
// per output pixel reads those four taps directly: the same function without
// the H*W-wide sums.
//
// Bound: bytes.  Each output pixel reads two grid coordinates and writes one
// value (12 bytes) and does ~20 flops; the image (12.8 KB per crop) stays in
// L1/L2.  At B=192 the whole call moves ~9.8 MB, about 3 us at 3.35 TB/s.
//
// All arithmetic is float32 and follows the TPU kernel's order: the source
// coordinate is ((g + 1) * 0.5) * (S - 1) clamped to [0, S - 1]; the row taps
// are combined first, then the column taps.

#include <cuda_runtime.h>

namespace {

__global__ void grid_sample_kernel(const float* __restrict__ img,
                                   const float2* __restrict__ grid,
                                   float* __restrict__ out,
                                   int B, int H, int W, int N) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N) return;
  int b = (int)(i / N);

  float2 g = __ldg(grid + i);  // (x, y), interleaved as the caller holds it
  float sx = (g.x + 1.0f) * 0.5f * (float)(W - 1);
  float sy = (g.y + 1.0f) * 0.5f * (float)(H - 1);
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

  const float* im = img + (long long)b * H * W;
  // rows first (wy over r), then columns (wx over c), as the hat-weight
  // matmul sums
  float c0 = wy0 * im[y0 * W + x0] + fy * im[y1 * W + x0];
  float c1 = wy0 * im[y0 * W + x1] + fy * im[y1 * W + x1];
  out[i] = wx0 * c0 + fx * c1;
}

}  // namespace

// img [B, H, W] float32, grid [B, N, 2] float32 (x, y), out [B, N] float32,
// all on the device of `stream`, which the caller makes the current device
extern "C" int grid_sample_f32(const void* img, const void* grid, void* out,
                               int B, int H, int W, int N, void* stream) {
  long long total = (long long)B * N;
  if (total == 0) return 0;
  int threads = 256;
  int blocks = (int)((total + threads - 1) / threads);
  grid_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float2*)grid, (float*)out, B, H, W, N);
  return (int)cudaGetLastError();
}
