// Crop + bilinear resize of grayscale uint8 crops on the host, the
// preparation of uint8 crops that are not the model's input size
// (ops/resize.py; the JAX package's native/imgproc.cpp, whose two
// functions these are).
//
// Sampling convention: half-pixel centres (align_corners=false), source
// coordinates clamped to the crop box, output float32 in [0, 1].
//
// The JAX package builds its copy with -O3 -march=native, where GCC fuses
// five multiply-adds into FMAs on a CPU that has them.  Here those five are
// written as std::fmaf and the build passes -ffp-contract=off (ops/resize.py),
// so the result is that library's bit for bit on such a CPU, and does not
// depend on the flags or the CPU this copy is built for.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Crop `src` (h x w, row-major uint8) to the xywh box and bilinear-resize to
// (oh x ow) float32 in [0, 1].
void crop_resize_gray(const uint8_t* src, int h, int w,
                      float bx, float by, float bw, float bh,
                      float* out, int oh, int ow) {
  if (bw <= 0.f) bw = 1.f;
  if (bh <= 0.f) bh = 1.f;
  const float sx = bw / ow;
  const float sy = bh / oh;
  for (int oy = 0; oy < oh; ++oy) {
    // half-pixel-centre source coordinate, clamped into the crop box
    float fy = std::fmaf(oy + 0.5f, sy, by) - 0.5f;
    fy = std::min(std::max(fy, by), by + bh - 1.f);
    fy = std::min(std::max(fy, 0.f), (float)(h - 1));
    const int y0 = (int)fy;
    const int y1 = std::min(y0 + 1, h - 1);
    const float wy = fy - y0;
    const uint8_t* row0 = src + (size_t)y0 * w;
    const uint8_t* row1 = src + (size_t)y1 * w;
    float* orow = out + (size_t)oy * ow;
    for (int ox = 0; ox < ow; ++ox) {
      float fx = std::fmaf(ox + 0.5f, sx, bx) - 0.5f;
      fx = std::min(std::max(fx, bx), bx + bw - 1.f);
      fx = std::min(std::max(fx, 0.f), (float)(w - 1));
      const int x0 = (int)fx;
      const int x1 = std::min(x0 + 1, w - 1);
      const float wx = fx - x0;
      const float top = std::fmaf(row0[x0], 1.f - wx, row0[x1] * wx);
      const float bot = std::fmaf(row1[x0], 1.f - wx, row1[x1] * wx);
      orow[ox] = std::fmaf(top, 1.f - wy, bot * wy) * (1.f / 255.f);
    }
  }
}

// Batched, multithreaded variant.  srcs[i] points at an (hs[i] x ws[i])
// grayscale page; boxes is n x 4 xywh; out is n x oh x ow float32.
void crop_resize_gray_batch(const uint8_t** srcs, const int* hs, const int* ws,
                            const float* boxes, int n,
                            float* out, int oh, int ow, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      const float* b = boxes + (size_t)i * 4;
      crop_resize_gray(srcs[i], hs[i], ws[i], b[0], b[1], b[2], b[3],
                       out + (size_t)i * oh * ow, oh, ow);
    }
  };
  if (threads == 1 || n == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  const int k = std::min(threads, n);
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
