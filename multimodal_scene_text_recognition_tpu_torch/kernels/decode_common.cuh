// Pieces shared by the decode kernels (fused_decode.cu, fused_beam_grid.cu): the
// compute-type conversions, 16-byte weight loads widened to float, the
// projection epilogues, and the per-row rounding and layernorm over a tile
// of R rows held in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float to_f(float v) { return v; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float from_f(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

enum Epilogue { kPlain = 0, kReluRound = 1 };

// 16-byte weight loads: 4 floats or 8 bf16 widened to float
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kW = 4;
  __device__ static void load(const float* p, float (&w)[4]) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kW = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&w)[8]) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <typename T, int EPI>
__device__ float epilogue(float acc, const T* b, int j) {
  float v = acc + Num<T>::load(b + j);
  return EPI == kReluRound ? Num<T>::round(fmaxf(v, 0.0f)) : v;
}

// xin[k * R + r] = round_T(src[r * stride + k]) for k < K
template <typename T>
__device__ void round_rows(const float* src, int R, int stride, int K,
                           float* xin) {
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) {
    int r = i / K, k = i - r * K;
    xin[k * R + r] = Num<T>::round(src[r * stride + k]);
  }
}

__device__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x[r] = layernorm(x[r] + add[r]) in float32, one warp per row
template <typename T>
__device__ void add_layernorm(float* xs, int R, const float* add,
                              int add_stride, const T* s, const T* b, int E,
                              float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += blockDim.x >> 5) {
    float* x = xs + r * E;
    float sum = 0.0f;
    for (int e = lane; e < E; e += 32) {
      if (add != nullptr) x[e] += add[r * add_stride + e];
      sum += x[e];
    }
    float mean = warp_sum(sum) / (float)E;
    float sq = 0.0f;
    for (int e = lane; e < E; e += 32) {
      float d = x[e] - mean;
      sq += d * d;
    }
    float inv = rsqrtf(warp_sum(sq) / (float)E + eps);
    for (int e = lane; e < E; e += 32)
      x[e] = (x[e] - mean) * inv * Num<T>::to_f(s[e]) + Num<T>::to_f(b[e]);
  }
}

}  // namespace
