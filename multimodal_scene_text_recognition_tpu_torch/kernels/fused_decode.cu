// Whole greedy decode loop of the transformer decoder in one kernel, with
// the six projections int8 (K1q).
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// fused_decode.py::_decode_kernel with quantized=True (K1q,
// fused_decode_int8), with its eos_id early stop and its cls0 step-0 row,
// where ops/fused_decode.k1q_route sends it: batches of at most 96 rows
// (one CTA a row beats a 16-row cluster tile there on an H100) and rows
// wider than the cluster kernel's 512; elsewhere K1q is the int8 mode of
// fused_decode_cluster.cu, as K1 is its float mode.  For T steps it embeds
// the previous token, runs L decoder layers (packed qkv -> self-attention
// KV-cache write -> causal attention -> out-proj -> LN -> cross-q ->
// attention over the precomputed memory K/V -> out-proj -> LN -> ReLU FF ->
// LN), the final LN and the class head, writes logits[b, t, :] and feeds the
// first-index argmax back.
//
// cls0 (cls_decoder_init, the TPU kernel's use_cls row): when the launcher
// gets a non-null [B, E] float32 pointer, step 0's input row is cls0[b] +
// pe[0] in float32, unrounded, in place of emb[go_id] + pe[0], and is
// quantized as it stands.  Only the load of that one row differs; shared
// memory and the loop do not.
//
// Early stop (eos_id >= 0): a row that has emitted eos_id writes no further
// logits (the caller prefilled them with the eos_id one-hot), and a CTA
// leaves its loop once every row of its tile has stopped.  Rows are
// independent, so this needs no flag shared between CTAs.
//
// Design.  Rows of the batch are independent, so each CTA owns a fixed tile
// of R rows (template parameter, built for kRows = 1) and loops over t and
// l itself: there is no grid-wide barrier, no flag shared between CTAs and
// no cooperative launch, so the kernel cannot deadlock whatever the number
// of resident CTAs.  The per-row activations (x, qkv, context, the FF
// hidden) live in shared memory in float32.  The self-attention caches [L,
// B, T, E] live in device memory in the compute type (row-major per batch
// row, so each CTA touches only its own rows); only positions <= t are ever
// read.  Weights are read from device memory, where L2 keeps them.
//
// The six projections run as the TPU kernel's quantized `lin`: each
// quantizes its float32 input row as it stands (not rounded to T: the
// residual stream, the attention contexts and the ReLU output of ff1 stay
// unrounded) with the row's abs-max (a block reduction in shared memory;
// scale abs-max / 127, rintf, half to even, clipped to +-127) into an int8
// row in shared memory, and multiplies it by an int8 table repacked in
// groups of four K-rows ([L, K/4, N, 4], one 32-bit word per column and
// group), accumulating __dp4a products in int32: exact, so the split-K
// partial sums meet in any order.  The epilogue dequantizes as acc *
// ((absmax / 127) * channel scale) + bias in that order, with
// __fmul_rn/__fadd_rn so no FMA contraction changes the rounding.  The
// embedding, attention, layernorms and class head follow the TPU kernel's
// casts for compute type T (float or bf16): the class head's input rounded
// to T and accumulated in float32; the q*K products rounded to T before the
// per-head sum; the probabilities rounded to T and probs*V formed in T and
// summed in float32; layernorm, softmax and logits float32; the argmax
// takes the first index of the maximum.
//
// Bound: each CTA reads every int8 table of a step through __ldg (8.65 MB
// at the flagship), so the kernel is bound in practice by L2 reads per SM
// once many rows run at once (from ~96 rows at the flagship); the dp4a
// products are CUDA-core work.

#include <stdint.h>

#include "decode_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 1;  // batch rows per CTA

template <typename T>
struct Params {
  // per-layer tables stacked on a leading L axis, matrices [in, out]
  const T *w_qkv, *b_qkv, *w_out, *b_out, *cw_q, *cb_q, *cw_o, *cb_o;
  const T *ff1_w, *ff1_b, *ff2_w, *ff2_b;
  const T *n1_s, *n1_b, *n2_s, *n2_b, *n3_s, *n3_b;
  const T *fn_s, *fn_b, *head_w, *head_b, *emb;
  const float* pe;  // [T, E]
  const float* cls0;  // [B, E] step-0 rows, or null: emb[go_id]
  const T *ck, *cv;  // cross K/V [L, B, Tm, E]
  T *kc, *vc;        // self-attention caches [L, B, T, E]
  float* logits;     // [B, T, C]
  // the six projection tables (qkv, out, cross-q, cross-out, ff1, ff2) int8
  // in groups of four K-rows [L, K/4, N, 4] (in the slots of w_qkv, w_out,
  // cw_q, cw_o, ff1_w and ff2_w), and their per-channel scales [L, N]
  // float32
  const int* qw[6];
  const float* qs[6];
  int B, steps, L, E, F, C, H, Tm, go_id;
  int eos_id;        // < 0: no early stop
  float eps, scale;  // layernorm epsilon, 1/sqrt(head_dim)
};

// acc[r][v] += sum_{k0 <= k < k1} xin[k * R + r] * W[k * N + v], four 16-byte
// loads in flight per thread
template <typename T, int R>
__device__ void dot_rows(const float* xin, const T* W, int N, int k0, int k1,
                         float (&acc)[R][Vec<T>::kW]) {
  constexpr int V = Vec<T>::kW;
  int k = k0;
  for (; k + 4 <= k1; k += 4) {
    float w[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) Vec<T>::load(W + (size_t)(k + u) * N, w[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xk = xin + (k + u) * R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = xk[r];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(x, w[u][v], acc[r][v]);
      }
    }
  }
  for (; k < k1; ++k) {
    float w[V];
    Vec<T>::load(W + (size_t)k * N, w);
    const float* xk = xin + k * R;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xk[r], w[v], acc[r][v]);
  }
}

// out[r * os_r + j * os_j] = epi(sum_k xin[k * R + r] * W[k * N + j] + b[j])
//
// xin holds the matmul input already rounded to T, k-major.  Each thread
// owns V = 16 / sizeof(T) adjacent output columns (one 16-byte load per k),
// so a warp reads 512 contiguous bytes of a weight row.  When there are
// fewer column groups than threads, the K range is split S ways and the
// partial sums meet in `red` (S * R * N floats, at most blockDim * V * R).
// Widths that are not a multiple of V (the class head) take one column per
// thread.  Called by every thread of the block; it synchronises internally
// when it splits K.
template <typename T, int R, int EPI>
__device__ void linear(const float* xin, int K, const T* __restrict__ W,
                       const T* __restrict__ b, int N, float* out, int os_r,
                       int os_j, float* red) {
  constexpr int V = Vec<T>::kW;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (N % V != 0) {
    for (int j = tid; j < N; j += nt) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int k = 0; k < K; ++k) {
        float w = Num<T>::load(W + (size_t)k * N + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xin[k * R + r], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        out[r * os_r + j * os_j] = epilogue<T, EPI>(acc[r], b, j);
    }
    return;
  }
  const int G = N / V;
  const int S = G >= nt ? 1 : nt / G;
  if (S == 1) {
    for (int g = tid; g < G; g += nt) {
      float acc[R][V] = {};
      dot_rows<T, R>(xin, W + g * V, N, 0, K, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          int j = g * V + v;
          out[r * os_r + j * os_j] = epilogue<T, EPI>(acc[r][v], b, j);
        }
    }
    return;
  }
  if (tid < G * S) {
    const int g = tid % G, s = tid / G;
    const int chunk = (K + S - 1) / S;
    const int k0 = min(K, s * chunk), k1 = min(K, k0 + chunk);
    float acc[R][V] = {};
    dot_rows<T, R>(xin, W + g * V, N, k0, k1, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) red[(s * R + r) * N + g * V + v] = acc[r][v];
  }
  __syncthreads();
  for (int i = tid; i < R * N; i += nt) {
    const int r = i / N, j = i - r * N;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += red[(s * R + r) * N + j];
    out[r * os_r + j * os_j] = epilogue<T, EPI>(acc, b, j);
  }
}

// Multi-head attention of R query rows over `len` cached positions.
// q[r * q_stride + d] (float32, rounded to T here); K/V hold row `row` at
// kv + row * kv_rows * E, position s at + s * E.  Writes the context into
// xin[d * R + r] as summed (K1q quantizes it unrounded).
template <typename T, int R>
__device__ void attention(const Params<T>& p, const float* q, int q_stride,
                          const T* K, const T* V, int kv_rows, int len,
                          int r0, int nrows, float* probs, int S, float* xin) {
  const int E = p.E, H = p.H, hd = E / H;
  const int n_scores = R * H * len;
  for (int i = threadIdx.x; i < n_scores; i += blockDim.x) {
    int r = i / (H * len), rem = i - r * H * len;
    int h = rem / len, s = rem - h * len;
    int row = r0 + min(r, nrows - 1);
    const float* qr = q + r * q_stride + h * hd;
    const T* kr = K + ((size_t)row * kv_rows + s) * E + h * hd;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d)
      acc += Num<T>::round(Num<T>::round(qr[d]) * Num<T>::to_f(kr[d]));
    probs[(r * H + h) * S + s] = acc * p.scale;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    float* pr = probs + i * S;
    float m = pr[0];
    for (int s = 1; s < len; ++s) m = fmaxf(m, pr[s]);
    float sum = 0.0f;
    for (int s = 0; s < len; ++s) {
      float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    for (int s = 0; s < len; ++s) pr[s] = Num<T>::round(pr[s] / sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * E; i += blockDim.x) {
    int r = i / E, d = i - r * E, h = d / hd;
    int row = r0 + min(r, nrows - 1);
    const float* pr = probs + (r * H + h) * S;
    const T* vr = V + (size_t)row * kv_rows * E + d;
    float acc = 0.0f;
    for (int s = 0; s < len; ++s)
      acc += Num<T>::round(pr[s] * Num<T>::to_f(vr[(size_t)s * E]));
    xin[d * R + r] = acc;
  }
  __syncthreads();
}

// The float32 value K1q quantizes: as it stands (not rounded to T).
template <typename T>
__device__ float quant_input(float v) {
  return v;
}

// K1q's dynamic per-row quantization of R rows of K values, src(r, k) =
// src[r * sr + k * sk]: amax[r] = max_k |src(r, k)| and amax[R + r] =
// 127 / max(amax[r], 1e-12), then xq[r * Kq + k] = clamp(rint(src(r, k) *
// amax[R + r]), -127, 127).  wred holds a max per warp and row.  Called by
// every thread of the block; synchronises before it returns.
template <typename T, int R>
__device__ void quantize_rows(const float* src, int sr, int sk, int K,
                              float* amax, float* wred, int8_t* xq, int Kq) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = 0.0f;
  for (int k = tid; k < K; k += nt)
#pragma unroll
    for (int r = 0; r < R; ++r)
      m[r] = fmaxf(m[r], fabsf(quant_input<T>(src[r * sr + k * sk])));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = warp_max(m[r]);
    if (lane == 0) wred[warp * R + r] = v;
  }
  __syncthreads();
  if (tid < R) {
    float v = 0.0f;
    for (int w = 0; w < nw; ++w) v = fmaxf(v, wred[w * R + tid]);
    amax[tid] = v;
    amax[R + tid] = 127.0f / fmaxf(v, 1e-12f);
  }
  __syncthreads();
  for (int i = tid; i < R * K; i += nt) {
    const int r = i / K, k = i - r * K;
    float v = rintf(quant_input<T>(src[r * sr + k * sk]) * amax[R + r]);
    xq[r * Kq + k] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
  }
  __syncthreads();
}

// K1q's epilogue: acc * ((absmax / 127) * s[j]) + b[j] in float32, in
// that order and without contraction, then ReLU for ff1.
template <typename T, bool RELU>
__device__ float epilogue_q(int acc, float absmax, const float* s, const T* b,
                            int j) {
  const float d = __fmul_rn(absmax / 127.0f, __ldg(s + j));
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), d), Num<T>::load(b + j));
  return RELU ? fmaxf(v, 0.0f) : v;
}

// acc[r][v] += the int8 dot products of row r's activation words [k0, k1)
// (xw[r * Kw + k], four K values a word) with the packed weight words of
// four adjacent columns (W[k * N + v], four K-rows a word), four 16-byte
// loads in flight per thread
template <int R>
__device__ void dot_rows_q(const int* xw, int Kw, const int* W, int N, int k0,
                           int k1, int (&acc)[R][4]) {
  int k = k0;
  for (; k + 4 <= k1; k += 4) {
    int4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = __ldg(reinterpret_cast<const int4*>(W + (size_t)(k + u) * N));
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = xw[r * Kw + k + u];
        acc[r][0] = __dp4a(a, w[u].x, acc[r][0]);
        acc[r][1] = __dp4a(a, w[u].y, acc[r][1]);
        acc[r][2] = __dp4a(a, w[u].z, acc[r][2]);
        acc[r][3] = __dp4a(a, w[u].w, acc[r][3]);
      }
  }
  for (; k < k1; ++k) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(W + (size_t)k * N));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = xw[r * Kw + k];
      acc[r][0] = __dp4a(a, w.x, acc[r][0]);
      acc[r][1] = __dp4a(a, w.y, acc[r][1]);
      acc[r][2] = __dp4a(a, w.z, acc[r][2]);
      acc[r][3] = __dp4a(a, w.w, acc[r][3]);
    }
  }
}

// K1q's projection: out[r * os_r + j * os_j] = epilogue_q(sum_k xq[r][k] *
// Wq[k][j]) for the int8 rows xq (row stride Kq bytes) and the packed table
// W [K/4][N][4] (K and N multiples of 4).  Each thread owns the four
// adjacent columns one 16-byte load brings (a warp reads 512 contiguous
// bytes of a packed row); with fewer column groups than threads the K range
// is split S ways and the int32 partial sums meet in `red`.  Not inlined:
// one body serves the six call sites (the fused beam kernel's build time
// fell from 95 s to seconds when its projection stopped being inlined).
template <typename T, int R, bool RELU>
__device__ __noinline__ void linear_q(const int8_t* xq, int Kq, int K,
                                      const int* __restrict__ W,
                                      const float* __restrict__ s,
                                      const T* __restrict__ b, int N,
                                      float* out, int os_r, int os_j,
                                      float* red, const float* amax) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Kw = Kq / 4, K4 = K / 4, G = N / 4;
  const int* xw = reinterpret_cast<const int*>(xq);
  const int S = G >= nt ? 1 : nt / G;
  if (S == 1) {
    for (int g = tid; g < G; g += nt) {
      int acc[R][4] = {};
      dot_rows_q<R>(xw, Kw, W + g * 4, N, 0, K4, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = g * 4 + v;
          out[r * os_r + j * os_j] = epilogue_q<T, RELU>(acc[r][v], amax[r], s, b, j);
        }
    }
    return;
  }
  int* ired = reinterpret_cast<int*>(red);
  if (tid < G * S) {
    const int g = tid % G, sp = tid / G;
    const int chunk = (K4 + S - 1) / S;
    const int k0 = min(K4, sp * chunk), k1 = min(K4, k0 + chunk);
    int acc[R][4] = {};
    dot_rows_q<R>(xw, Kw, W + g * 4, N, k0, k1, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) ired[(sp * R + r) * N + g * 4 + v] = acc[r][v];
  }
  __syncthreads();
  for (int i = tid; i < R * N; i += nt) {
    const int r = i / N, j = i - r * N;
    int acc = 0;
    for (int sp = 0; sp < S; ++sp) acc += ired[(sp * R + r) * N + j];
    out[r * os_r + j * os_j] = epilogue_q<T, RELU>(acc, amax[r], s, b, j);
  }
}

// K1q: quantize the R rows of src (src(r, k) = src[r * sr + k * sk]) and
// project them through int8 table `which` of layer l, bias `bias` [L, N].
template <typename T, int R, bool RELU>
__device__ void project_q(const Params<T>& p, int which, int l,
                          const float* src, int sr, int sk, int K,
                          const T* bias, int N, float* out, int os_r, int os_j,
                          float* red, float* amax, float* wred, int8_t* xq,
                          int Kq) {
  quantize_rows<T, R>(src, sr, sk, K, amax, wred, xq, Kq);
  linear_q<T, R, RELU>(xq, Kq, K, p.qw[which] + (size_t)l * (K / 4) * N,
                       p.qs[which] + (size_t)l * N, bias + (size_t)l * N, N,
                       out, os_r, os_j, red, amax);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params<T> p) {
  extern __shared__ float smem[];
  const int E = p.E, F = p.F, C = p.C, H = p.H, T_ = p.steps, L = p.L;
  const int S = max(p.steps, p.Tm);
  float* xs = smem;               // [R][E]   residual stream
  float* xin = xs + R * E;        // [E][R]   matmul input (the context)
  float* hid = xin + E * R;       // [F][R]   FF hidden
  float* qkv = hid + F * R;       // [R][3E]  projections / scratch
  float* probs = qkv + R * 3 * E; // [R][H][S]
  float* lg = probs + R * H * S;  // [R][C]
  float* red = lg + R * C;        // [blockDim * V * R] split-K partial sums
  int* tok = (int*)(red + kThreads * Vec<T>::kW * R);  // [R]
  int* done = tok + R;  // [R] rows that have emitted eos_id
  // the rows' abs-max and inverse scale [2R], a max per warp and row
  // [kThreads / 32 * R], the int8 rows [R][Kq]
  float* amax = (float*)(done + R);
  float* wred = amax + 2 * R;
  int8_t* xq = (int8_t*)(wred + (kThreads / 32) * R);
  const int Kq = max(E, F);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, p.B - r0);  // the last tile may be ragged
  const size_t cache_l = (size_t)p.B * T_ * E;
  const size_t mem_l = (size_t)p.B * p.Tm * E;

  if (tid < R) {
    tok[tid] = p.go_id;
    done[tid] = tid >= nrows;  // rows past the batch count as stopped
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    const bool from_cls = t == 0 && p.cls0 != nullptr;
    for (int i = tid; i < R * E; i += nt) {
      int r = i / E, e = i - r * E;
      float x = from_cls ? p.cls0[(size_t)(r0 + min(r, nrows - 1)) * E + e]
                         : Num<T>::to_f(p.emb[(size_t)tok[r] * E + e]);
      xs[i] = x + p.pe[t * E + e];
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // -- self attention over the running KV cache --
      project_q<T, R, false>(p, 0, l, xs, E, 1, E, p.b_qkv, 3 * E, qkv, 3 * E, 1, red, amax,
                             wred, xq, Kq);
      __syncthreads();
      T* kc = p.kc + l * cache_l;
      T* vc = p.vc + l * cache_l;
      for (int i = tid; i < R * E; i += nt) {
        int r = i / E, e = i - r * E;
        if (r < nrows) {
          size_t off = ((size_t)(r0 + r) * T_ + t) * E + e;
          kc[off] = Num<T>::from_f(qkv[r * 3 * E + E + e]);
          vc[off] = Num<T>::from_f(qkv[r * 3 * E + 2 * E + e]);
        }
      }
      __syncthreads();
      attention<T, R>(p, qkv, 3 * E, kc, vc, T_, t + 1, r0, nrows, probs, S, xin);
      project_q<T, R, false>(p, 1, l, xin, 1, R, E, p.b_out, E, qkv, E, 1, red, amax, wred, xq,
                             Kq);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n1_s + l * E, p.n1_b + l * E, E, p.eps);
      __syncthreads();

      // -- cross attention over the precomputed memory K/V --
      project_q<T, R, false>(p, 2, l, xs, E, 1, E, p.cb_q, E, qkv, E, 1, red, amax, wred, xq,
                             Kq);
      __syncthreads();
      attention<T, R>(p, qkv, E, p.ck + l * mem_l, p.cv + l * mem_l, p.Tm, p.Tm, r0, nrows,
                      probs, S, xin);
      project_q<T, R, false>(p, 3, l, xin, 1, R, E, p.cb_o, E, qkv, E, 1, red, amax, wred, xq,
                             Kq);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n2_s + l * E, p.n2_b + l * E, E, p.eps);
      __syncthreads();

      // -- feed-forward --
      project_q<T, R, true>(p, 4, l, xs, E, 1, E, p.ff1_b, F, hid, 1, R, red, amax, wred, xq,
                            Kq);
      __syncthreads();
      project_q<T, R, false>(p, 5, l, hid, 1, R, F, p.ff2_b, E, qkv, E, 1, red, amax, wred, xq,
                             Kq);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n3_s + l * E, p.n3_b + l * E, E, p.eps);
      __syncthreads();
    }

    add_layernorm<T>(xs, R, nullptr, 0, p.fn_s, p.fn_b, E, p.eps);
    __syncthreads();
    round_rows<T>(xs, R, E, E, xin);
    __syncthreads();
    linear<T, R, kPlain>(xin, E, p.head_w, p.head_b, C, lg, C, 1, red);
    __syncthreads();
    for (int i = tid; i < R * C; i += nt) {
      int r = i / C, c = i - r * C;
      if (r < nrows && !done[r])
        p.logits[((size_t)(r0 + r) * T_ + t) * C + c] = lg[i];
    }
    // first-index argmax per row, one warp per row
    for (int r = warp; r < R; r += nt >> 5) {
      float best = lane < C ? lg[r * C + lane] : -__int_as_float(0x7f800000);
      int bi = lane < C ? lane : C;
      for (int c = lane + 32; c < C; c += 32) {
        float v = lg[r * C + c];
        if (v > best) { best = v; bi = c; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        float ob = __shfl_xor_sync(0xffffffffu, best, o);
        int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      // all-NaN logits leave bi at C: feed back a valid id
      if (lane == 0) tok[r] = bi < C ? bi : 0;
    }
    __syncthreads();
    if (p.eos_id >= 0) {
      bool all_done = true;
      for (int r = 0; r < R; ++r) all_done &= done[r] || tok[r] == p.eos_id;
      __syncthreads();  // every thread has read done[] before it changes
      if (tid < R && tok[tid] == p.eos_id) done[tid] = 1;
      if (all_done) break;  // the same value in every thread
      __syncthreads();
    }
  }
}

size_t smem_bytes(int R, int V, int E, int F, int C, int H, int S) {
  return sizeof(float) * ((size_t)R * (E + E + F + 3 * E + H * S + C + kThreads * V)) +
         sizeof(int) * 2 * R + sizeof(float) * (size_t)R * (2 + kThreads / 32) +
         (size_t)R * (E > F ? E : F);
}

template <typename T, int R>
int launch(const Params<T>& p, cudaStream_t stream) {
  int S = p.steps > p.Tm ? p.steps : p.Tm;
  size_t smem = smem_bytes(R, Vec<T>::kW, p.E, p.F, p.C, p.H, S);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (p.B + R - 1) / R;
  decode_kernel<T, R><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* ptr, const int* dim, float eps, float scale,
        const float* cls0, cudaStream_t stream) {
  Params<T> p;
  const T** w[] = {&p.w_qkv, &p.b_qkv, &p.w_out, &p.b_out, &p.cw_q,
                   &p.cb_q,  &p.cw_o,  &p.cb_o,  &p.ff1_w, &p.ff1_b,
                   &p.ff2_w, &p.ff2_b, &p.n1_s,  &p.n1_b,  &p.n2_s,
                   &p.n2_b,  &p.n3_s,  &p.n3_b,  &p.fn_s,  &p.fn_b,
                   &p.head_w, &p.head_b, &p.emb};
  const int nw = sizeof(w) / sizeof(w[0]);
  for (int i = 0; i < nw; ++i) *w[i] = (const T*)ptr[i];
  p.pe = (const float*)ptr[nw];
  p.cls0 = cls0;
  p.ck = (const T*)ptr[nw + 1];
  p.cv = (const T*)ptr[nw + 2];
  p.kc = (T*)ptr[nw + 3];
  p.vc = (T*)ptr[nw + 4];
  p.logits = (float*)ptr[nw + 5];
  // the packed tables sit in the slots of w_qkv, w_out, cw_q, cw_o, ff1_w
  // and ff2_w; their scales follow the logits
  const int table_slot[6] = {0, 2, 4, 6, 8, 10};
  for (int j = 0; j < 6; ++j) {
    p.qw[j] = (const int*)ptr[table_slot[j]];
    p.qs[j] = (const float*)ptr[nw + 6 + j];
  }
  p.B = dim[0]; p.steps = dim[1]; p.L = dim[2]; p.E = dim[3]; p.F = dim[4];
  p.C = dim[5]; p.H = dim[6]; p.Tm = dim[7]; p.go_id = dim[8];
  p.eos_id = dim[9];
  p.eps = eps;
  p.scale = scale;
  if (p.B == 0 || p.steps == 0) return 0;
  return launch<T, kRows>(p, stream);
}

}  // namespace

// ptr: the 23 weight tables in Params order, the six projection tables
// int8 in groups of four K-rows [L, K/4, N, 4] in their slots (E and F
// multiples of 4), then pe, ck, cv, kc, vc, logits and the six scales [L, N]
// float32.  dim: B, T, L, E, F, C, H, Tm, go_id, eos_id (< 0: no early
// stop).  dtype (of the other tables): 0 = float32, 1 = bfloat16.  cls0:
// the [B, E] float32 step-0 rows, or null for the [GO] embedding.  Every
// pointer lies on the device of `stream`, which the caller makes the
// current device for the call.
extern "C" int fused_decode_int8(int dtype, const void* const* ptr,
                                 const int* dim, float eps, float scale,
                                 const void* cls0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c0 = (const float*)cls0;
  if (dtype == 0) return run<float>(ptr, dim, eps, scale, c0, s);
  if (dtype == 1) return run<__nv_bfloat16>(ptr, dim, eps, scale, c0, s);
  return (int)cudaErrorInvalidValue;
}
