// Whole greedy decode loop of the transformer decoder in one kernel.
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// fused_decode.py::_decode_kernel in float mode, with its eos_id early stop
// (no CLS step-0 row).  For T steps it embeds the previous token, runs L
// decoder layers (packed qkv -> self-attention KV-cache write -> causal
// attention -> out-proj -> LN -> cross-q -> attention over the precomputed
// memory K/V -> out-proj -> LN -> ReLU FF -> LN), the final LN and the
// class head, writes logits[b, t, :] and feeds the first-index argmax back.
//
// Early stop (eos_id >= 0): a row that has emitted eos_id writes no further
// logits (the caller prefilled them with the eos_id one-hot), and a CTA
// leaves its loop once every row of its tile has stopped.  Rows are
// independent, so this needs no flag shared between CTAs.
//
// Design.  Rows of the batch are independent, so each CTA owns a fixed tile
// of R rows (template parameter, built for kRows = 1: at B=192 on an H100
// one row per CTA was the fastest of 1, 2, 4 and 8, and a larger tile
// waits for a measured batch that gains from it) and loops over t and l
// itself: there is no
// grid-wide barrier, no flag shared between CTAs and no cooperative launch,
// so the kernel cannot deadlock whatever the number of resident CTAs.  The
// per-row activations (x, qkv, context, the FF hidden) live in shared memory
// in float32.  The self-attention caches [L, B, T, E] live in device memory in
// the compute type (row-major per batch row, so each CTA touches only its own
// rows); only positions <= t are ever read.  Weights are read from device
// memory, where L2 keeps them: they are stored [in, out] row-major and each
// thread owns the 16 bytes of adjacent output columns one vector load
// brings, so a warp reads 512 contiguous bytes of a weight row; where there
// are fewer column groups than threads the K range is split and the partial
// sums meet in shared memory.  Each weight is read once per CTA per step and
// used for all R rows.
//
// Bound: operations.  At the flagship (B=192, T=25, L=6, E=256, F=2048,
// C=97) the projections need 2*B*T*(L*1.44M + E*C) ~ 84 GFLOP against ~49 MB
// of inputs and outputs.  This version uses CUDA-core FMAs, not tensor
// cores, and re-reads the weights from L2 in every CTA and every step, so it
// is bound in practice by L2 reads per SM; the tensor-core, TMA-fed,
// persistent design is later work.
//
// Numerics mirror the TPU kernel's casts for compute type T (float or bf16):
// matmul inputs are rounded to T and accumulated in float32; the q*K products
// are rounded to T before the per-head sum; the probabilities are rounded to
// T and probs*V is formed in T and summed in float32; layernorm, softmax and
// logits are float32; the argmax takes the first index of the maximum.

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
  const T *ck, *cv;  // cross K/V [L, B, Tm, E]
  T *kc, *vc;        // self-attention caches [L, B, T, E]
  float* logits;     // [B, T, C]
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
// kv + row * kv_rows * E, position s at + s * E.  Writes the context, rounded
// to T for the out-projection, into xin[d * R + r].
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
    xin[d * R + r] = Num<T>::round(acc);
  }
  __syncthreads();
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params<T> p) {
  extern __shared__ float smem[];
  const int E = p.E, F = p.F, C = p.C, H = p.H, T_ = p.steps, L = p.L;
  const int S = max(p.steps, p.Tm);
  float* xs = smem;               // [R][E]   residual stream
  float* xin = xs + R * E;        // [E][R]   rounded matmul input
  float* hid = xin + E * R;       // [F][R]   rounded FF hidden
  float* qkv = hid + F * R;       // [R][3E]  projections / scratch
  float* probs = qkv + R * 3 * E; // [R][H][S]
  float* lg = probs + R * H * S;  // [R][C]
  float* red = lg + R * C;        // [blockDim * V * R] split-K partial sums
  int* tok = (int*)(red + kThreads * Vec<T>::kW * R);  // [R]
  int* done = tok + R;  // [R] rows that have emitted eos_id

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
    for (int i = tid; i < R * E; i += nt) {
      int r = i / E, e = i - r * E;
      xs[i] = Num<T>::to_f(p.emb[(size_t)tok[r] * E + e]) + p.pe[t * E + e];
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // -- self attention over the running KV cache --
      round_rows<T>(xs, R, E, E, xin);
      __syncthreads();
      linear<T, R, kPlain>(xin, E, p.w_qkv + (size_t)l * E * 3 * E,
                           p.b_qkv + (size_t)l * 3 * E, 3 * E, qkv, 3 * E, 1, red);
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
      attention<T, R>(p, qkv, 3 * E, kc, vc, T_, t + 1, r0, nrows, probs, S,
                      xin);
      linear<T, R, kPlain>(xin, E, p.w_out + (size_t)l * E * E,
                           p.b_out + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n1_s + l * E, p.n1_b + l * E, E,
                          p.eps);
      __syncthreads();

      // -- cross attention over the precomputed memory K/V --
      round_rows<T>(xs, R, E, E, xin);
      __syncthreads();
      linear<T, R, kPlain>(xin, E, p.cw_q + (size_t)l * E * E,
                           p.cb_q + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      attention<T, R>(p, qkv, E, p.ck + l * mem_l, p.cv + l * mem_l, p.Tm,
                      p.Tm, r0, nrows, probs, S, xin);
      linear<T, R, kPlain>(xin, E, p.cw_o + (size_t)l * E * E,
                           p.cb_o + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n2_s + l * E, p.n2_b + l * E, E,
                          p.eps);
      __syncthreads();

      // -- feed-forward --
      round_rows<T>(xs, R, E, E, xin);
      __syncthreads();
      linear<T, R, kReluRound>(xin, E, p.ff1_w + (size_t)l * E * F,
                               p.ff1_b + (size_t)l * F, F, hid, 1, R, red);
      __syncthreads();
      linear<T, R, kPlain>(hid, F, p.ff2_w + (size_t)l * F * E,
                           p.ff2_b + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n3_s + l * E, p.n3_b + l * E, E,
                          p.eps);
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
  return sizeof(float) *
             ((size_t)R * (E + E + F + 3 * E + H * S + C + kThreads * V)) +
         sizeof(int) * 2 * R;
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
        cudaStream_t stream) {
  Params<T> p;
  const T** w[] = {&p.w_qkv, &p.b_qkv, &p.w_out, &p.b_out, &p.cw_q,
                   &p.cb_q,  &p.cw_o,  &p.cb_o,  &p.ff1_w, &p.ff1_b,
                   &p.ff2_w, &p.ff2_b, &p.n1_s,  &p.n1_b,  &p.n2_s,
                   &p.n2_b,  &p.n3_s,  &p.n3_b,  &p.fn_s,  &p.fn_b,
                   &p.head_w, &p.head_b, &p.emb};
  const int nw = sizeof(w) / sizeof(w[0]);
  for (int i = 0; i < nw; ++i) *w[i] = (const T*)ptr[i];
  p.pe = (const float*)ptr[nw];
  p.ck = (const T*)ptr[nw + 1];
  p.cv = (const T*)ptr[nw + 2];
  p.kc = (T*)ptr[nw + 3];
  p.vc = (T*)ptr[nw + 4];
  p.logits = (float*)ptr[nw + 5];
  p.B = dim[0]; p.steps = dim[1]; p.L = dim[2]; p.E = dim[3]; p.F = dim[4];
  p.C = dim[5]; p.H = dim[6]; p.Tm = dim[7]; p.go_id = dim[8];
  p.eos_id = dim[9];
  p.eps = eps;
  p.scale = scale;
  if (p.B == 0 || p.steps == 0) return 0;
  return launch<T, kRows>(p, stream);
}

}  // namespace

// ptr: the 23 weight tables in Params order, then pe, ck, cv, kc, vc, logits.
// dim: B, T, L, E, F, C, H, Tm, go_id, eos_id (< 0: no early stop).
// dtype: 0 = float32, 1 = bfloat16.
// Every pointer lies on the device of `stream`, which the caller makes the
// current device for the call.
extern "C" int fused_decode(int dtype, const void* const* ptr, const int* dim,
                            float eps, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run<float>(ptr, dim, eps, scale, s);
  if (dtype == 1) return run<__nv_bfloat16>(ptr, dim, eps, scale, s);
  return (int)cudaErrorInvalidValue;
}
