// Whole beam search of the transformer decoder in one kernel.
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// fused_beam.py::_beam_kernel (no CLS step-0 row).  For each batch row it
// keeps K beams.  Each step embeds every beam's previous token, runs L
// decoder layers over per-beam self-attention caches and the row's
// precomputed memory K/V, the final LN and the class head, takes an f32
// log-softmax per beam, lets a finished beam continue only with eos_id at
// zero cost, keeps the best K of the row's K*C continuations and folds the
// parents' history into the new beams.  Output: tokens [B, K, T] int32 and
// cumulative log-probabilities [B, K], best first.
//
// Design.  One CTA per batch row owns that row's K beams as the rows of a
// tile, as the greedy kernel (fused_decode.cu) owns its rows: each weight
// is read once per CTA per step and used for all K beams; the per-beam
// activations live in shared memory in float32.  The caches never move:
// at step t beam k writes its position-t K/V into slot k of the row's
// caches [L, B, K, T, E] (device memory, compute type, zeroed by the
// caller), and an ancestry map in shared memory names, per beam and
// position, the slot that holds that beam's history.  Reading slot
// anc[k][p] computes what the TPU kernel's 0/1 ancestry mask computes with
// a multiply and a fold: one finite product per position, the others
// exact zeros.  Top-K is K max-extractions over the K*C candidates by one
// warp, each taking the first flat index k*C + c of the maximum (the tie
// order of lax.top_k), then masking it to -1e9.  A CTA leaves its loop once
// all its beams have finished (early_stop); rows are independent, so there
// is no grid-wide barrier or flag and no float atomic, and results are
// bit-equal from run to run.
//
// Bound: operations.  At the flagship (B=192, K=5, T=25, L=6, E=256,
// F=2048, C=97) the projections need 2*B*K*T*(L*1.44M + E*C) ~ 416 GFLOP
// against ~0.2 GB of tables, memory K/V and cache writes.  Like the greedy
// kernel this version uses CUDA-core FMAs and re-reads the weights from L2
// in every CTA and every step, so it is bound in practice by L2 reads per
// SM; tensor cores, TMA and multicast are later work.
//
// Numerics mirror the TPU kernel's casts for compute type T (float or bf16):
// matmul inputs are rounded to T and accumulated in float32; the q*K
// products are rounded to T before the per-head sum; the probabilities are
// rounded to T; the self-attention value sum multiplies them by the cached
// values in float32 without rounding the product, while the cross-attention
// value product is rounded to T and summed in float32; layernorm, softmax,
// log-softmax and scores are float32.

#include "decode_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;  // dead beams, barred and taken continuations

template <typename T>
struct Params {
  // per-layer tables stacked on a leading L axis, matrices [in, out]
  const T *w_qkv, *b_qkv, *w_out, *b_out, *cw_q, *cb_q, *cw_o, *cb_o;
  const T *ff1_w, *ff1_b, *ff2_w, *ff2_b;
  const T *n1_s, *n1_b, *n2_s, *n2_b, *n3_s, *n3_b;
  const T *fn_s, *fn_b, *head_w, *head_b, *emb;
  const float* pe;   // [T, E]
  const T *ck, *cv;  // memory K/V [L, B, Tm, E], shared by a row's beams
  T *kc, *vc;        // self-attention caches [L, B, K, T, E]
  int* tokens;       // [B, K, T]
  float* scores;     // [B, K]
  int B, steps, L, E, F, C, H, Tm, go_id, eos_id, K, early_stop;
  float eps, scale;  // layernorm epsilon, 1/sqrt(head_dim)
};

// acc[r][v] += sum_{k0 <= k < k1} xin[k * R + r] * W[k * N + v] for r < R
// (R <= KM rows held in registers), four 16-byte loads in flight per thread
template <typename T, int KM>
__device__ void dot_rows(const float* xin, int R, const T* W, int N, int k0,
                         int k1, float (&acc)[KM][Vec<T>::kW]) {
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
      for (int r = 0; r < KM; ++r) {
        if (r < R) {
          float x = xk[r];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(x, w[u][v], acc[r][v]);
        }
      }
    }
  }
  for (; k < k1; ++k) {
    float w[V];
    Vec<T>::load(W + (size_t)k * N, w);
    const float* xk = xin + k * R;
#pragma unroll
    for (int r = 0; r < KM; ++r) {
      if (r < R) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xk[r], w[v], acc[r][v]);
      }
    }
  }
}

// out[r * os_r + j * os_j] = epi(sum_k xin[k * R + r] * W[k * N + j] + b[j])
// for the R beam rows: the greedy kernel's projection (one 16-byte column
// group per thread, split K where there are fewer groups than threads, the
// partial sums meeting in `red`; one column per thread where N is not a
// multiple of V).  Called by every thread of the block; it synchronises
// internally when it splits K.  Not inlined: one copy per (T, KM, EPI)
// instead of one per call site keeps the build short.
template <typename T, int KM, int EPI>
__device__ __noinline__ void linear(const float* xin, int R, int K, const T* __restrict__ W,
                       const T* __restrict__ b, int N, float* out, int os_r,
                       int os_j, float* red) {
  constexpr int V = Vec<T>::kW;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (N % V != 0) {
    for (int j = tid; j < N; j += nt) {
      float acc[KM];
#pragma unroll
      for (int r = 0; r < KM; ++r) acc[r] = 0.0f;
      for (int k = 0; k < K; ++k) {
        float w = Num<T>::load(W + (size_t)k * N + j);
#pragma unroll
        for (int r = 0; r < KM; ++r)
          if (r < R) acc[r] = fmaf(xin[k * R + r], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < KM; ++r)
        if (r < R) out[r * os_r + j * os_j] = epilogue<T, EPI>(acc[r], b, j);
    }
    return;
  }
  const int G = N / V;
  const int S = G >= nt ? 1 : nt / G;
  if (S == 1) {
    for (int g = tid; g < G; g += nt) {
      float acc[KM][V] = {};
      dot_rows<T, KM>(xin, R, W + g * V, N, 0, K, acc);
#pragma unroll
      for (int r = 0; r < KM; ++r) {
        if (r < R) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            int j = g * V + v;
            out[r * os_r + j * os_j] = epilogue<T, EPI>(acc[r][v], b, j);
          }
        }
      }
    }
    return;
  }
  if (tid < G * S) {
    const int g = tid % G, s = tid / G;
    const int chunk = (K + S - 1) / S;
    const int k0 = min(K, s * chunk), k1 = min(K, k0 + chunk);
    float acc[KM][V] = {};
    dot_rows<T, KM>(xin, R, W + g * V, N, k0, k1, acc);
#pragma unroll
    for (int r = 0; r < KM; ++r) {
      if (r < R) {
#pragma unroll
        for (int v = 0; v < V; ++v) red[(s * R + r) * N + g * V + v] = acc[r][v];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * N; i += nt) {
    const int r = i / N, j = i - r * N;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += red[(s * R + r) * N + j];
    out[r * os_r + j * os_j] = epilogue<T, EPI>(acc, b, j);
  }
}

// In place over probs[(r * H + h) * S + s] for s < len: softmax over s in
// float32, each probability rounded to T.
template <typename T>
__device__ void softmax_rows(float* probs, int rows, int S, int len) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
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
}

// Self-attention of the R beams' queries (q[r * 3E + d], float32) over
// positions 0..t of their histories: position s of beam r lives in slot
// anc[r * T + s] of layer cache kc/vc (row base: slot 0, position 0).
// Writes the context, rounded to T for the out-projection, into
// xin[d * R + r].
template <typename T>
__device__ void self_attention(const Params<T>& p, const float* q,
                               const T* kc, const T* vc, const int* anc,
                               int R, int t, float* probs, int S, float* xin) {
  const int E = p.E, H = p.H, hd = E / H, T_ = p.steps, len = t + 1;
  for (int i = threadIdx.x; i < R * H * len; i += blockDim.x) {
    int r = i / (H * len), rem = i - r * H * len;
    int h = rem / len, s = rem - h * len;
    const float* qr = q + r * 3 * E + h * hd;
    const T* kr = kc + ((size_t)anc[r * T_ + s] * T_ + s) * E + h * hd;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d)
      acc += Num<T>::round(Num<T>::round(qr[d]) * Num<T>::to_f(kr[d]));
    probs[(r * H + h) * S + s] = acc * p.scale;
  }
  __syncthreads();
  softmax_rows<T>(probs, R * H, S, len);
  __syncthreads();
  for (int i = threadIdx.x; i < R * E; i += blockDim.x) {
    int r = i / E, d = i - r * E, h = d / hd;
    const float* pr = probs + (r * H + h) * S;
    float acc = 0.0f;
    for (int s = 0; s < len; ++s) {
      const T* vr = vc + ((size_t)anc[r * T_ + s] * T_ + s) * E + d;
      acc += pr[s] * Num<T>::to_f(*vr);  // the product is not rounded
    }
    xin[d * R + r] = Num<T>::round(acc);
  }
  __syncthreads();
}

// Cross-attention of the R beams' queries (q[r * E + d]) over the row's
// memory K/V [Tm, E], shared by all beams.  Writes the context, rounded to
// T, into xin[d * R + r].
template <typename T>
__device__ void cross_attention(const Params<T>& p, const float* q,
                                const T* K, const T* V, int R, float* probs,
                                int S, float* xin) {
  const int E = p.E, H = p.H, hd = E / H, len = p.Tm;
  for (int i = threadIdx.x; i < R * H * len; i += blockDim.x) {
    int r = i / (H * len), rem = i - r * H * len;
    int h = rem / len, s = rem - h * len;
    const float* qr = q + r * E + h * hd;
    const T* kr = K + (size_t)s * E + h * hd;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d)
      acc += Num<T>::round(Num<T>::round(qr[d]) * Num<T>::to_f(kr[d]));
    probs[(r * H + h) * S + s] = acc * p.scale;
  }
  __syncthreads();
  softmax_rows<T>(probs, R * H, S, len);
  __syncthreads();
  for (int i = threadIdx.x; i < R * E; i += blockDim.x) {
    int r = i / E, d = i - r * E, h = d / hd;
    const float* pr = probs + (r * H + h) * S;
    float acc = 0.0f;
    for (int s = 0; s < len; ++s)
      acc += Num<T>::round(pr[s] * Num<T>::to_f(V[(size_t)s * E + d]));
    xin[d * R + r] = Num<T>::round(acc);
  }
  __syncthreads();
}

template <typename T, int KM>
__global__ void __launch_bounds__(kThreads) beam_kernel(Params<T> p) {
  extern __shared__ float smem[];
  const int E = p.E, F = p.F, C = p.C, H = p.H, T_ = p.steps, L = p.L;
  const int R = p.K;  // beams, the rows of this CTA's tile
  const int S = max(p.steps, p.Tm);
  float* xs = smem;                // [R][E]   residual stream
  float* xin = xs + R * E;         // [E][R]   rounded matmul input
  float* hid = xin + E * R;        // [F][R]   rounded FF hidden
  float* qkv = hid + F * R;        // [R][3E]  projections / scratch
  float* probs = qkv + R * 3 * E;  // [R][H][S]
  float* lg = probs + R * H * S;   // [R][C]   logits, then candidate scores
  float* red = lg + R * C;         // [blockDim * V * R] split-K partial sums
  float* score = red + kThreads * Vec<T>::kW * R;  // [R] cumulative log-probs
  int* anc = (int*)(score + R);    // [R][T]   slot of each position
  int* anc2 = anc + R * T_;        // [R][T]   the fold's target
  int* seq = anc2 + R * T_;        // [R][T]   tokens
  int* seq2 = seq + R * T_;
  int* tok = seq2 + R * T_;        // [R]      previous token
  int* fin = tok + R;              // [R]      finished flags
  int* par = fin + R;              // [R]      parent beam of each new beam

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int KC = R * C;
  const size_t cache_l = (size_t)p.B * R * T_ * E;
  const size_t mem_l = (size_t)p.B * p.Tm * E;
  const size_t row_cache = (size_t)b * R * T_ * E;  // slot 0, position 0

  for (int i = tid; i < R * T_; i += nt) {
    anc[i] = anc2[i] = 0;
    seq[i] = seq2[i] = 0;
  }
  if (tid < R) {
    tok[tid] = p.go_id;
    fin[tid] = 0;
    score[tid] = tid == 0 ? 0.0f : kNeg;  // only beam 0 live at step 0
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    if (tid < R) anc[tid * T_ + t] = tid;  // beam k writes position t to slot k
    for (int i = tid; i < R * E; i += nt) {
      int r = i / E, e = i - r * E;
      xs[i] = Num<T>::to_f(p.emb[(size_t)tok[r] * E + e]) + p.pe[t * E + e];
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // -- self attention over the unreordered caches, through anc --
      round_rows<T>(xs, R, E, E, xin);
      __syncthreads();
      linear<T, KM, kPlain>(xin, R, E, p.w_qkv + (size_t)l * E * 3 * E,
                            p.b_qkv + (size_t)l * 3 * E, 3 * E, qkv, 3 * E, 1,
                            red);
      __syncthreads();
      T* kc = p.kc + l * cache_l + row_cache;
      T* vc = p.vc + l * cache_l + row_cache;
      for (int i = tid; i < R * E; i += nt) {
        int r = i / E, e = i - r * E;
        size_t off = ((size_t)r * T_ + t) * E + e;
        kc[off] = Num<T>::from_f(qkv[r * 3 * E + E + e]);
        vc[off] = Num<T>::from_f(qkv[r * 3 * E + 2 * E + e]);
      }
      __syncthreads();
      self_attention<T>(p, qkv, kc, vc, anc, R, t, probs, S, xin);
      linear<T, KM, kPlain>(xin, R, E, p.w_out + (size_t)l * E * E,
                            p.b_out + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n1_s + l * E, p.n1_b + l * E, E,
                       p.eps);
      __syncthreads();

      // -- cross attention over the row's memory K/V --
      round_rows<T>(xs, R, E, E, xin);
      __syncthreads();
      linear<T, KM, kPlain>(xin, R, E, p.cw_q + (size_t)l * E * E,
                            p.cb_q + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      cross_attention<T>(p, qkv, p.ck + l * mem_l + (size_t)b * p.Tm * E,
                         p.cv + l * mem_l + (size_t)b * p.Tm * E, R, probs, S,
                         xin);
      linear<T, KM, kPlain>(xin, R, E, p.cw_o + (size_t)l * E * E,
                            p.cb_o + (size_t)l * E, E, qkv, E, 1, red);
      __syncthreads();
      add_layernorm<T>(xs, R, qkv, E, p.n2_s + l * E, p.n2_b + l * E, E,
                       p.eps);
      __syncthreads();

      // -- feed-forward --
      round_rows<T>(xs, R, E, E, xin);
      __syncthreads();
      linear<T, KM, kReluRound>(xin, R, E, p.ff1_w + (size_t)l * E * F,
                                p.ff1_b + (size_t)l * F, F, hid, 1, R, red);
      __syncthreads();
      linear<T, KM, kPlain>(hid, R, F, p.ff2_w + (size_t)l * F * E,
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
    linear<T, KM, kPlain>(xin, R, E, p.head_w, p.head_b, C, lg, C, 1, red);
    __syncthreads();

    // candidate scores, one warp per beam: f32 log-softmax (a finished beam
    // continues only with eos_id, at zero cost) plus the beam's score
    for (int r = warp; r < R; r += nt >> 5) {
      float* row = lg + r * C;
      float mx = -__int_as_float(0x7f800000);
      for (int c = lane; c < C; c += 32) mx = fmaxf(mx, row[c]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < C; c += 32) sum += expf(row[c] - mx);
      const float lse = logf(warp_sum(sum));
      for (int c = lane; c < C; c += 32) {
        float logp = fin[r] ? (c == p.eos_id ? 0.0f : kNeg) : row[c] - mx - lse;
        row[c] = logp + score[r];
      }
    }
    __syncthreads();

    // top-K by warp 0: K extractions of (maximum, first flat index)
    if (warp == 0) {
      for (int k = 0; k < R; ++k) {
        float best = -__int_as_float(0x7f800000);
        int bi = KC;
        for (int i = lane; i < KC; i += 32) {
          float v = lg[i];
          if (v > best) { best = v; bi = i; }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          float ob = __shfl_xor_sync(0xffffffffu, best, o);
          int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
        }
        if (bi >= KC) bi = 0;  // all-NaN candidates: a valid index
        if (lane == 0) {
          lg[bi] = kNeg;
          score[k] = best;
          par[k] = bi / C;
          tok[k] = bi - (bi / C) * C;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // fold the parents' ancestry, tokens and finished flags into the new
    // beams, then record position t
    int fin_new = 0;
    if (tid < R) fin_new = fin[par[tid]] | (tok[tid] == p.eos_id);
    for (int i = tid; i < R * (t + 1); i += nt) {
      int k = i / (t + 1), s = i - k * (t + 1);
      anc2[k * T_ + s] = anc[par[k] * T_ + s];
      seq2[k * T_ + s] = s == t ? tok[k] : seq[par[k] * T_ + s];
    }
    __syncthreads();
    if (tid < R) fin[tid] = fin_new;
    int* tmp = anc; anc = anc2; anc2 = tmp;
    tmp = seq; seq = seq2; seq2 = tmp;
    __syncthreads();
    if (p.early_stop) {
      bool all_done = true;
      for (int r = 0; r < R; ++r) all_done &= fin[r] != 0;
      if (all_done) break;  // the same value in every thread
    }
  }

  for (int i = tid; i < R * T_; i += nt)
    p.tokens[(size_t)b * R * T_ + i] = seq[i];
  if (tid < R) p.scores[(size_t)b * R + tid] = score[tid];
}

size_t smem_bytes(int R, int V, int E, int F, int C, int H, int S, int T) {
  return sizeof(float) *
             ((size_t)R * (E + E + F + 3 * E + H * S + C + kThreads * V)) +
         sizeof(int) * (size_t)R * (4 * T + 4);
}

template <typename T, int KM>
int launch(const Params<T>& p, cudaStream_t stream) {
  int S = p.steps > p.Tm ? p.steps : p.Tm;
  size_t smem =
      smem_bytes(p.K, Vec<T>::kW, p.E, p.F, p.C, p.H, S, p.steps);
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<T, KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<T, KM><<<p.B, kThreads, smem, stream>>>(p);
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
  p.tokens = (int*)ptr[nw + 5];
  p.scores = (float*)ptr[nw + 6];
  p.B = dim[0]; p.steps = dim[1]; p.L = dim[2]; p.E = dim[3]; p.F = dim[4];
  p.C = dim[5]; p.H = dim[6]; p.Tm = dim[7]; p.go_id = dim[8];
  p.eos_id = dim[9]; p.K = dim[10]; p.early_stop = dim[11];
  p.eps = eps;
  p.scale = scale;
  if (p.B == 0 || p.steps == 0) return 0;
  // the beams live in registers of a tile of KM rows: 5 (the usual beam
  // width) or 8 (the most one CTA holds)
  if (p.K >= 1 && p.K <= 5) return launch<T, 5>(p, stream);
  if (p.K >= 6 && p.K <= 8) return launch<T, 8>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ptr: the 23 weight tables in Params order, then pe, ck, cv, kc, vc,
// tokens, scores.  dim: B, T, L, E, F, C, H, Tm, go_id, eos_id, K,
// early_stop.  dtype: 0 = float32, 1 = bfloat16.  Every pointer lies on the
// device of `stream`, which the caller makes the current device for the
// call.
extern "C" int fused_beam(int dtype, const void* const* ptr, const int* dim,
                          float eps, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run<float>(ptr, dim, eps, scale, s);
  if (dtype == 1) return run<__nv_bfloat16>(ptr, dim, eps, scale, s);
  return (int)cudaErrorInvalidValue;
}
