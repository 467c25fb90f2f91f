// Whole beam search of the transformer decoder in one cooperative launch
// (K4): a persistent grid whose phases are tiled products over all B*K beam
// rows, separated by grid barriers.
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// fused_beam.py::_beam_kernel, with its cls0 step-0 row.  For each batch
// row it keeps K beams.  Each step embeds every beam's previous token, runs
// L decoder layers over per-beam self-attention caches and the row's
// precomputed memory K/V, the final LN and the class head, takes an f32
// log-softmax per beam, lets a finished beam continue only with eos_id at
// zero cost, keeps the best K of the row's K*C continuations and folds the
// parents' history into the new beams.  Output: tokens [B, K, T] int32 and
// cumulative log-probabilities [B, K], best first.
//
// Bound: operations.  At the flagship (B=192, K=5, T=25, L=6, E=256,
// F=2048, C=97) the projections need 2*B*K*T*(L*1.44M + E*C) ~ 416 GFLOP
// (0.42 ms at the H100's 989 bf16 TFLOP/s) against ~0.2 GB of tables,
// memory K/V and cache writes.  The TPU kernel runs each projection as one
// product whose M is 320 beam rows over VMEM-resident weights.  A CTA a
// batch row (the first port of this kernel) re-read the 17.35 MB of a
// step's weights 192 times from L2 and ran them on CUDA cores over 5-row
// tiles; here every phase is one tensor-core product whose M is all B*K
// beam rows, so each weight tile is read once per 64-row tile.
//
// Design.  One CTA a streaming multiprocessor, launched cooperatively (the
// launcher refuses a grid that cannot be resident, never runs a smaller
// one) and looping over the steps itself.  A step is 6L + 1 phases, each
// a set of tiles the CTAs take in turn (tile i by CTA i mod grid), each
// followed by a grid barrier:
//
//   1 qkv + self-attention: 64 beam rows by one head's q, k and v columns;
//     writes the head's k and v of position t into the rows' cache slots
//     and attends over each beam's history through the ancestry map
//   2 out-projection: 64 rows by a column tile of E; pre = x + (ctx Wo + b)
//   3 LN1 + cross-q + cross-attention: 64 rows by one head; the query of
//     the head, attention over the row's memory K/V
//   4 cross-out, as 2
//   5 LN2 + ff1 + ReLU: 64 rows by a column tile of F
//   6 ff2, as 2, over K = F
//   7 head + top-K: whole batch rows; LN3, the final LN, the class head,
//     the f32 log-softmax, K extractions of the maximum at its first flat
//     index (the tie order of lax.top_k), the fold of ancestry, tokens,
//     scores and finished flags, and the next step's input rows
//
// A layernorm has no phase of its own: the phase that reads its output
// stages the tile's 64 rows, normalizes them one warp a row and rounds them
// into shared memory as the A operand (the tile of head 0, or of column
// tile 0, also writes the normalized rows x, which the next residual
// reads).  The residual stream lives in device memory in float32: x (after
// a LN) and pre (before it); the attention contexts and the FF hidden in
// T.  A head's queries, rounded to T, wait in the context's columns
// between its product and its attention, which reads them back, a group
// of rows at a time, and stages the keys and values it reads (through the
// ancestry map, or the batch row's memory) by cp.async.  Data written
// inside the launch is read through L2 (ld.global.cg, cp.async.cg), never
// through a possibly stale L1.
//
// Products.  A tile's K runs in chunks of kBK (64 in bf16, 32 in
// float32), four in flight in bf16 (three in float32): the weight chunk
// [kBK][N] by cp.async (L2 only, zero-filled past the edges), and the A
// chunk [64][kBK] likewise where the A operand is T rows in device memory
// (ctx, hid).  bf16: mma.sync m16n8k8 -> f32, operands by ldmatrix, 8
// warps as 4 (rows) x 2 (columns), each 8-deep product from zero added to
// the float32 sum in k order.  The finer the steps, the nearer the sums
// come to the plain version's: on the trained decoder with a random cls0,
// the tensor cores' own accumulation over a chunk left 96.8% of the beams
// identical, 16-deep steps 97.9%, 8-deep steps 98.4% and CUDA-core FMA
// chains 98.4% at 4x the time (PERF.md; chip_smoke.py holds 98%).
// float32: CUDA-core FMAs over the same chunks, in k order, no TF32.  Each product is one non-inlined function writing its
// tile to shared memory, which its phase's epilogue reads.  No split K
// and no float atomics: each output is summed over its whole K in one
// order, so two launches are bit-equal.  Attention stays on CUDA cores:
// the TPU kernel rounds each q*K product and each cross-attention probs*V
// product to T before it sums them.
//
// Where the time goes (PERF.md): a phase costs about what its 64-row
// tiles' instructions cost, at B=1 nearly as much as at B=192; the
// products, the layernorm prologues and the attention's staging lead.
//
// Early stop: a batch row whose beams have all finished keeps its tokens,
// scores and ancestry (its tiles still run, their results unused); every
// row that stays live sets the step's flag (an integer atomic OR), and the
// grid leaves the loop together once no row is live.
//
// Numerics mirror the TPU kernel's casts for compute type T (float or bf16):
// matmul inputs are rounded to T and accumulated in float32; the q*K
// products are rounded to T before the per-head sum; the probabilities are
// rounded to T; the self-attention value sum multiplies them by the cached
// values in float32 without rounding the product, while the cross-attention
// value product is rounded to T and summed in float32; layernorm, softmax,
// log-softmax and scores are float32.  cls0 (a non-null [B, E] float32
// pointer): step 0's input row of every one of row b's K beams is cls0[b] +
// pe[0], unrounded, in place of emb[go_id] + pe[0].

#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;           // beam rows of a product tile
constexpr int kMaxBN = 256;       // columns of a product pass
constexpr int kLdW = kMaxBN + 8;  // row stride of a weight chunk (16-byte rows, no bank conflicts)
constexpr int kRows7 = 16;        // beam rows of a top-K tile at most
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a CTA may use on Hopper
constexpr float kNeg = -1e9f;  // dead beams, barred and taken continuations

template <typename T>
struct Params {
  // per-layer tables stacked on a leading L axis, matrices [in, out]
  const T *w_qkv, *b_qkv, *w_out, *b_out, *cw_q, *cb_q, *cw_o, *cb_o;
  const T *ff1_w, *ff1_b, *ff2_w, *ff2_b;
  const T *n1_s, *n1_b, *n2_s, *n2_b, *n3_s, *n3_b;
  const T *fn_s, *fn_b, *head_w, *head_b, *emb;
  const float* pe;    // [T, E]
  const float* cls0;  // [B, E] step-0 rows, or null: emb[go_id]
  const T *ck, *cv;   // memory K/V [L, B, Tm, E], shared by a row's beams
  T *kc, *vc;         // self-attention caches [L, B, K, T, E]: beam k writes slot k
  int* tokens;        // [B, K, T] the beams' tokens (kept up to date every step)
  float* scores;      // [B, K]
  float *x, *pre;     // [B*K, E] the rows after and before a layernorm
  float* logits;      // [B*K, C] the class head's logits of a step
  T* ctx;             // [B*K, E] attention contexts
  T* hid;             // [B*K, F] FF hidden
  int* anc;           // [B, K, T] the slot that holds each position of each beam
  int* state;         // tok [B*K], fin [B*K], live [B], flag [T]
  long long* prof;    // [27] cycles by phase and by part (see Clock), or null
  int B, steps, L, E, F, C, H, Tm, go_id, eos_id, K, early_stop;
  int bn_out, bn_ff1, bn_ff2;  // columns of a tile of out/cross-out, ff1, ff2
  int rows7;                   // batch rows of a top-K tile
  float eps, scale;            // layernorm epsilon, 1/sqrt(head_dim)
};

// -- loads and stores of data written inside the launch ----------------------

__device__ float ldcg(const float* p) { return __ldcg(p); }
__device__ float ldcg(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ int ldcg(const int* p) { return __ldcg(p); }

// one value from global src to dst through L2
__device__ void copy1(float* dst, const float* src) { *dst = __ldcg(src); }
__device__ void copy1(int* dst, const int* src) { *dst = __ldcg(src); }
__device__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<unsigned short*>(dst) = __ldcg(reinterpret_cast<const unsigned short*>(src));
}

__device__ void stcg(float* p, float v) { __stcg(p, v); }
__device__ void stcg(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}
// v rounded to T
__device__ void stcg(__nv_bfloat16* p, float v) { stcg(p, __float2bfloat16_rn(v)); }

// value i of 16 bytes of T, widened to float
template <typename T>
__device__ float widen(uint4 v, int i);

template <>
__device__ float widen<float>(uint4 v, int i) {
  return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

template <>
__device__ float widen<__nv_bfloat16>(uint4 v, int i) {  // bf16 is the high half of a float
  const unsigned u = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return __uint_as_float(i & 1 ? u & 0xffff0000u : u << 16);
}

// -- the tensor-core and cp.async primitives ---------------------------------

__device__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// 16 bytes from src to dst (shared), of which the first `bytes` read and the
// rest zero-filled
__device__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the A fragments of a 16 x 16 tile of a row-major [m][k] operand
__device__ void ldmatrix_a(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// the B fragments of a 16 x 8 tile of a row-major [k][n] operand
__device__ void ldmatrix_b(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
// the B fragments of two adjacent 16 x 8 tiles of a row-major [k][n]
// operand (r[0..1] the first, r[2..3] the second)
__device__ void ldmatrix_b2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d = a * b, bf16 x bf16 -> float32 from zero over 8 of a 16 x 16 A tile's
// k-values (m16n8k8; a0, a1: the half's two A fragment words, b: its B
// word); not volatile, so the scheduler may overlap independent products
__device__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%7,%7,%7,%7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.0f));
}
// -- shared memory -----------------------------------------------------------

// What a CTA's shared memory holds, derived from Params alike by every
// CTA and by the launcher (ops/fused_beam.beam_plan computes the same):
//
//   [0, ring_w)               a product's chunks: kStages x [kBK][ncols + 8] weights
//                             and, where its A operand streams, kStages x [kBM][kBK + 8]
//                             of it, running on into the next region
//   [ring_w, + a_region)      or the whole normalized rows [kBM][ldr] (resident)
//   [.., + aux)               float32 [kBM][bn]: the residual rows of a column tile
//   [.., + 4 kMaxBN)          the bias of a pass's columns
//   [.., + 8 kBM)             row statistics (the non-resident layernorm)
//
// The attention reuses [0, ring_w + a_region), for groups of RA of the
// tile's rows at a time (RA = kBM where they fit): P positions of keys or
// values [RA][P][hdp], the queries (then the context sums) [RA][hdp] and
// the scores [RA][S] in float32, the ancestry slots [RA][T].  The top-K
// phase stages its rows in the weight ring, runs the class head's product
// (its logits go to device memory), then reuses the whole of shared
// memory from 0 for its logits, histories and per-beam scalars.
template <typename T>
struct Layout {
  static constexpr int kBK = sizeof(T) == 2 ? 64 : 32;   // k-depth of a chunk
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 3;  // chunks in flight
  static constexpr int kLdA = kBK + 8;                    // A chunk row stride
  static constexpr int kVW = 16 / sizeof(T);              // values of 16 bytes
  int hd, hdp, S, ldr, RA, P;
  bool resident;
  size_t ring_w, a_region, aux, product, top;

  __host__ __device__ Layout(const Params<T>& p) {
    const size_t es = sizeof(T);
    hd = p.E / p.H;
    hdp = (hd + kVW - 1) / kVW * kVW;
    S = p.steps > p.Tm ? p.steps : p.Tm;
    ldr = (p.E + kBK - 1) / kBK * kBK + 8;
    ring_w = (size_t)kStages * kBK * kLdW * es;
    const size_t a_ring = (size_t)kStages * kBM * kLdA * es, a_res = (size_t)kBM * ldr * es;
    aux = 4 * (size_t)kBM * (p.bn_out > p.bn_ff2 ? p.bn_out : p.bn_ff2);
    const size_t tail = aux + 4 * kMaxBN + 8 * kBM;
    resident = 4 * (size_t)(kBM + 2) * p.E <= ring_w &&
               ring_w + (a_res > a_ring ? a_res : a_ring) + tail <= kSmemLimit;
    a_region = resident && a_res > a_ring ? a_res : a_ring;
    product = ring_w + a_region + tail;
    // the attention's groups: the most rows (halving from kBM) whose
    // queries, scores and slots leave room for one position's keys
    const long long room = (long long)(ring_w + a_region);
    const long long per_row = 4LL * (hdp + S + p.steps);
    RA = kBM;
    while (RA > 1 && RA * (per_row + (long long)hdp * es) > room) RA /= 2;
    const long long left = room - RA * per_row;
    P = left > 0 ? (int)(left / ((long long)RA * hdp * es)) : 0;
    P = P < S ? P : S;
    // the top-K tile's logits, histories and per-beam scalars
    const size_t R = (size_t)p.rows7 * p.K;
    top = (4 * (R * p.C + 2 * R * p.steps + 6 * R + p.rows7) + 15) / 16 * 16;
  }
  __host__ __device__ size_t bytes() const { return product > top ? product : top; }
};

// -- staging -----------------------------------------------------------------

// n values of T (or float, int) from global src to shared dst: 16-byte
// cp.async pieces (L2 only) where both are 16-byte aligned and n fills
// them, value by value through L2 otherwise.  The caller commits, waits and
// synchronises.
template <typename V>
__device__ void stage(V* dst, const V* src, int n, int tid, int nt) {
  constexpr int VW = 16 / sizeof(V);
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % 16 == 0) {
    const int pieces = n / VW;
    for (int i = tid; i < pieces; i += nt) cp_async16(dst + i * VW, src + i * VW, 16);
    for (int i = pieces * VW + tid; i < n; i += nt) copy1(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nt) copy1(dst + i, src + i);
  }
}

// -- products ----------------------------------------------------------------

// The columns of a product pass: nseg segments of w columns, segment s at
// column c0 + s * stride of the weight [K][ldw]; in the tile each is padded
// to wp = w rounded up to 8 (nseg * wp <= kMaxBN).
struct Cols {
  int c0, stride, nseg, w;
  __device__ int wp() const { return (w + 7) & ~7; }
  __device__ int ncols() const { return nseg * wp(); }
};

// float32 rows (x or pre) read as a product's A operand: with g a
// layernorm's scale (and b its bias) normalized first, the normalized rows
// also written to xw where it is not null.
struct ARows {
  const float* src;
  const void *g, *b;
  float* xw;
};

// The A operand of a product: rows row0.. of T rows [M][ld] in device
// memory (ctx, hid), streamed a chunk at a time by cp.async; or the tile's
// rows [kBM][ld] already in shared memory (resident); or float32 rows
// staged through registers a chunk at a time (the layernorm's fallback
// where the rows do not fit, `rows` not null).
template <typename T>
struct AOp {
  const T* src;
  int ld;
  bool resident;
  const ARows* rows;
};

// A thread's part of a staged A chunk [kBM][kBK]: G groups of eight
// values, group i = tid + g * kThreads at row i / (kBK / 8), column (i %
// (kBK / 8)) * 8, held as float between the load and the store.
template <typename T>
struct AStage {
  static constexpr int kBK = Layout<T>::kBK, kPer = kBK / 8;
  static constexpr int G = (kBM * kPer + kThreads - 1) / kThreads;
  float v[G][8];

  __device__ void load(const ARows& a, int row0, int M, int K, int k0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = threadIdx.x + g * kThreads, r = i / kPer, k = k0 + (i % kPer) * 8;
      if (i >= kBM * kPer) break;
      const float* src = a.src + (size_t)min(row0 + r, M - 1) * K + k;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[g][j] = k + j < K ? __ldcg(src + j) : 0.0f;
    }
  }

  // into the chunk As [kBM][kLdA], normalized by stats [kBM][2] (mean,
  // 1/deviation) where the rows are a layernorm's input
  __device__ void store(const ARows& a, const float* stats, T* As, int row0, int M, int K,
                        int k0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = threadIdx.x + g * kThreads, r = i / kPer, c = (i % kPer) * 8, k = k0 + c;
      if (i >= kBM * kPer) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = v[g][j];
        if (a.g != nullptr && k + j < K) {
          x = (x - stats[2 * r]) * stats[2 * r + 1] * Num<T>::load((const T*)a.g + k + j) +
              Num<T>::load((const T*)a.b + k + j);
          if (a.xw != nullptr && row0 + r < M) __stcg(a.xw + (size_t)(row0 + r) * K + k + j, x);
        }
        As[r * Layout<T>::kLdA + c + j] = Num<T>::from_f(x);
      }
    }
  }
};

// Rows k0.. k0 + BK of the pass's columns of W into the chunk Ws
// [BK][ldws]: 16-byte cp.async pieces where the columns are 16-byte
// aligned (zero-filled past K and past each segment's w), else value by
// value.  Where a row's pieces divide the threads, each thread copies one
// piece of every (threads / pieces)-th row, so that a warp's copies are
// whole; otherwise warp w copies rows w, w + 8, .. and lane l the pieces
// l, l + 32, ...
template <typename T>
__device__ void load_w(T* Ws, int ldws, const T* W, int ldw, int K, int k0, int BK, const Cols c,
                       bool vec) {
  constexpr int VW = 16 / sizeof(T);
  const int wp = c.wp(), per = wp / VW, pieces = c.nseg * per;
  if (kThreads % pieces == 0) {  // thread t: piece t % pieces of rows t / pieces + j * (kThreads / pieces)
    const int pc = threadIdx.x % pieces, s = pc / per, col = (pc - s * per) * VW;
    const int cvalid = min(VW, max(0, c.w - col)), step = kThreads / pieces;
    const T* src = W + c.c0 + s * c.stride + col;
    T* dst = Ws + s * wp + col;
    for (int kr = threadIdx.x / pieces; kr < BK; kr += step) {
      const int k = k0 + kr, valid = k < K ? cvalid : 0;
      if (vec) {
        cp_async16(dst + kr * ldws, valid > 0 ? src + (size_t)k * ldw : W, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e)
          dst[kr * ldws + e] =
              Num<T>::from_f(e < valid ? Num<T>::load(src + (size_t)k * ldw + e) : 0.0f);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int pc = lane; pc < pieces; pc += 32) {
    const int s = pc / per, col = (pc - s * per) * VW;
    const int cvalid = min(VW, max(0, c.w - col));
    const T* src = W + c.c0 + s * c.stride + col;
    T* dst = Ws + s * wp + col;
    for (int kr = warp; kr < BK; kr += kWarps) {
      const int k = k0 + kr, valid = k < K ? cvalid : 0;
      if (vec) {
        cp_async16(dst + kr * ldws, valid > 0 ? src + (size_t)k * ldw : W, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e)
          dst[kr * ldws + e] =
              Num<T>::from_f(e < valid ? Num<T>::load(src + (size_t)k * ldw + e) : 0.0f);
      }
    }
  }
}

// Rows row0.. (clamped to the batch) and columns k0.. k0 + BK of T rows
// [M][ld] into the A chunk As [kBM][BK + 8] (zero-filled past K), a 16-byte
// piece a thread at a time.
template <typename T>
__device__ void load_a(T* As, const T* A, int ld, int K, int k0, int BK, int row0, int M) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(A) % 16 == 0 && ld % VW == 0;
  const int per = BK / VW;  // thread t: piece t % per of rows t / per + j * (kThreads / per)
  const int col = (threadIdx.x % per) * VW, k = k0 + col, valid = min(VW, max(0, K - k));
  for (int r = threadIdx.x / per; r < kBM; r += kThreads / per) {
    const T* src = A + (size_t)min(row0 + r, M - 1) * ld + k;
    T* dst = As + r * (BK + 8) + col;
    if (vec) {
      cp_async16(dst, valid > 0 ? src : A, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) dst[e] = Num<T>::from_f(e < valid ? ldcg(src + e) : 0.0f);
    }
  }
}

// The accumulators of a tile [kBM][ncols] across the threads.
template <typename T>
struct Acc;

// bf16: warp (wm, wn) owns rows 16 wm.. (wm < 4) and the wn-th quarter of
// the 8-column tiles
template <>
struct Acc<__nv_bfloat16> {
  static constexpr int kWN = kWarps / 4;        // warps along the columns
  static constexpr int kNT = kMaxBN / 8 / kWN;  // 8-column tiles a warp at most
  float c[kNT][4];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;
  }

  // the warp's first tile and its tile count
  __device__ static void tiles(int ncols, int& j0, int& jn) {
    const int nt = ncols / 8, per = (nt + kWN - 1) / kWN;
    j0 = (threadIdx.x >> 7) * per;
    jn = max(0, min(per, nt - j0));
  }

  // += A [kBM][lda] (columns 0.. BK) times W [BK][ldws]
  __device__ void mac(const __nv_bfloat16* A, int lda, const __nv_bfloat16* Ws, int ldws,
                      int ncols, int BK) {
    const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) & 3;
    int j0, jn;
    tiles(ncols, j0, jn);
#pragma unroll 4
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_a(a, A + (wm * 16 + (lane & 15)) * lda + ks * 16 + (lane >> 4) * 8);
      // two tiles' B fragments a load where both are the warp's; each
      // 8-deep product from zero, added to the sum in float32 in k order
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        if (j + 1 < jn) {
          uint32_t b4[4];
          ldmatrix_b2(b4, Ws + (ks * 16 + (lane & 15)) * ldws + (j0 + j + (lane >> 4)) * 8);
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
          float d0[4], d1[4], e0[4], e1[4];
          mma_bf16_k8(d0, a[0], a[1], b0[0]);
          mma_bf16_k8(d1, a[0], a[1], b1[0]);
          mma_bf16_k8(e0, a[2], a[3], b0[1]);
          mma_bf16_k8(e1, a[2], a[3], b1[1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            c[j][i] += d0[i];
            c[j + 1][i] += d1[i];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            c[j][i] += e0[i];
            c[j + 1][i] += e1[i];
          }
        } else if (j < jn) {
          uint32_t b[2];
          ldmatrix_b(b, Ws + (ks * 16 + (lane & 15)) * ldws + (j0 + j) * 8);
          float d[4], e[4];
          mma_bf16_k8(d, a[0], a[1], b[0]);
          mma_bf16_k8(e, a[2], a[3], b[1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) c[j][i] += d[i];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[j][i] += e[i];
        }
      }
    }
  }

  // f(r, col, v) for each value this thread holds
  template <typename Fn>
  __device__ void each(int ncols, Fn f) const {
    const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
    int j0, jn;
    tiles(ncols, j0, jn);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < jn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f(wm * 16 + g + (i >> 1) * 8, (j0 + j) * 8 + 2 * q + (i & 1), c[j][i]);
  }
};

// CUDA-core products (float32): output o = tid + i * kThreads of the tile
// is row o / ncols, column o % ncols, summed by FMAs in k order
template <typename T>
struct AccFma {
  static constexpr int kOut = kBM * kMaxBN / kThreads;
  float c[kOut];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kOut; ++i) c[i] = 0.0f;
  }

  __device__ void mac(const T* A, int lda, const T* Ws, int ldws, int ncols, int BK) {
    const int total = kBM * ncols;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o < total) {
        const int r = o / ncols, col = o - r * ncols;
        const T* a = A + r * lda;
        const T* w = Ws + col;
        float v = c[i];
#pragma unroll 8
        for (int k = 0; k < BK; ++k) v = fmaf(Num<T>::to_f(a[k]), Num<T>::to_f(w[k * ldws]), v);
        c[i] = v;
      }
    }
  }

  template <typename Fn>
  __device__ void each(int ncols, Fn f) const {
    const int total = kBM * ncols;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o < total) f(o / ncols, o % ncols, c[i]);
    }
  }
};

template <>
struct Acc<float> : AccFma<float> {};

// The cycles the first thread of CTA 0 spends in each phase's tiles and
// in the grid barrier after it (prof[2 * phase], prof[2 * phase + 1]) and
// in the parts of the phases (prof[kPart + i]; BEAM_PHASES and BEAM_PARTS
// in ops/fused_beam.py name them), summed over the launch; prof is null in
// every other thread and without a profile.
constexpr int kPart = 14;
struct Clock {
  long long* prof;
  long long t0;
  __device__ void at(int i) {
    if (prof != nullptr) {
      const long long t = clock64();
      prof[i] += t - t0;
      t0 = t;
    }
  }
};

__device__ long long* profiler(long long* prof) {
  return threadIdx.x == 0 && blockIdx.x == 0 ? prof : nullptr;
}

__device__ Clock start_clock(long long* prof) {
  return Clock{prof, prof != nullptr ? (long long)clock64() : 0};
}

// One pass of a tile's product: rows row0.. (< M) of the A operand `a`
// (depth K) by the pass's columns of W [K][ldw], plus the bias of column
// d of segment s at bias[s * bstride + d], into out [kBM][ncols] (float32,
// the start of shared memory; rows past M hold nothing of use); with `res`
// (float32 rows of stride E at the pass's first column) its tile is staged
// beside the product, into aux [kBM][ncols].  Called by every thread of
// the CTA; not inlined, so one copy serves every phase.
template <typename T>
__device__ __noinline__ void product(const Layout<T> lay, const AOp<T> a, int K, const T* W,
                                     int ldw, const Cols cols, const T* bias, int bstride,
                                     const float* res, int E, int row0, int M,
                                     unsigned char* smem, long long* prof) {
  constexpr int VW = 16 / sizeof(T), S = Layout<T>::kStages;
  Clock ck = start_clock(prof);
  float* aux = reinterpret_cast<float*>(smem + lay.ring_w + lay.a_region);
  float* bs = aux + lay.aux / 4;                               // [kMaxBN]
  const float* stats = bs + kMaxBN;                            // [kBM][2]
  const int ncols = cols.ncols(), wp = cols.wp(), ldws = ncols + 8;
  constexpr int BK = Layout<T>::kBK, LdA = Layout<T>::kLdA;
  const int KC = (K + BK - 1) / BK;
  T* Ws = reinterpret_cast<T*>(smem);             // [S][BK][ldws]
  T* As = Ws + S * BK * ldws;                     // [S][kBM][BK + 8]
  const bool vec = reinterpret_cast<uintptr_t>(W) % 16 == 0 && ldw % VW == 0 &&
                   cols.c0 % VW == 0 && (cols.nseg == 1 || cols.stride % VW == 0);
  const bool stream = !a.resident && a.rows == nullptr;
  // this thread's bias value, loaded while the first chunks are issued
  float bias_v = 0.0f;
  if ((int)threadIdx.x < ncols) {
    const int s = cols.nseg == 1 ? 0 : threadIdx.x / wp, d = threadIdx.x - s * wp;
    if (d < cols.w) bias_v = Num<T>::load(bias + s * bstride + d);
  }
  if (res != nullptr)
    for (int r = threadIdx.x >> 5; r < kBM; r += kWarps)
      stage(aux + r * ncols, res + (size_t)min(row0 + r, M - 1) * E, cols.w, threadIdx.x & 31, 32);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KC) {
      load_w(Ws + s * BK * ldws, ldws, W, ldw, K, s * BK, BK, cols, vec);
      if (stream) load_a(As + s * kBM * LdA, a.src, a.ld, K, s * BK, BK, row0, M);
    }
    cp_commit();
  }
  if ((int)threadIdx.x < ncols) bs[threadIdx.x] = bias_v;
  Acc<T> acc;
  acc.zero();
  AStage<T> st;
  if (a.rows != nullptr) {
    st.load(*a.rows, row0, M, K, 0);
    st.store(*a.rows, stats, As, row0, M, K, 0);
  }
  ck.at(kPart + 0);
  for (int kc = 0; kc < KC; ++kc) {
    cp_wait<S - 2>();  // chunk kc (this thread's pieces)
    __syncthreads();   // ... and everyone's; chunk kc - 1's slots are free
    ck.at(kPart + 1);
    const int nx = kc + S - 1;
    if (nx < KC) {
      load_w(Ws + (nx % S) * BK * ldws, ldws, W, ldw, K, nx * BK, BK, cols, vec);
      if (stream) load_a(As + (nx % S) * kBM * LdA, a.src, a.ld, K, nx * BK, BK, row0, M);
    }
    cp_commit();
    if (a.rows != nullptr && kc + 1 < KC) st.load(*a.rows, row0, M, K, (kc + 1) * BK);
    ck.at(kPart + 10);
    if (a.resident)
      acc.mac(a.src + kc * BK, a.ld, Ws + (kc % S) * BK * ldws, ldws, ncols, BK);
    else
      acc.mac(As + (kc % S) * kBM * LdA, LdA, Ws + (kc % S) * BK * ldws, ldws, ncols, BK);
    if (a.rows != nullptr && kc + 1 < KC)
      st.store(*a.rows, stats, As + ((kc + 1) % S) * kBM * LdA, row0, M, K, (kc + 1) * BK);
    ck.at(kPart + 11);
  }
  cp_wait<0>();
  __syncthreads();
  ck.at(kPart + 1);
  float* out = reinterpret_cast<float*>(smem);
  acc.each(ncols, [&](int r, int c, float v) { out[r * ncols + c] = v + bs[c]; });
  __syncthreads();
  ck.at(kPart + 2);
}

// A pass of a product over nseg segments of w columns (segment s at column
// c0 + s * stride): all segments at once where they fit kMaxBN, else each
// segment in pieces of kMaxBN; pass i covers the segments s0.. and the
// columns d0.. of each.
struct Pass {
  Cols cols;
  int s0, d0;
};

__device__ int passes(int nseg, int w) {
  return nseg * ((w + 7) & ~7) <= kMaxBN ? 1 : nseg * ((w + kMaxBN - 1) / kMaxBN);
}

__device__ Pass pass_of(int c0, int stride, int nseg, int w, int i) {
  if (nseg * ((w + 7) & ~7) <= kMaxBN) return Pass{Cols{c0, stride, nseg, w}, 0, 0};
  const int per = (w + kMaxBN - 1) / kMaxBN, s = i / per, d0 = (i - s * per) * kMaxBN;
  return Pass{Cols{c0 + s * stride + d0, 0, 1, min(kMaxBN, w - d0)}, s, d0};
}

// f(r, s, d, v) for the pass's outputs in out [kBM][ncols]: rows r < rows
// (warp w the rows w, w + 8, ..), segment s, column d of the whole segment
// (lane l the columns l, l + 32, ..)
template <typename F>
__device__ void each_out(const float* out, const Pass& ps, int rows, F f) {
  const int wp = ps.cols.wp(), ncols = ps.cols.ncols();
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps)
    for (int j = 0; j < ps.cols.nseg; ++j)
      for (int d = threadIdx.x & 31; d < ps.cols.w; d += 32)
        f(r, ps.s0 + j, ps.d0 + d, out[r * ncols + j * wp + d]);
}

// The A operand of a phase that reads a layernorm's output (or at layer 0
// the input rows x): rows row0.. of src [M][E] (float32), with g the
// layernorm's scale (b its bias; none where g is null) normalized, the
// normalized rows written to xw where it is not null.  Resident: the rows
// staged by cp.async, normalized one warp a row (add_layernorm's order)
// and rounded into shared memory [kBM][ldr] (zero past E); otherwise the
// row statistics for the staged chunks.
template <typename T>
__device__ AOp<T> ln_rows(const Layout<T> lay, const ARows& in, int E, float eps, int row0,
                          int M, unsigned char* smem, long long* prof) {
  const ARows rows = in;
  Clock ck = start_clock(prof);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T *g = (const T*)rows.g, *b = (const T*)rows.b;
  if (!lay.resident) {
    float* stats = reinterpret_cast<float*>(smem + lay.ring_w + lay.a_region + lay.aux) + kMaxBN;
    for (int r = warp; r < kBM; r += kWarps) {
      const float* x = rows.src + (size_t)min(row0 + r, M - 1) * E;
      float sum = 0.0f;
      for (int e = lane; e < E; e += 32) sum += __ldcg(x + e);
      const float mean = warp_sum(sum) / (float)E;
      float sq = 0.0f;
      for (int e = lane; e < E; e += 32) {
        const float d = __ldcg(x + e) - mean;
        sq += d * d;
      }
      const float inv = rsqrtf(warp_sum(sq) / (float)E + eps);  // every lane shuffles
      if (lane == 0) {
        stats[2 * r] = mean;
        stats[2 * r + 1] = inv;
      }
    }
    __syncthreads();
    ck.at(kPart + 3);
    return AOp<T>{nullptr, E, false, &in};
  }
  float* f = reinterpret_cast<float*>(smem);  // [kBM][E], in the weight ring
  float* gb = f + kBM * E;                     // the scale and bias [2][E] as float
  T* A = reinterpret_cast<T*>(smem + lay.ring_w);
  for (int r = warp; r < kBM; r += kWarps)
    stage(f + r * E, rows.src + (size_t)min(row0 + r, M - 1) * E, E, lane, 32);
  cp_commit();
  if (g != nullptr)
    for (int e = threadIdx.x; e < E; e += kThreads) {
      gb[e] = Num<T>::load(g + e);
      gb[E + e] = Num<T>::load(b + e);
    }
  cp_wait<0>();
  __syncthreads();
  ck.at(kPart + 12);
  // warp w the rows w + j * kWarps, their sums reduced together; a lane
  // four adjacent columns at a time where E allows it
  constexpr int RW = kBM / kWarps;
  const int cw = E % 4 == 0 ? 4 : 1, groups = E / cw;
  float mean[RW], inv[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    mean[j] = 0.0f;
    inv[j] = 1.0f;
  }
  if (g != nullptr) {
    float sum[RW], sq[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const float* x = f + (warp + j * kWarps) * E;
      sum[j] = 0.0f;
      for (int q = lane; q < groups; q += 32) {
        if (cw == 4) {
          const float4 v = *reinterpret_cast<const float4*>(x + 4 * q);
          sum[j] += (v.x + v.y) + (v.z + v.w);
        } else {
          sum[j] += x[q];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) mean[j] = warp_sum(sum[j]) / (float)E;
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const float* x = f + (warp + j * kWarps) * E;
      sq[j] = 0.0f;
      for (int q = lane; q < groups; q += 32) {
        if (cw == 4) {
          const float4 v = *reinterpret_cast<const float4*>(x + 4 * q);
          const float a = v.x - mean[j], b2 = v.y - mean[j], c = v.z - mean[j], d = v.w - mean[j];
          sq[j] += (a * a + b2 * b2) + (c * c + d * d);
        } else {
          const float d = x[q] - mean[j];
          sq[j] += d * d;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) inv[j] = rsqrtf(warp_sum(sq[j]) / (float)E + eps);
  }
  for (int q = lane; q < groups; q += 32) {
    if (cw == 4) {
      const int e = 4 * q;
      float4 ge = make_float4(1.0f, 1.0f, 1.0f, 1.0f), be = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g != nullptr) {
        ge = *reinterpret_cast<const float4*>(gb + e);
        be = *reinterpret_cast<const float4*>(gb + E + e);
      }
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int r = warp + j * kWarps;
        float4 v = *reinterpret_cast<const float4*>(f + r * E + e);
        if (g != nullptr) {
          v.x = (v.x - mean[j]) * inv[j] * ge.x + be.x;
          v.y = (v.y - mean[j]) * inv[j] * ge.y + be.y;
          v.z = (v.z - mean[j]) * inv[j] * ge.z + be.z;
          v.w = (v.w - mean[j]) * inv[j] * ge.w + be.w;
        }
        if (rows.xw != nullptr && row0 + r < M)
          __stcg(reinterpret_cast<float4*>(rows.xw + (size_t)(row0 + r) * E + e), v);
        T* a = A + r * lay.ldr + e;
        a[0] = Num<T>::from_f(v.x);
        a[1] = Num<T>::from_f(v.y);
        a[2] = Num<T>::from_f(v.z);
        a[3] = Num<T>::from_f(v.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int r = warp + j * kWarps;
        float v = f[r * E + q];
        if (g != nullptr) v = (v - mean[j]) * inv[j] * gb[q] + gb[E + q];
        if (rows.xw != nullptr && row0 + r < M) __stcg(rows.xw + (size_t)(row0 + r) * E + q, v);
        A[r * lay.ldr + q] = Num<T>::from_f(v);
      }
    }
  }
  for (int i = threadIdx.x; i < kBM * (lay.ldr - 8 - E); i += kThreads) {  // zero past E
    const int r = i / (lay.ldr - 8 - E), e = E + i % (lay.ldr - 8 - E);
    A[r * lay.ldr + e] = Num<T>::from_f(0.0f);
  }
  __syncthreads();
  ck.at(kPart + 3);
  return AOp<T>{A, lay.ldr, true, nullptr};
}

// -- attention ---------------------------------------------------------------

// In place over scores[r * S + s] for r < rows, s < len: softmax over s in
// float32, one warp a row, each probability rounded to T.
template <typename T>
__device__ void softmax_rows(float* probs, int rows, int S, int len) {
  constexpr int RW = kBM / kWarps;  // warp w the rows w + j * kWarps, reduced together
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m[RW], sum[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const float* pr = probs + (warp + j * kWarps) * S;
    m[j] = -__int_as_float(0x7f800000);
    if (warp + j * kWarps < rows)
      for (int s = lane; s < len; s += 32) m[j] = fmaxf(m[j], pr[s]);
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) m[j] = warp_max(m[j]);
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    float* pr = probs + (warp + j * kWarps) * S;
    sum[j] = 0.0f;
    if (warp + j * kWarps < rows)
      for (int s = lane; s < len; s += 32) {
        const float e = expf(pr[s] - m[j]);
        pr[s] = e;
        sum[j] += e;
      }
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) sum[j] = warp_sum(sum[j]);
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    float* pr = probs + (warp + j * kWarps) * S;
    if (warp + j * kWarps < rows)
      for (int s = lane; s < len; s += 32) pr[s] = Num<T>::round(pr[s] / sum[j]);
  }
}

// Where a position's key and value rows live (head h's columns): for the
// self-attention, row m's position s < t in slot slot[(m - row0) * T + s]
// of its batch row's caches and position t in its own slot m % K; for the
// cross-attention (slot null), its batch row's memory.
template <typename T>
struct KV {
  const T *k, *v;
  const int* slot;
  int row0, K, T_, t, Tm, E;
  __device__ const T* at(int m, int s, bool key) const {
    const int b = m / K;
    const size_t row = slot != nullptr
                           ? ((size_t)b * K + (s < t ? slot[(m - row0) * T_ + s] : m - b * K)) * T_ + s
                           : (size_t)b * Tm + s;
    return (key ? k : v) + row * E;
  }
};

// Positions s0.. s0 + n of the keys (key) or values of rows row0.. row0 +
// rows into stage [rows][P][hdp]: warp w the rows w, w + 8, .., lane l the
// positions l, l + 32, .. (16-byte cp.async pieces where the head's
// columns are whole pieces); waits and synchronises.
template <typename T>
__device__ void stage_kv(const Layout<T>& lay, T* stage, int row0, int rows, int s0, int n,
                         bool key, const KV<T>& kv) {
  constexpr int VW = 16 / sizeof(T);
  const int hd = lay.hd, hdp = lay.hdp, P = lay.P, lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps)
    for (int s = lane; s < n; s += 32) {
      const T* src = kv.at(row0 + r, s0 + s, key);
      T* dst = stage + (r * P + s) * hdp;
      if (hd % VW == 0) {
        for (int c = 0; c < hd; c += VW) cp_async16(dst + c, src + c, 16);
      } else {
        for (int d = 0; d < hd; ++d) copy1(dst + d, src + d);
      }
    }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
}

// The attention of head h for the rows row0.. (< M) of a tile over
// positions s < len (keys and values where kv says; the self-attention's
// slots of positions s < len - 1 from the ancestry map).  The queries,
// rounded to T, are in ctx[m][h * hd..], where the context, rounded to T,
// replaces them.  cross: the value products are rounded to T (the
// cross-attention's), else summed unrounded (the self-attention's).  The
// rows go in groups of lay.RA, the keys and values of a group into shared
// memory P positions at a time; warp w takes the rows w, w + 8, .., a lane
// a position (scores) or a column (context sums).  Not inlined: one copy
// serves both attentions.
template <typename T>
__device__ __noinline__ void attend(const Params<T>& p, const Layout<T> lay, int row0, int M,
                                    int h, int len, const KV<T> kv_tile, bool cross,
                                    unsigned char* smem, long long* prof) {
  constexpr int VW = 16 / sizeof(T);
  Clock ck = start_clock(prof);
  const int E = p.E, T_ = p.steps, hd = lay.hd, hdp = lay.hdp, S = lay.S, P = lay.P;
  const int RA = lay.RA, rows = min(kBM, M - row0), lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* stage = reinterpret_cast<T*>(smem);                                    // [RA][P][hdp]
  float* q = reinterpret_cast<float*>(smem + (size_t)RA * P * hdp * sizeof(T));  // [RA][hdp]
  float* probs = q + RA * hdp;                                              // [RA][S]
  int* slot = reinterpret_cast<int*>(probs + RA * S);                       // [RA][T]
  for (int g0 = 0; g0 < rows; g0 += RA) {
    const int nr = min(RA, rows - g0), r0 = row0 + g0;
    KV<T> kv = kv_tile;
    kv.row0 = r0;
    if (kv.slot != nullptr) kv.slot = slot;
    for (int r = warp; r < nr; r += kWarps) {
      for (int d = lane; d < hd; d += 32) q[r * hdp + d] = ldcg(p.ctx + (size_t)(r0 + r) * E + h * hd + d);
      if (!cross)
        for (int s = lane; s < len - 1; s += 32) slot[r * T_ + s] = ldcg(p.anc + (size_t)(r0 + r) * T_ + s);
    }
    __syncthreads();
    ck.at(kPart + 4);
    for (int s0 = 0; s0 < len; s0 += P) {
      const int n = min(P, len - s0);
      stage_kv(lay, stage, r0, nr, s0, n, true, kv);
      ck.at(kPart + 4);
      for (int r = warp; r < nr; r += kWarps) {
        const float* qr = q + r * hdp;
        for (int s = lane; s < n; s += 32) {
          const T* k = stage + (r * P + s) * hdp;
          float acc = 0.0f;
          if (hd % VW == 0) {
            for (int d = 0; d < hd; d += VW) {
              const uint4 kw = *reinterpret_cast<const uint4*>(k + d);
#pragma unroll
              for (int i = 0; i < VW; ++i) {
                const float qd = qr[d + i], kd = widen<T>(kw, i);
                acc += Num<T>::round(qd * kd);
              }
            }
          } else {
            for (int d = 0; d < hd; ++d) {
              const float qd = qr[d], kd = Num<T>::to_f(k[d]);
              acc += Num<T>::round(qd * kd);
            }
          }
          probs[r * S + s0 + s] = acc * p.scale;
        }
      }
      __syncthreads();
      ck.at(kPart + 5);
    }
    softmax_rows<T>(probs, nr, S, len);
    for (int i = threadIdx.x; i < nr * hdp; i += kThreads) q[i] = 0.0f;  // the context sums
    __syncthreads();
    ck.at(kPart + 6);
    for (int s0 = 0; s0 < len; s0 += P) {
      const int n = min(P, len - s0);
      stage_kv(lay, stage, r0, nr, s0, n, false, kv);
      ck.at(kPart + 4);
      for (int r = warp; r < nr; r += kWarps) {
        const float* pr = probs + r * S + s0;
        for (int d = lane; d < hd; d += 32) {
          float acc = q[r * hdp + d];
          if (cross) {
            for (int s = 0; s < n; ++s) {
              const float v = Num<T>::to_f(stage[(r * P + s) * hdp + d]);
              acc += Num<T>::round(pr[s] * v);
            }
          } else {
            for (int s = 0; s < n; ++s) {
              const float v = Num<T>::to_f(stage[(r * P + s) * hdp + d]);
              acc += pr[s] * v;  // the product is not rounded
            }
          }
          q[r * hdp + d] = acc;
        }
      }
      __syncthreads();
      ck.at(kPart + 7);
    }
    for (int r = warp; r < nr; r += kWarps)
      for (int d = lane; d < hd; d += 32)
        stcg(p.ctx + (size_t)(r0 + r) * E + h * hd + d, q[r * hdp + d]);
    __syncthreads();
    ck.at(kPart + 7);
  }
}

// -- the phases --------------------------------------------------------------

template <typename T>
__device__ float* aux_of(const Layout<T>& lay, unsigned char* smem) {
  return reinterpret_cast<float*>(smem + lay.ring_w + lay.a_region);
}

// 1: qkv of head h for row tile mt, the cache write of position t, and the
// self-attention over each beam's history (position s < t from slot
// anc[b, k, s], position t from the beam's own slot k).
template <typename T>
__device__ __noinline__ void qkv_tile(const Params<T>& p, const Layout<T> lay, int l, int t,
                                      int mt, int h, unsigned char* smem) {
  const int E = p.E, K = p.K, T_ = p.steps, M = p.B * K, hd = lay.hd, row0 = mt * kBM;
  const int rows = min(kBM, M - row0);
  long long* prof = profiler(p.prof);
  const ARows in = l == 0 ? ARows{p.x, nullptr, nullptr, nullptr}
                          : ARows{p.pre, p.n3_s + (size_t)(l - 1) * E,
                                  p.n3_b + (size_t)(l - 1) * E, h == 0 ? p.x : nullptr};
  const AOp<T> a = ln_rows(lay, in, E, p.eps, row0, M, smem, prof);
  const size_t cache_l = (size_t)p.B * K * T_ * E;
  const float* out = reinterpret_cast<const float*>(smem);
  for (int i = 0; i < passes(3, hd); ++i) {
    const Pass ps = pass_of(h * hd, E, 3, hd, i);
    product(lay, a, E, p.w_qkv + (size_t)l * E * 3 * E, 3 * E, ps.cols,
            p.b_qkv + (size_t)l * 3 * E + h * hd + ps.s0 * E + ps.d0, E, nullptr, 0, row0, M,
            smem, prof);
    Clock ck = start_clock(prof);
    each_out(out, ps, rows, [&](int r, int s, int d, float v) {
      if (s == 0) {  // the query, rounded to T, where the context will go
        stcg(p.ctx + (size_t)(row0 + r) * E + h * hd + d, v);
      } else {  // slot m % K of batch row m / K, position t
        T* cache = (s == 1 ? p.kc : p.vc) + l * cache_l;
        stcg(cache + ((size_t)(row0 + r) * T_ + t) * E + h * hd + d, v);
      }
    });
    __syncthreads();
    ck.at(kPart + 8);
  }
  // the slots of positions s < t come from the ancestry map (attend)
  const KV<T> kv{p.kc + l * cache_l + h * hd, p.vc + l * cache_l + h * hd, p.anc, row0, K, T_, t,
                 p.Tm, E};
  attend(p, lay, row0, M, h, t + 1, kv, false, smem, prof);
}

// 3: LN1, the cross query of head h for row tile mt and the
// cross-attention over the row's memory K/V
template <typename T>
__device__ __noinline__ void cross_tile(const Params<T>& p, const Layout<T> lay, int l, int mt,
                                        int h, unsigned char* smem) {
  const int E = p.E, K = p.K, M = p.B * K, hd = lay.hd, row0 = mt * kBM;
  const int rows = min(kBM, M - row0);
  long long* prof = profiler(p.prof);
  const ARows in{p.pre, p.n1_s + (size_t)l * E, p.n1_b + (size_t)l * E, h == 0 ? p.x : nullptr};
  const AOp<T> a = ln_rows(lay, in, E, p.eps, row0, M, smem, prof);
  const float* out = reinterpret_cast<const float*>(smem);
  for (int i = 0; i < passes(1, hd); ++i) {
    const Pass ps = pass_of(h * hd, 0, 1, hd, i);
    product(lay, a, E, p.cw_q + (size_t)l * E * E, E, ps.cols,
            p.cb_q + (size_t)l * E + h * hd + ps.d0, 0, nullptr, 0, row0, M, smem, prof);
    Clock ck = start_clock(prof);
    each_out(out, ps, rows, [&](int r, int, int d, float v) {
      stcg(p.ctx + (size_t)(row0 + r) * E + h * hd + d, v);  // the query, rounded to T
    });
    __syncthreads();
    ck.at(kPart + 8);
  }
  const size_t mem_l = (size_t)p.B * p.Tm * E;
  const KV<T> kv{p.ck + l * mem_l + h * hd, p.cv + l * mem_l + h * hd, nullptr, row0, K,
                 p.steps, 0, p.Tm, E};
  attend(p, lay, row0, M, h, p.Tm, kv, true, smem, prof);
}

// 2, 4, 6: pre = x + (A W + b) for row tile mt and column tile nt (bn
// columns) of E, A [M][K] in T
template <typename T>
__device__ __noinline__ void residual_tile(const Params<T>& p, const Layout<T> lay, const T* A,
                                           int K, const T* W, const T* bias, int mt, int nt,
                                           int bn, unsigned char* smem) {
  const int E = p.E, M = p.B * p.K, n0 = nt * bn, row0 = mt * kBM;
  long long* prof = profiler(p.prof);
  const Pass ps{Cols{n0, 0, 1, min(bn, E - n0)}, 0, 0};
  product(lay, AOp<T>{A, K, false, nullptr}, K, W, E, ps.cols, bias + n0, 0, p.x + n0, E, row0, M,
          smem, prof);
  Clock ck = start_clock(prof);
  const float* x = aux_of(lay, smem);  // [kBM][ncols] the residual rows' columns
  const int nc = ps.cols.ncols();
  each_out(reinterpret_cast<const float*>(smem), ps, min(kBM, M - row0),
           [&](int r, int, int d, float v) {
             __stcg(p.pre + (size_t)(row0 + r) * E + n0 + d, x[r * nc + d] + v);
           });
  __syncthreads();
  ck.at(kPart + 8);
}

// 5: LN2 and ff1 + ReLU for row tile mt and column tile nt (bn columns) of F
template <typename T>
__device__ __noinline__ void ff1_tile(const Params<T>& p, const Layout<T> lay, int l, int mt,
                                      int nt, int bn, unsigned char* smem) {
  const int E = p.E, F = p.F, M = p.B * p.K, n0 = nt * bn, row0 = mt * kBM;
  long long* prof = profiler(p.prof);
  const ARows in{p.pre, p.n2_s + (size_t)l * E, p.n2_b + (size_t)l * E, nt == 0 ? p.x : nullptr};
  const AOp<T> a = ln_rows(lay, in, E, p.eps, row0, M, smem, prof);
  const Pass ps{Cols{n0, 0, 1, min(bn, F - n0)}, 0, 0};
  product(lay, a, E, p.ff1_w + (size_t)l * E * F, F, ps.cols, p.ff1_b + (size_t)l * F + n0, 0,
          nullptr, 0, row0, M, smem, prof);
  Clock ck = start_clock(prof);
  each_out(reinterpret_cast<const float*>(smem), ps, min(kBM, M - row0),
           [&](int r, int, int d, float v) {
             const T h = Num<T>::from_f(fmaxf(v, 0.0f));
             stcg(p.hid + (size_t)(row0 + r) * F + n0 + d, h);
           });
  __syncthreads();
  ck.at(kPart + 8);
}

// 7: batch rows tile * rows7.. : LN3, the final LN, the class head (a
// product over the tile's rows, rounded into ctx as its A operand, its
// logits into device memory), the candidates, top-K, the fold and the next
// step's input rows
template <typename T>
__device__ __noinline__ void topk_tile(const Params<T>& p, const Layout<T> lay, int t, int tile,
                                       unsigned char* smem) {
  const int K = p.K, E = p.E, C = p.C, T_ = p.steps, L = p.L, M = p.B * K;
  const int b0 = tile * p.rows7, nb = min(p.rows7, p.B - b0), R = nb * K, m0 = b0 * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R7 = p.rows7 * K;  // the layout's rows (the last tile may hold fewer)
  long long* prof = profiler(p.prof);
  int* tok = p.state;
  int* fin = tok + M;
  int* live = fin + M;
  int* flag = live + p.B;
  float* xs = reinterpret_cast<float*>(smem);  // [R][E], in the weight ring

  Clock ck = start_clock(prof);
  for (int r = warp; r < R; r += kWarps) stage(xs + r * E, p.pre + (size_t)(m0 + r) * E, E, lane, 32);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  add_layernorm<T>(xs, R, nullptr, 0, p.n3_s + (size_t)(L - 1) * E, p.n3_b + (size_t)(L - 1) * E,
                   E, p.eps);
  __syncthreads();
  add_layernorm<T>(xs, R, nullptr, 0, p.fn_s, p.fn_b, E, p.eps);
  __syncthreads();
  for (int i = tid; i < R * E; i += kThreads) stcg(p.ctx + (size_t)m0 * E + i, xs[i]);
  __threadfence_block();
  __syncthreads();
  ck.at(kPart + 3);
  const float* out = reinterpret_cast<const float*>(smem);
  for (int i = 0; i < passes(1, C); ++i) {
    const Pass ps = pass_of(0, 0, 1, C, i);
    product(lay, AOp<T>{p.ctx, E, false, nullptr}, E, p.head_w, C, ps.cols, p.head_b + ps.d0, 0,
            nullptr, 0, m0, m0 + R, smem, prof);
    ck.at(kPart + 8);
    each_out(out, ps, R, [&](int r, int, int c, float v) {
      __stcg(p.logits + (size_t)(m0 + r) * C + c, v);
    });
    __syncthreads();
    ck.at(kPart + 8);
  }

  // the product done, shared memory from 0 holds the tile's logits (then
  // candidates), the histories of positions < t and per-beam scalars
  float* lg = reinterpret_cast<float*>(smem);  // [R][C]
  int* hist = reinterpret_cast<int*>(lg + R7 * C);  // [R][T] ancestry of positions < t
  int* seqh = hist + R7 * T_;                  // [R][T] tokens of positions < t
  int* par = seqh + R7 * T_;                   // [R] parent beam of each new beam
  int* tokn = par + R7;                        // [R] new token
  int* fin0 = tokn + R7;                       // [R] finished flags before the step
  int* finn = fin0 + R7;                       // [R] ... after it
  int* tokx = finn + R7;                       // [R] next step's input token
  float* scn = reinterpret_cast<float*>(tokx + R7);  // [R] new scores
  int* keep = reinterpret_cast<int*>(scn + R7);      // [nb] rows still searching
  stage(lg, p.logits + (size_t)m0 * C, R * C, tid, kThreads);
  cp_commit();
  for (int r = warp; r < R; r += kWarps)
    for (int s = lane; s < t; s += 32) {
      hist[r * T_ + s] = ldcg(p.anc + (size_t)(m0 + r) * T_ + s);
      seqh[r * T_ + s] = ldcg(p.tokens + (size_t)(m0 + r) * T_ + s);
    }
  if (tid < R) fin0[tid] = ldcg(fin + m0 + tid);
  if (tid < nb) keep[tid] = !p.early_stop || ldcg(live + b0 + tid);
  cp_wait<0>();
  __syncthreads();

  // candidate scores, one warp a beam: f32 log-softmax (a finished beam
  // continues only with eos_id, at zero cost) plus the beam's score
  for (int r = warp; r < R; r += kWarps) {
    float* row = lg + r * C;
    float mx = -__int_as_float(0x7f800000);
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += expf(row[c] - mx);
    const float lse = logf(warp_sum(sum));
    const float score = __ldcg(p.scores + m0 + r);
    for (int c = lane; c < C; c += 32) {
      const float logp = fin0[r] ? (c == p.eos_id ? 0.0f : kNeg) : row[c] - mx - lse;
      row[c] = logp + score;
    }
  }
  __syncthreads();

  // top-K, one warp a batch row: K extractions of (maximum, first flat index)
  const int KC = K * C;
  for (int bl = warp; bl < nb; bl += kWarps) {
    float* cand = lg + bl * KC;
    for (int k = 0; k < K; ++k) {
      float best = -__int_as_float(0x7f800000);
      int bi = KC;
      for (int i = lane; i < KC; i += 32) {
        const float v = cand[i];
        if (v > best) { best = v; bi = i; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (bi >= KC) bi = 0;  // all-NaN candidates: a valid index
      if (lane == 0) {
        cand[bi] = kNeg;
        scn[bl * K + k] = best;
        par[bl * K + k] = bi / C;
        tokn[bl * K + k] = bi - (bi / C) * C;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // fold the parents' ancestry, tokens and finished flags into the new
  // beams of the rows still searching, then record position t
  for (int i = tid; i < R * (t + 1); i += kThreads) {
    const int r = i / (t + 1), s = i - r * (t + 1), bl = r / K;
    if (keep[bl]) {
      const int pr = bl * K + par[r];
      const size_t at = (size_t)(m0 + r) * T_ + s;
      p.anc[at] = s < t ? hist[pr * T_ + s] : par[r];
      p.tokens[at] = s < t ? seqh[pr * T_ + s] : tokn[r];
    }
  }
  if (tid < R) {
    const int bl = tid / K, m = m0 + tid;
    if (keep[bl]) {
      finn[tid] = fin0[bl * K + par[tid]] | (tokn[tid] == p.eos_id);
      fin[m] = finn[tid];
      p.scores[m] = scn[tid];
      tok[m] = tokx[tid] = tokn[tid];
    } else {
      tokx[tid] = ldcg(tok + m);
    }
  }
  __syncthreads();
  if (p.early_stop && tid < nb && keep[tid]) {
    bool all_done = true;
    for (int k = 0; k < K; ++k) all_done &= finn[tid * K + k] != 0;
    live[b0 + tid] = !all_done;
    if (!all_done) atomicOr(flag + t, 1);
  }
  // the next step's input rows, eight loads a thread in flight
  if (t + 1 < T_) {
    for (int i0 = 0; i0 < R * E; i0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * kThreads + tid, r = i / E, e = i - r * E;
        if (i < R * E) v[j] = Num<T>::load(p.emb + (size_t)tokx[r] * E + e) + p.pe[(t + 1) * E + e];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * kThreads + tid;
        if (i < R * E) __stcg(p.x + (size_t)m0 * E + i, v[j]);
      }
    }
  }
  __syncthreads();
  ck.at(kPart + 9);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) beam_grid_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Layout<T> lay(p);
  const int E = p.E, F = p.F, H = p.H, K = p.K, T_ = p.steps, L = p.L, B = p.B;
  const int M = B * K, Mt = (M + kBM - 1) / kBM;
  const int cta = blockIdx.x, nct = gridDim.x;
  const int gid = cta * kThreads + threadIdx.x, gn = nct * kThreads;
  int* tok = p.state;
  int* fin = tok + M;
  int* live = fin + M;
  int* flag = live + B;

  // the search's start: only beam 0 live, every beam's step-0 input row
  for (int i = gid; i < M * T_; i += gn) {
    p.tokens[i] = 0;
    p.anc[i] = 0;
  }
  for (int m = gid; m < M; m += gn) {
    p.scores[m] = m % K == 0 ? 0.0f : kNeg;
    fin[m] = 0;
    tok[m] = p.go_id;
  }
  for (int i = gid; i < B; i += gn) live[i] = 1;
  for (int i = gid; i < T_; i += gn) flag[i] = 0;
  for (int i = gid; i < M * E; i += gn) {
    const int m = i / E, e = i - m * E;
    const float x = p.cls0 != nullptr ? p.cls0[(size_t)(m / K) * E + e]
                                      : Num<T>::to_f(p.emb[(size_t)p.go_id * E + e]);
    __stcg(p.x + i, x + p.pe[e]);
  }
  grid.sync();

  // the cycles of each phase's tiles and of the grid barrier after it
  Clock mark = start_clock(profiler(p.prof));
  const int nout = (E + p.bn_out - 1) / p.bn_out, nff1 = (F + p.bn_ff1 - 1) / p.bn_ff1;
  const int nff2 = (E + p.bn_ff2 - 1) / p.bn_ff2;
  for (int t = 0; t < T_; ++t) {
    for (int l = 0; l < L; ++l) {
      for (int i = cta; i < Mt * H; i += nct) qkv_tile(p, lay, l, t, i / H, i % H, smem);
      mark.at(0);
      grid.sync();
      mark.at(1);
      for (int i = cta; i < Mt * nout; i += nct)
        residual_tile(p, lay, p.ctx, E, p.w_out + (size_t)l * E * E, p.b_out + (size_t)l * E,
                      i / nout, i % nout, p.bn_out, smem);
      mark.at(2);
      grid.sync();
      mark.at(3);
      for (int i = cta; i < Mt * H; i += nct) cross_tile(p, lay, l, i / H, i % H, smem);
      mark.at(4);
      grid.sync();
      mark.at(5);
      for (int i = cta; i < Mt * nout; i += nct)
        residual_tile(p, lay, p.ctx, E, p.cw_o + (size_t)l * E * E, p.cb_o + (size_t)l * E,
                      i / nout, i % nout, p.bn_out, smem);
      mark.at(6);
      grid.sync();
      mark.at(7);
      for (int i = cta; i < Mt * nff1; i += nct)
        ff1_tile(p, lay, l, i / nff1, i % nff1, p.bn_ff1, smem);
      mark.at(8);
      grid.sync();
      mark.at(9);
      for (int i = cta; i < Mt * nff2; i += nct)
        residual_tile(p, lay, p.hid, F, p.ff2_w + (size_t)l * F * E, p.ff2_b + (size_t)l * E,
                      i / nff2, i % nff2, p.bn_ff2, smem);
      mark.at(10);
      grid.sync();
      mark.at(11);
    }
    for (int i = cta; i < (B + p.rows7 - 1) / p.rows7; i += nct) topk_tile(p, lay, t, i, smem);
    mark.at(12);
    grid.sync();
    mark.at(13);
    if (p.early_stop && ldcg(flag + t) == 0) break;  // the same value in every CTA
  }
}

// An empty loop of n grid barriers, the floor under a step's phases.
__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// A cooperative launch of `ctas` CTAs of kernel with `args`; refused, with
// the error returned, where they cannot all be resident at once.
int launch_cooperative(const void* kernel, int ctas, size_t smem, void** args,
                       cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (ctas < 1 || (long long)per_sm * sms < ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(kThreads), args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int run(const void* const* ptr, const int* dim, float eps, float scale, const float* cls0,
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
  p.cls0 = cls0;
  p.ck = (const T*)ptr[nw + 1];
  p.cv = (const T*)ptr[nw + 2];
  p.kc = (T*)ptr[nw + 3];
  p.vc = (T*)ptr[nw + 4];
  p.tokens = (int*)ptr[nw + 5];
  p.scores = (float*)ptr[nw + 6];
  p.x = (float*)ptr[nw + 7];
  p.pre = (float*)ptr[nw + 8];
  p.ctx = (T*)ptr[nw + 9];
  p.hid = (T*)ptr[nw + 10];
  p.anc = (int*)ptr[nw + 11];
  p.state = (int*)ptr[nw + 12];
  p.logits = (float*)ptr[nw + 13];
  p.prof = (long long*)ptr[nw + 14];
  p.B = dim[0]; p.steps = dim[1]; p.L = dim[2]; p.E = dim[3]; p.F = dim[4];
  p.C = dim[5]; p.H = dim[6]; p.Tm = dim[7]; p.go_id = dim[8];
  p.eos_id = dim[9]; p.K = dim[10]; p.early_stop = dim[11];
  p.bn_out = dim[12]; p.bn_ff1 = dim[13]; p.bn_ff2 = dim[14]; p.rows7 = dim[15];
  const int ctas = dim[16], smem = dim[17];
  p.eps = eps;
  p.scale = scale;
  if (p.B == 0 || p.steps == 0) return 0;
  // the caller's plan (ops/fused_beam.beam_plan) must be one this kernel runs
  const int bns[] = {p.bn_out, p.bn_ff1, p.bn_ff2};
  for (int bn : bns)
    if (bn < 8 || bn > kMaxBN || bn % 8) return (int)cudaErrorInvalidValue;
  if (p.H < 1 || p.E % p.H || p.K < 1 || p.rows7 < 1 || p.rows7 * p.K > kRows7)
    return (int)cudaErrorInvalidValue;
  const Layout<T> lay(p);
  if (lay.P < 1 || lay.bytes() > kSmemLimit || (int)lay.bytes() != smem ||
      4 * (size_t)p.rows7 * p.K * p.E > lay.ring_w)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return launch_cooperative((const void*)beam_grid_kernel<T>, ctas, smem, args, stream);
}

}  // namespace

// ptr: the 23 weight tables in Params order, then pe, ck, cv, kc, vc,
// tokens, scores, the scratch x, pre (float32 [B*K, E]), ctx (T [B*K, E]),
// hid (T [B*K, F]), anc (int32 [B, K, T]), state (int32 [2*B*K + B +
// T]) and logits (float32 [B*K, C]), and the int64 [27] profile (null:
// none; see Clock).  dim: B, T, L, E, F, C, H, Tm, go_id, eos_id, K,
// early_stop, and the plan's columns
// of an out/cross-out, ff1 and ff2 tile, batch rows of a top-K tile, CTAs
// and shared-memory bytes (checked).  dtype: 0 = float32, 1 = bfloat16.
// cls0: the [B, E] float32 step-0 rows, or null for the [GO] embedding.
// Every pointer lies on the device of `stream`, which the caller makes
// the current device for the call.
extern "C" int fused_beam_grid(int dtype, const void* const* ptr, const int* dim, float eps,
                               float scale, const void* cls0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c0 = (const float*)cls0;
  if (dtype == 0) return run<float>(ptr, dim, eps, scale, c0, s);
  if (dtype == 1) return run<__nv_bfloat16>(ptr, dim, eps, scale, c0, s);
  return (int)cudaErrorInvalidValue;
}

// n grid barriers of `ctas` CTAs, nothing else: the floor of the beam
// kernel's phases.
extern "C" int fused_beam_barriers(int ctas, int n, void* stream) {
  void* args[] = {&n};
  return launch_cooperative((const void*)barrier_kernel, ctas, 0, args, (cudaStream_t)stream);
}
