// Whole greedy decode loop of the transformer decoder in one kernel, one
// thread-block cluster per tile of batch rows (K1 in float mode, K1q in
// int8 mode).
//
// Replaces the TPU kernel multimodal_scene_text_recognition_tpu/ops/
// fused_decode.py::_decode_kernel in float mode and with quantized=True,
// with its eos_id early stop (K1e) and its cls0 step-0 row (K1-cls0); in
// int8 mode, batches of at most 96 rows and rows wider than this kernel's
// exchange holds take fused_decode.cu (ops/fused_decode.k1q_route).  For T
// steps it embeds the previous token, runs L
// decoder layers (packed qkv -> self-attention KV-cache write -> causal
// attention -> out-proj -> LN -> cross-q -> attention over the precomputed
// memory K/V -> out-proj -> LN -> ReLU FF -> LN), the final LN and the class
// head, writes logits[b, t, :] and feeds the first-index argmax back.
//
// Bound: operations.  At the flagship (B=192, T=25, L=6, E=256, F=2048,
// C=97) the projections are 2*B*T*(L*1.44M + E*C) ~ 84 GFLOP against ~49 MB
// of inputs and outputs.  What holds a decode loop back on this card is
// moving the 17.3 MB of bf16 weights of a step to the SMs: the TPU kernel
// keeps them in VMEM and runs each projection as one [B, E] x [E, N]
// product; 227 KB of shared memory cannot hold them, so they stream from
// L2, and the design's job is to read each weight byte as few times as it
// can and to keep the stream running while the loop waits on itself.  With
// that done (5.35 GB of L2 reads a call at B=192, from ~83 GB), what
// remains on an H100 is the latency of each layer's chain of dependent
// phases: six projections (serial chains of 16-deep products), two
// attention phases (L2 round trips for K and V) and three exchanges
// (PERF.md).
//
// Design.  A cluster of G CTAs owns a tile of R = 16 batch rows (the M side
// of one tensor-core tile; tiles of 32 rows were slower at B=192 on an
// H100, PERF.md) and loops over t and l itself; clusters never wait on
// each other (no grid barrier, no cooperative launch), so any B runs in
// waves.  G is the largest divisor of H that is at most 8 (the portable
// cluster size) and divides Ep / 4 (the exchange's 16-byte columns); CTA h
// owns the Hc = H / G heads h * Hc.. and the FF columns h * Fg.. (Fg =
// ceil(F / G)).  Each owned head's q, k and v columns and the CTA's FF
// columns are zero-padded to a multiple of 16 (the mma.sync k-step of the
// products that read them): zero q and k columns add nothing to a score,
// the scale stays 1/sqrt(true head width), and zero value, ff1 columns and
// biases meet zero rows of the out-projection and ff2.  The rows, E wide,
// are padded likewise to Ep, a multiple of 16: the tables' padding rows
// and columns are zero, so the padding columns of the residual stream stay
// 0, and the layernorm takes its statistics over the true E.
// Every weight is split across the cluster where its input already lies,
// so each CTA reads 1/G of every projection, once per row tile and step
// (not once per row):
//
//   qkv, cross-q, ff1   N-split: CTA h computes its heads' q, k and v
//                       columns (writes their k and v to the cache and runs
//                       their attention itself), their cross queries, and
//                       its Fg columns of the FF hidden (which never leave it);
//   out-proj, cross-out, ff2   K-split over the same head or FF columns:
//                       each CTA leaves a partial [R, E] float32 sum.
//
// The three K-split partials of a layer meet through distributed shared
// memory, by stores only: each CTA stores its partial of each column into
// the shared memory of the column's owner; once they have all arrived
// (counted on an mbarrier, no cluster barrier) the owner sums the G
// partials in rank order, adds the bias and the residual and stores the
// result into every CTA; once a CTA has every column (a second mbarrier)
// it runs the layernorm on the full rows itself.  One reduction order and one
// code path, no atomics: the G copies of the residual stream are
// bit-identical, and so are the class head, the argmax, the early-stop
// decision and the done flags, which every CTA computes for itself (only
// rank 0 writes the logits).
//
// Weights.  `pack_cluster_tables` (ops/fused_decode.py) repacks the tables
// once into units of 512 bytes: a 16-deep k-step of 16 (bf16) or 8 (f32)
// output columns, laid out so that lane l's 16 bytes are its mma.sync B
// fragments (bf16) or the same four k-values of one column (f32), and
// orders them per (layer, CTA, warp) exactly as that warp consumes them
// (see project), so a warp's weights for a layer are one contiguous run.  Each lane streams
// its 16 bytes of every unit with cp.async (L2 only) into a private ring of
// D slots in shared memory and reads back only what it copied itself, so
// the ring needs no barrier.  The weights do not depend on the activations,
// so the ring runs D units ahead through barriers, attention and layer and
// step boundaries (it wraps to the next step's units, which are the same).
//
// Products.  bf16: mma.sync m16n8k16 bf16 -> f32, R rows as M (padded rows
// past B compute on clamped inputs and are never written), each 16-deep
// product from zero and added to the output's float32 sum in k order.
// float32: CUDA-core FMAs over the same units (no TF32), each lane summing
// its four k-values of a column for all R rows, the lane quad then summed
// by two shuffles.  A warp sums every output of its column tiles over the
// slice's whole K, never splitting it: at the flagship that leaves two of
// eight warps idle in qkv and six in cross-q, and it keeps the sums in the
// plain version's k order (split-K sums put K1 bf16 0.256 off its plain
// version with a random cls0 against 0.112 unsplit, on an H100).
// Attention stays on CUDA cores: the TPU kernel rounds each q*K product and
// each probs*V product to T before it sums them, which a tensor-core
// product cannot do.
//
// Numerics mirror the TPU kernel's casts for compute type T (float or bf16):
// matmul inputs rounded to T, accumulated in float32; q*K products rounded
// to T before the per-head sum; probabilities rounded to T and probs*V
// formed in T and summed in float32; layernorm, softmax and logits float32;
// the argmax takes the first index of the maximum.  cls0 (a non-null [B, E]
// float32 pointer): step 0's input row is cls0[b] + pe[0], unrounded, in
// place of emb[go_id] + pe[0].  Early stop (eos_id >= 0): a row that has
// emitted eos_id writes no further logits (the caller prefilled them with
// the eos_id one-hot), and a cluster leaves its loop once every row of its
// tile has stopped.
//
// Int8 mode (K1q, template flag Q).  The six projections run as the TPU
// kernel's quantized `lin`: each quantizes its float32 input row as it
// stands (not rounded to T: the residual stream, the attention contexts
// and the ReLU output of ff1 stay unrounded) with the row's abs-max (scale
// abs-max / 127, the IEEE quotient 127 / max(abs-max, 1e-12), rintf, half
// to even, clipped to +-127), multiplies it by its int8 table on mma.sync
// m16n8k32 s8 -> s32, exact, and dequantizes as acc * ((abs-max / 127) *
// channel scale) + bias in that order, without contraction.  The units
// (pack_cluster_tables_int8) are a 32-deep k-step of 16 output columns, so
// the rows, head and FF slices are padded to multiples of 32; the class
// head's units stay in T, as in float mode.  Where a row is whole in every
// CTA (qkv, cross-q and ff1 read the normalised rows) its abs-max is
// local: the layernorm that writes the row quantizes it.  The K-split
// inputs (the attention context, the ReLU hidden) are split across the
// cluster, so before each of those three projections every CTA sends the
// maxima of its slice of the R rows to every CTA (counted stores on a third
// mbarrier) and quantizes its slice once all G have arrived; max is exact
// and order-free, so the G copies agree bit for bit.  The K-split partials
// travel as int32, the owner sums them exactly and converts the total once
// before it dequantizes, as the TPU kernel converts the whole int32 product.
// Embedding, attention, layernorms and the class head are float mode's,
// but for the order of the attention's sums over positions (the softmax's
// denominator and the context), which int8 mode takes as the plain
// version's PyTorch reduction does on the card (context_in_order): its int8
// steps turn any other order's last-bit differences into visible ones.

#include <cooperative_groups.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 512;  // bytes of one weight unit: 16 a lane
constexpr int kMaxCluster = 8;
constexpr int kMaxE = 512;  // row width the exchange holds in registers
constexpr int kProj = 7;     // qkv, out, cross-q, cross-out, ff1, ff2, head
constexpr int kChunk = 8;    // positions a thread sums of an attention context

constexpr int kRows = 16;   // batch rows a cluster owns (R)
// ring slots per lane: 64 KB of weights in flight per CTA; a 128 KB ring was
// slower on an H100 (PERF.md)
constexpr int kDepth = 16;

template <typename T>
struct Params {
  // per-layer tables stacked on a leading L axis, matrices [in, out]; the
  // six projection matrices and the head are read from `packed`
  const T *w_qkv, *b_qkv, *w_out, *b_out, *cw_q, *cb_q, *cw_o, *cb_o;
  const T *ff1_w, *ff1_b, *ff2_w, *ff2_b;
  const T *n1_s, *n1_b, *n2_s, *n2_b, *n3_s, *n3_b;
  const T *fn_s, *fn_b, *head_w, *head_b, *emb;
  const float* pe;    // [T, E]
  const float* cls0;  // [B, E] step-0 rows, or null: emb[go_id]
  const T *ck, *cv;   // cross K/V [L, B, Tm, E]
  T *kc, *vc;         // self-attention caches [L, B, T, E]
  float* logits;      // [B, T, C]
  const char* packed;  // weight units (pack_cluster_tables, pack_cluster_tables_int8)
  long long* prof;     // [15] cycles by phase ([18] in int8 mode), or null (see Marks)
  // int8 mode: the per-channel scales [L, N] of the six projections (qkv,
  // out, cross-q, cross-out, ff1, ff2)
  const float* qs[6];
  int B, steps, L, E, F, C, H, Tm, go_id;
  int eos_id;          // < 0: no early stop
  int G;               // CTAs a cluster (cluster_size)
  float eps, scale;    // layernorm epsilon, 1/sqrt(head_dim)
};

// n rounded up to a multiple of k
__device__ __host__ int padk(int n, int k) { return (n + k - 1) / k * k; }

// CTAs a cluster: the largest divisor of H that is at most kMaxCluster and
// divides Ep / 4 (Ep: the rows' width padded to a multiple of the k-step)
__host__ int cluster_size(int Ep, int H) {
  for (int g = kMaxCluster; g >= 1; --g)
    if (H % g == 0 && Ep % (4 * g) == 0) return g;
  return 0;
}

// The shapes every CTA derives from Params in the same way as the packer:
// the [K, N] slice a CTA owns of each projection (its heads' columns and
// its FF columns padded to multiples of the k-step, 16, or 32 in int8
// mode; the head's N padded to Cp), cut into items of a unit's output
// columns; item i belongs to warp i % kWarps, which reads its K / k-step
// units in k order.  The class head's units are T's in either mode.
template <typename T, bool Q>
struct Geometry {
  static constexpr int kCols = sizeof(T) == 2 ? 16 : 8;  // output columns of a unit in T
  static constexpr int kColsP = Q ? 16 : kCols;  // ... of a unit of the six projections
  static constexpr int kStep = Q ? 32 : 16;      // their k-step, and the widths' padding
  int Ep, Hc, hd, hdp, W, Fg, Fgp, Cp, lda, ldb, lda8, ldb8, ldf, S;
  int K[kProj], N[kProj];
  int layer_units;  // units of a CTA's layer (all its warps)

  __device__ __host__ Geometry(const Params<T>& p) {
    Ep = padk(p.E, kStep);      // the rows' width, padded
    Hc = p.H / p.G;             // heads a CTA
    hd = p.E / p.H;             // a head's true width
    hdp = padk(hd, kStep);      // ... padded
    W = Hc * hdp;               // a CTA's padded head columns of q (or k, or v)
    Fg = (p.F + p.G - 1) / p.G;  // FF columns a CTA (the last may own fewer)
    Fgp = padk(Fg, kStep);
    Cp = (p.C + kWarps * kCols - 1) / (kWarps * kCols) * (kWarps * kCols);
    lda = Ep + 8;
    ldb = (W > Fgp ? W : Fgp) + 8;
    lda8 = Ep + 16;  // bytes: the 8 row groups of a fragment load in distinct banks
    ldf = W > Fgp ? W : Fgp;
    ldb8 = ldf + 16;
    S = p.steps > p.Tm ? p.steps : p.Tm;
    const int k[kProj] = {Ep, W, Ep, W, Ep, Fgp, Ep};
    const int n[kProj] = {3 * W, Ep, W, Ep, Fgp, Ep, Cp};
    layer_units = 0;
    for (int i = 0; i < kProj; ++i) {
      K[i] = k[i];
      N[i] = n[i];
      if (i < kProj - 1) layer_units += N[i] / kColsP * (K[i] / kStep);
    }
  }

  // units warp w reads of projections [p0, p1)
  __device__ __host__ int units(int w, int p0, int p1) const {
    int u = 0;
    for (int i = p0; i < p1; ++i) {
      const bool head = i == kProj - 1;
      const int items = N[i] / (head ? kCols : kColsP);
      u += (items / kWarps + (w < items % kWarps)) * (K[i] / (head ? 16 : kStep));
    }
    return u;
  }

  // bytes of the A operand of the E-wide inputs: in T (float mode, and the
  // class head's in int8 mode) and int8, in one region
  __device__ __host__ size_t a_bytes(int R) const {
    const size_t t = sizeof(T) * (size_t)R * lda;
    return Q && (size_t)R * lda8 > t ? (size_t)R * lda8 : t;
  }

  // bytes of the K-split inputs: their A operand in T, or in int8 mode in
  // int8 [R][ldb8] after the float32 rows [R][ldf] it is quantized from
  __device__ __host__ size_t b_bytes(int R) const {
    return Q ? (size_t)R * ldb8 + 4 * (size_t)R * ldf : sizeof(T) * (size_t)R * ldb;
  }

  // float32 elements of the scratch that holds the attention's chunk sums
  // and the head's logits [R][Cp]
  __device__ __host__ int red_floats(int R) const {
    const int chunks = (S + kChunk - 1) / kChunk * R * hd;
    return R * Cp > chunks ? R * Cp : chunks;
  }

  // bytes of shared memory: the weight ring, then the float32 residual
  // rows, the two A operands, the N-split outputs, the exchange's
  // receive and gather buffers, the scratch, the attention scores and the
  // token flags; in int8 mode then the abs-max exchange's buffer
  // [kMaxCluster][R] and the rows' scales (abs-max / 127) of the N-split
  // and the K-split inputs
  __device__ __host__ size_t smem_bytes(int R, int D) const {
    return (size_t)kWarps * D * kUnit + 4 * (size_t)R * Ep + a_bytes(R) + b_bytes(R) +
           4 * (size_t)R * 3 * W + 8 * (size_t)R * Ep + 4 * (size_t)red_floats(R) +
           4 * (size_t)R * S + 8 * (size_t)R + (Q ? 4 * (size_t)R * (kMaxCluster + 2) : 0);
  }
};

// One lane's stream of weight units through its ring of D slots.  A CTA's
// layer is layer_units units, its warps' runs one after another (warp w's
// from units(w' < w)); layer l of CTA h starts at unit (l * G + h) *
// layer_units, and the head, which every CTA reads, after the L layers
// (its warps' runs likewise).  A warp reads U units a layer (U may be 0)
// and UH of the head (at least one); the stream repeats every step.
template <int D>
struct Stream {
  const char* src;    // the next unit to issue (this lane's 16 bytes)
  const char* first;  // this lane's bytes of its warp's first layer unit
  const char* head;   // ... and of its first head unit
  char* ring;         // this lane's 16 bytes of slot 0 (slot i at + i * kUnit)
  size_t layer;       // bytes from one layer of a CTA to the next
  int slot, l, u, L, U, UH;

  // past the end of a run (and over empty ones) to the next unit to read;
  // ends, since every warp reads at least one head unit
  __device__ void settle() {
    while (u == (l < L ? U : UH)) {
      u = 0;
      if (l < L) {
        ++l;
        src = l < L ? first + l * layer : head;
      } else {
        l = 0;
        src = first;
      }
    }
  }

  __device__ void issue(int s) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(ring + s * kUnit);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    src += kUnit;
    ++u;
    settle();
  }

  // this lane's 16 bytes of the oldest unit in flight
  __device__ uint4 peek() const {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 1) : "memory");
    return *reinterpret_cast<const uint4*>(ring + slot * kUnit);
  }

  // refill the slot just read with the unit D ahead
  __device__ void next() {
    issue(slot);
    slot = (slot + 1) & (D - 1);
  }
};

// Shared-memory addresses and the mbarrier operations of the exchange.
__device__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// the address of the same shared-memory location in CTA `rank` of the
// cluster
__device__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// stores v at `addr` (shared::cluster) and counts its bytes on the
// mbarrier `bar` of the same CTA
__device__ void store_counted(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ void store_counted(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}

// the phase of `bar` now running expects `bytes` more (one arrival, by one
// thread of the CTA)
__device__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The accumulator of one item: R rows by one unit's columns (kCols), its
// A operand of type In, kK deep a unit.
template <typename T, int R>
struct Frag;

// bf16: mma.sync m16n8k16, R / 16 row tiles by two 8-column tiles
template <int R>
struct Frag<__nv_bfloat16, R> {
  using In = __nv_bfloat16;
  static constexpr int kMT = R / 16, kK = 16, kCols = 16;
  float c[kMT][2][4];

  __device__ void zero() {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[m][n][i] = 0.0f;
  }

  // the lane's A fragments of A[:, k0:k0+16]
  struct AFrag {
    uint32_t v[kMT][4];
  };
  __device__ static AFrag load_a(const __nv_bfloat16* A, int lda, int k0, int lane) {
    const int g = lane >> 2, q = lane & 3;
    AFrag f;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const __nv_bfloat16* a = A + (m * 16 + g) * lda + k0 + 2 * q;
      f.v[m][0] = word(a);
      f.v[m][1] = word(a + 8 * lda);
      f.v[m][2] = word(a + 8);
      f.v[m][3] = word(a + 8 * lda + 8);
    }
    return f;
  }

  // += the A fragments times the unit w (lane's B fragments of both tiles)
  __device__ void mac(const AFrag& af, uint4 w) {
    const uint32_t b0[2] = {w.x, w.y}, b1[2] = {w.z, w.w};
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      // each 16-deep product from zero, added to the sum in float32 here:
      // the tensor cores' own accumulation does not round to nearest
      float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma(d0, af.v[m], b0);
      mma(d1, af.v[m], b1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[m][0][i] += d0[i];
        c[m][1][i] += d1[i];
      }
    }
  }

  __device__ void finish() {}

  // f(r, j, v) for each value this lane holds: row r, column j of the unit
  template <typename Fn>
  __device__ void each(int lane, Fn f) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f(m * 16 + g + (i >> 1) * 8, n * 8 + 2 * q + (i & 1), c[m][n][i]);
  }
};

// float32: CUDA-core FMAs; lane (g, q) sums k-values {2q, 2q+1, 2q+8, 2q+9}
// of each 16-deep step of column g for all R rows
template <int R>
struct Frag<float, R> {
  using In = float;
  static constexpr int kK = 16, kCols = 8;
  float c[R];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = 0.0f;
  }

  // the lane's k-values of A[:, k0:k0+16] for every row
  struct AFrag {
    float2 x0[R], x1[R];
  };
  __device__ static AFrag load_a(const float* A, int lda, int k0, int lane) {
    const int q = lane & 3;
    AFrag f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* a = A + r * lda + k0 + 2 * q;
      f.x0[r] = *reinterpret_cast<const float2*>(a);
      f.x1[r] = *reinterpret_cast<const float2*>(a + 8);
    }
    return f;
  }

  __device__ void mac(const AFrag& a, uint4 w) {
    const float w0 = __uint_as_float(w.x), w1 = __uint_as_float(w.y);
    const float w2 = __uint_as_float(w.z), w3 = __uint_as_float(w.w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[r] = fmaf(a.x0[r].x, w0, c[r]);
      c[r] = fmaf(a.x0[r].y, w1, c[r]);
      c[r] = fmaf(a.x1[r].x, w2, c[r]);
      c[r] = fmaf(a.x1[r].y, w3, c[r]);
    }
  }

  // the lane quad's four partial sums, the same in all four lanes
  __device__ void finish() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[r] += __shfl_xor_sync(0xffffffffu, c[r], 1);
      c[r] += __shfl_xor_sync(0xffffffffu, c[r], 2);
    }
  }

  template <typename Fn>
  __device__ void each(int lane, Fn f) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((r & 3) == q) f(r, g, c[r]);
  }
};

// int8 (K1q's six projections): mma.sync m16n8k32 s8 -> s32, R / 16 row
// tiles by two 8-column tiles; the A fragments are bf16's with four k-values
// a word (mma.cuh), the unit's lane (g, q) holds k 4q..4q+3 and 16+4q..
// 16+4q+3 of columns g and 8 + g.  Integer sums are exact, so the tensor
// cores accumulate in place.
template <int R>
struct FragQ {
  using In = int8_t;
  static constexpr int kMT = R / 16, kK = 32, kCols = 16;
  int c[kMT][2][4];

  __device__ void zero() {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[m][n][i] = 0;
  }

  struct AFrag {
    uint32_t v[kMT][4];
  };
  __device__ static AFrag load_a(const int8_t* A, int lda, int k0, int lane) {
    const int g = lane >> 2, q = lane & 3;
    AFrag f;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int8_t* a = A + (m * 16 + g) * lda + k0 + 4 * q;
      f.v[m][0] = word(a);
      f.v[m][1] = word(a + 8 * lda);
      f.v[m][2] = word(a + 16);
      f.v[m][3] = word(a + 8 * lda + 16);
    }
    return f;
  }

  __device__ void mac(const AFrag& af, uint4 w) {
    const uint32_t b0[2] = {w.x, w.y}, b1[2] = {w.z, w.w};
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      mma(c[m][0], af.v[m], b0);
      mma(c[m][1], af.v[m], b1);
    }
  }

  __device__ void finish() {}

  template <typename Fn>
  __device__ void each(int lane, Fn f) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f(m * 16 + g + (i >> 1) * 8, n * 8 + 2 * q + (i & 1), c[m][n][i]);
  }
};

// -- int8 mode's quantization (the TPU kernel's quantized `lin`) --

// The float32 value K1q quantizes: as it stands (not rounded to T).
template <typename T>
__device__ float quant_input(float v) {
  return v;
}

// 127 / max(abs-max, 1e-12), the IEEE quotient
__device__ float inv_scale(float ax) { return __fdiv_rn(127.0f, fmaxf(ax, 1e-12f)); }

// clamp(rint(v * inv), -127, 127), half to even
template <typename T>
__device__ int8_t quant8(float v, float inv) {
  const float q = rintf(__fmul_rn(quant_input<T>(v), inv));
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

// acc * (xscale * s) + b in float32, in that order and without contraction
// (xscale: the row's abs-max / 127)
template <typename T>
__device__ float dequant(int acc, float xscale, float s, const T* b, int j) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(xscale, s)), Num<T>::load(b + j));
}

// max |row[k]| over k < K, by the calling warp (every lane gets it)
template <typename T>
__device__ float row_absmax(const float* row, int K) {
  float m = 0.0f;
  for (int k = threadIdx.x & 31; k < K; k += 32) m = fmaxf(m, fabsf(quant_input<T>(row[k])));
  return warp_max(m);
}

// dst[k] = quant8(row[k]) for k < K (a multiple of 4) with the row's
// abs-max ax, by the calling warp, four values a lane; returns ax / 127
template <typename T>
__device__ float quantize_row(const float* row, int K, float ax, int8_t* dst) {
  const float inv = inv_scale(ax);
  for (int k = 4 * (threadIdx.x & 31); k < K; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    *reinterpret_cast<char4*>(dst + k) =
        make_char4(quant8<T>(v.x, inv), quant8<T>(v.y, inv), quant8<T>(v.z, inv),
                   quant8<T>(v.w, inv));
  }
  return __fdiv_rn(ax, 127.0f);
}

// How a projection leaves its output.
enum Store {
  kBias = 0,       // float32 out[r][n] = acc + bias
  kReluRoundT = 1, // T out[r][n] = round_T(relu(acc + bias)): the FF hidden
  kPartial = 2,    // a K-split partial sum, to the owner of column n (see exchange_ln)
  // int8 mode (int32 acc, dequantized with the row's scale and the column's)
  kQBias = 3,      // float32 out[r][n] = dequant(acc)
  kQRelu = 4,      // float32 out[r][n] = relu(dequant(acc)): the FF hidden, unrounded
  kQPartial = 5,   // an int32 K-split partial sum, to the owner of column n
};

// The output columns of a CTA's slice are segments of segp columns, of
// which the first segw are real and the rest padding.  Column d < segw of
// segment s finds its bias at (s / per) * part_stride + (s % per) *
// seg_stride + off + d of the layer's bias row (qkv: per = Hc heads a part,
// the q, k and v parts E apart); padding is not stored, except that the FF
// hidden's is stored as 0 (the next product reads it).  A K-split partial
// (kPartial) goes to CTA s (segp = E / G columns each), row off + r of its
// receive buffer [G * R][segp], its bytes counted on that CTA's receive
// mbarrier `bar`.  In int8 mode the column's scale is at s[the bias's
// index] and row r's (abs-max / 127) at xscale[r].
struct Cols {
  int segp, segw, per, part_stride, seg_stride, off;
  uint32_t bar;  // kPartial: the owners' receive mbarrier (its address in every CTA)
  const float* s;       // int8 mode: the per-channel scales of the layer
  const float* xscale;  // int8 mode: the input rows' scales [R]
};

template <typename T, int MODE, typename V>
__device__ void store(void* out, int ldo, int r, int n, V v, const T* bias, Cols cols) {
  const int s = n / cols.segp, d = n - s * cols.segp;
  if (d >= cols.segw) {
    if (MODE == kReluRoundT) static_cast<T*>(out)[r * ldo + n] = Num<T>::from_f(0.0f);
    if (MODE == kQRelu) static_cast<float*>(out)[r * ldo + n] = 0.0f;
    return;
  }
  const int bi = s / cols.per * cols.part_stride + s % cols.per * cols.seg_stride + cols.off + d;
  if constexpr (MODE == kBias) {
    static_cast<float*>(out)[r * ldo + n] = epilogue<T, kPlain>(v, bias, bi);
  } else if constexpr (MODE == kReluRoundT) {
    static_cast<T*>(out)[r * ldo + n] = Num<T>::from_f(epilogue<T, kReluRound>(v, bias, bi));
  } else if constexpr (MODE == kQBias || MODE == kQRelu) {
    const float y = dequant<T>(v, cols.xscale[r], __ldg(cols.s + bi), bias, bi);
    static_cast<float*>(out)[r * ldo + n] = MODE == kQRelu ? fmaxf(y, 0.0f) : y;
  } else {  // into the receive buffer of the column's owner, at this CTA's slot
    const float* dst = static_cast<const float*>(out) + (cols.off + r) * cols.segp + d;
    float bits;  // an int32 partial travels as its bits
    if constexpr (MODE == kQPartial) bits = __int_as_float(v); else bits = v;
    store_counted(remote(smem_u32(dst), s), bits, remote(cols.bar, s));
  }
}

// One projection of the R rows A [R][lda] (the input already rounded to
// T, or quantized to int8) by the CTA's slice [K][N] of a weight, read from
// the stream: output column tiles of F::kCols (items); item i belongs to
// warp i % kWarps, which sums its K in one chain of F::kK-deep steps, in k
// order, as the plain version's product does.  A warp takes its items two
// at a time (i and i + kWarps), their units interleaved by k-step, so that
// two independent chains share each A fragment and overlap their
// latencies.  Not inlined: one body serves the seven call sites of a step.
template <typename T, typename F, int D, int MODE>
__device__ __noinline__ void project(Stream<D>* stream, const typename F::In* A, int lda, int K,
                                     int N, const T* bias, Cols cols, void* out, int ldo) {
  constexpr int kCols = F::kCols;
  Stream<D> st = *stream;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KS = K / F::kK, items = N / kCols;
  for (int c0 = warp; c0 < items; c0 += 2 * kWarps) {
    const int c1 = c0 + kWarps;
    const bool pair = c1 < items;
    F f0, f1;
    f0.zero();
    f1.zero();
    for (int k = 0; k < KS; ++k) {
      const typename F::AFrag a = F::load_a(A, lda, k * F::kK, lane);
      f0.mac(a, st.peek());
      st.next();
      if (pair) {
        f1.mac(a, st.peek());
        st.next();
      }
    }
    f0.finish();
    f0.each(lane, [&](int r, int j, auto v) {
      store<T, MODE>(out, ldo, r, c0 * kCols + j, v, bias, cols);
    });
    if (pair) {
      f1.finish();
      f1.each(lane, [&](int r, int j, auto v) {
        store<T, MODE>(out, ldo, r, c1 * kCols + j, v, bias, cols);
      });
    }
  }
  *stream = st;
}

// 16 bytes of T at p, as loaded (written earlier in this launch: a plain
// load, not the read-only path); value i of them widened to float by
// widen, so that many loads can be in flight in few registers
__device__ uint4 load16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

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

// *p = v in the type of p: rounded to bf16, or float32 as it stands
__device__ void put(float* p, float v) { *p = v; }
__device__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Attention of head h for the R rows over `len` positions, each warp for
// its RW = R / kWarps rows at once: q[r * ldq + d] (float32, rounded to T
// here), K/V at kv + row * row_stride + s * ps (the head's columns; row =
// r0 + r, clamped to the batch).  Writes the context to ctx[r * ldc + d]
// (O: rounded to T, or float32 as summed for int8 mode), and zeros to its
// padding columns hd <= d < hdp.  A lane
// scores a position of each of the warp's rows (their keys' head slices in
// 16-byte loads, all in flight at once), the softmax is a warp reduction,
// and the context is summed over chunks of kChunk positions, a lane a (row,
// chunk, 16 bytes of columns) with all its loads in flight, the chunks'
// sums then added in chunk order (`part`, R * ceil(S / kChunk) * hd
// floats).  So a phase waits on L2 about twice; only its end synchronises
// the block.  A head width that is not a whole number of 16-byte groups
// takes the same steps a value at a time.
// The sum over positions s < len of round_T(pr[s] * V[s][c]) for the
// context columns of a warp's RW rows, in the order the plain version's
// PyTorch reduction over positions takes on the card: four interleaved
// sums, position s added to sum s % 4 in order, then ((a0 + a1) + a2) + a3.
// That is ATen/native/cuda/Reduce.cuh (torch 2.11-2.13): a sum over a
// non-innermost axis splits the outputs across lanes (setReduceConfig),
// and with fewer than 64 values an output (positions here: at most 26) it
// does not split them across warps or CTAs, so one thread sums an output
// in thread_reduce_impl with vt0 = 4 accumulators, gpu_reduce_kernel's
// default.  Another torch, or more positions, may sum in another order.
// Int8 mode sums so, because its int8 steps turn any other order's last-bit
// differences into visible ones (PERF.md §6).  A lane takes one of the
// four sums of a (row, 16 bytes of columns; one column where a head is not
// a whole number of 16-byte groups), its loads kChunk at a time, and the
// four lanes of an output meet by shuffles.  Writes ctx[r * ldc + d] for d
// < hd and zeros to the padding columns hd <= d < hdp.
template <typename T, int R, typename O>
__device__ void context_in_order(const float* probs, int S, const T* const* vr, int ps, int hd,
                                 int hdp, int len, O* ctx, int ldc) {
  constexpr int VW = Vec<T>::kW, RW = R / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = hd % VW == 0;
  const int cw = vec ? VW : 1, groups = hd / cw, items = RW * groups * 4;
  for (int base = 0; base < items; base += 32) {  // every lane takes part in the shuffles
    const int i = base + lane, k = i & 3, o = i >> 2;
    const bool active = i < items;  // the four lanes of an output alike
    const int w = active ? o / groups : 0, d = (o - w * groups) * cw;
    const float* pr = probs + (warp + w * kWarps) * S;
    float acc[VW];
#pragma unroll
    for (int i2 = 0; i2 < VW; ++i2) acc[i2] = 0.0f;
    for (int s0 = k; active && s0 < len; s0 += 4 * kChunk) {
      if (vec) {
        uint4 vv[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (s0 + 4 * j < len) vv[j] = load16(vr[w] + (size_t)(s0 + 4 * j) * ps + d);
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (s0 + 4 * j < len)
#pragma unroll
            for (int i2 = 0; i2 < VW; ++i2)
              acc[i2] += Num<T>::round(pr[s0 + 4 * j] * widen<T>(vv[j], i2));
      } else {
        for (int j = 0; j < kChunk && s0 + 4 * j < len; ++j)
          acc[0] += Num<T>::round(pr[s0 + 4 * j] *
                                  Num<T>::to_f(vr[w][(size_t)(s0 + 4 * j) * ps + d]));
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < VW; ++i2) {
      const float a1 = __shfl_down_sync(0xffffffffu, acc[i2], 1);
      const float a2 = __shfl_down_sync(0xffffffffu, acc[i2], 2);
      const float a3 = __shfl_down_sync(0xffffffffu, acc[i2], 3);
      if (active && k == 0 && i2 < cw)
        put(ctx + (warp + w * kWarps) * ldc + d + i2, ((acc[i2] + a1) + a2) + a3);
    }
  }
  for (int i = lane; i < RW * (hdp - hd); i += 32) {
    const int w = i / (hdp - hd);
    put(ctx + (warp + w * kWarps) * ldc + hd + i - w * (hdp - hd), 0.0f);
  }
}

template <typename T, int R, bool Q, typename O>
__device__ void attend_head(const float* q, int ldq, const T* K, const T* V, size_t row_stride,
                            int ps, int hd, int hdp, int len, int r0, int nrows, float scale,
                            float* probs, int S, O* ctx, int ldc, float* part) {
  constexpr int VW = Vec<T>::kW, RW = R / kWarps;
  constexpr int kLoads = 4;  // 16-byte loads of a key in flight a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = hd % VW == 0;
  const int groups = vec ? hd / VW : hd, chunks = (len + kChunk - 1) / kChunk;
  const int max_chunks = (S + kChunk - 1) / kChunk;
  const T* kr[RW];  // the rows' first keys and values
  const T* vr[RW];
  float m[RW];
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const size_t at = (size_t)(r0 + min(warp + w * kWarps, nrows - 1)) * row_stride;
    kr[w] = K + at;
    vr[w] = V + at;
    m[w] = -__int_as_float(0x7f800000);
  }
  for (int s = lane; s < len; s += 32) {
    float acc[RW];
#pragma unroll
    for (int w = 0; w < RW; ++w) acc[w] = 0.0f;
    for (int d = 0; !vec && d < hd; ++d)
#pragma unroll
      for (int w = 0; w < RW; ++w)
        acc[w] += Num<T>::round(Num<T>::round(q[(warp + w * kWarps) * ldq + d]) *
                                Num<T>::to_f(kr[w][(size_t)s * ps + d]));
    for (int d = 0; vec && d < hd; d += kLoads * VW) {
      uint4 kv[RW][kLoads];
#pragma unroll
      for (int w = 0; w < RW; ++w)
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (d + u * VW < hd) kv[w][u] = load16(kr[w] + (size_t)s * ps + d + u * VW);
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        const float* qr = q + (warp + w * kWarps) * ldq;
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (d + u * VW < hd)
#pragma unroll
            for (int i2 = 0; i2 < VW; ++i2)
              acc[w] += Num<T>::round(Num<T>::round(qr[d + u * VW + i2]) * widen<T>(kv[w][u], i2));
      }
    }
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      acc[w] *= scale;
      probs[(warp + w * kWarps) * S + s] = acc[w];
      m[w] = fmaxf(m[w], acc[w]);
    }
  }
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    float* pr = probs + (warp + w * kWarps) * S;
    const float mx = warp_max(m[w]);
    float sum = 0.0f;
    for (int s = lane; s < len; s += 32) {
      const float e = expf(pr[s] - mx);
      pr[s] = e;
      sum += e;
    }
    if constexpr (Q) {  // in the plain version's order, as the context (context_in_order)
      __syncwarp();
      float a = 0.0f;
      for (int s = lane; lane < 4 && s < len; s += 4) a += pr[s];
      const float a1 = __shfl_sync(0xffffffffu, a, 1), a2 = __shfl_sync(0xffffffffu, a, 2);
      const float a3 = __shfl_sync(0xffffffffu, a, 3);
      sum = __shfl_sync(0xffffffffu, ((a + a1) + a2) + a3, 0);
    } else {
      sum = warp_sum(sum);
    }
    for (int s = lane; s < len; s += 32) pr[s] = Num<T>::round(pr[s] / sum);
  }
  __syncwarp();
  if constexpr (Q) {
    context_in_order<T, R>(probs, S, vr, ps, hd, hdp, len, ctx, ldc);
    __syncthreads();
    return;
  }
  for (int i = lane; i < RW * chunks * groups; i += 32) {
    const int w = i / (chunks * groups), rest = i - w * chunks * groups;
    const int c = rest / groups, s0 = c * kChunk;
    const int r = warp + w * kWarps;
    const float* pr = probs + r * S;
    if (!vec) {
      const int d = rest - c * groups;
      float acc = 0.0f;
      for (int j = 0; j < kChunk && s0 + j < len; ++j)
        acc += Num<T>::round(pr[s0 + j] * Num<T>::to_f(vr[w][(size_t)(s0 + j) * ps + d]));
      part[(r * max_chunks + c) * hd + d] = acc;
      continue;
    }
    const int d = (rest - c * groups) * VW;
    uint4 vv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (s0 + j < len) vv[j] = load16(vr[w] + (size_t)(s0 + j) * ps + d);
    float acc[VW];
#pragma unroll
    for (int i2 = 0; i2 < VW; ++i2) acc[i2] = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (s0 + j < len)
#pragma unroll
        for (int i2 = 0; i2 < VW; ++i2) acc[i2] += Num<T>::round(pr[s0 + j] * widen<T>(vv[j], i2));
#pragma unroll
    for (int i2 = 0; i2 < VW; ++i2) part[(r * max_chunks + c) * hd + d + i2] = acc[i2];
  }
  __syncwarp();
  for (int i = lane; i < RW * hdp; i += 32) {
    const int w = i / hdp, d = i - w * hdp, r = warp + w * kWarps;
    const float* rp = part + r * max_chunks * hd;
    float acc = 0.0f;
    if (d < hd) {
      acc = rp[d];
      for (int c = 1; c < chunks; ++c) acc += rp[c * hd + d];
    }
    put(ctx + r * ldc + d, acc);
  }
  __syncthreads();
}

// The exchange of a K-split projection, then the residual and layernorm.
// Every CTA h has stored its partial sums of the Ep (padded) columns into
// the receive buffer of their owner (column e belongs to CTA e / (Ep / G)),
// at rows h * R.., each store counted on the owner's receive mbarrier.
// Each CTA waits for its columns' G partials (R * Ep * 4 bytes), sums them
// in rank order, adds the bias and the residual, and stores the result into
// every CTA's gather buffer [R][Ep], counted on that CTA's gather mbarrier;
// once its own gather phase completes (the whole rows) every CTA runs the
// layernorm (with `fs`, the final norm after it) on the full rows, writes x
// to xs and, rounded to T, to the A operand xa.  One reduction per column
// and one code path, no atomics: the G copies of the rows are
// bit-identical.  No cluster barrier: a CTA waits only for the bytes it
// reads.  Each mbarrier completes one phase an exchange (`parity` = the
// exchange's count & 1); its thread 0 arms the next phase with its bytes
// as soon as one completes, before any of them can be sent.  A buffer is
// written again only after its readers are done: a CTA stores its next
// partials after its gather phase, which needs every owner's sums, each
// read from its receive buffer first; an owner stores its next sums after
// its next receive phase, which needs every CTA's next partials, each sent
// after that CTA's layernorm read its gather buffer.  The layernorm runs
// one warp a row, four adjacent columns a lane per 128.
//
// In int8 mode (Q) the partials are int32: the owner sums them exactly,
// converts the total to float32 once and dequantizes it with the row's
// scale qt.xscale and the column's qt.s before the bias; and where qt.xq is
// not null the normalised rows go, quantized with their own abs-max, to
// the int8 A operand qt.xq [R][qt.ldq] (their scales to qt.xq_scale) in
// place of xa.
struct Quant {
  const float* s;       // the K-split projection's per-channel scales [E]
  const float* xscale;  // its input rows' scales [R]
  int8_t* xq;           // the next N-split projection's A operand, or null
  int ldq;
  float* xq_scale;      // ... and its rows' scales [R]
};

template <typename T, int R, bool Q>
__device__ void exchange_ln(const float* recv, float* gath, uint32_t recv_bar, uint32_t gath_bar,
                            uint32_t parity, int G, int h, const T* bias, float* xs, const T* s,
                            const T* b, const T* fs, const T* fb, int E, int Ep, float eps,
                            T* xa, int lda, Quant qt) {
  constexpr int J = kMaxE / 128, RW = R / kWarps;  // 128-column runs of a row, rows a warp
  const int Es = Ep / G, q4 = Es / 4;
  wait_phase(recv_bar, parity);  // every partial slice of this CTA's columns
  // the next phase's bytes, counted before this thread's stores below can
  // let any CTA send them
  if (threadIdx.x == 0) expect_bytes(recv_bar, 4u * R * Ep);
  const uint32_t gath_at = smem_u32(gath);
  for (int i = threadIdx.x; i < R * q4; i += blockDim.x) {
    const int r = i / q4, c = (i - r * q4) * 4, e = h * Es + c;
    const float4 xr = *reinterpret_cast<const float4*>(xs + r * Ep + e);
    float4 y;
    if constexpr (Q) {
      int4 a = *reinterpret_cast<const int4*>(recv + r * Es + c);
      for (int g = 1; g < G; ++g) {
        const int4 o = *reinterpret_cast<const int4*>(recv + (g * R + r) * Es + c);
        a.x += o.x; a.y += o.y; a.z += o.z; a.w += o.w;
      }
      const int av[4] = {a.x, a.y, a.z, a.w};
      float v[4];  // the padding columns' are 0 (as their residual is)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = e + k < E ? dequant<T>(av[k], qt.xscale[r], __ldg(qt.s + e + k), bias, e + k)
                         : 0.0f;
      y = make_float4(xr.x + v[0], xr.y + v[1], xr.z + v[2], xr.w + v[3]);
    } else {
      float4 a = *reinterpret_cast<const float4*>(recv + r * Es + c);
      for (int g = 1; g < G; ++g) {
        const float4 o = *reinterpret_cast<const float4*>(recv + (g * R + r) * Es + c);
        a.x += o.x; a.y += o.y; a.z += o.z; a.w += o.w;
      }
      float bv[4];  // the padding columns' bias is 0 (their partials and residual are too)
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = e + i < E ? Num<T>::to_f(bias[e + i]) : 0.0f;
      y = make_float4(xr.x + (a.x + bv[0]), xr.y + (a.y + bv[1]), xr.z + (a.z + bv[2]),
                      xr.w + (a.w + bv[3]));
    }
    for (int g = 0; g < G; ++g)
      store_counted(remote(gath_at + 4 * (r * Ep + e), g), y, remote(gath_bar, g));
  }
  wait_phase(gath_bar, parity);  // every row is whole here
  if (threadIdx.x == 0) expect_bytes(gath_bar, 4u * R * Ep);  // before the next partials go out
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[RW][J][4];
  float sum[RW];
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    sum[w] = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = 4 * lane + 128 * j;
      if (e < Ep) {  // the padding columns are 0 and add nothing
        const float4 v = *reinterpret_cast<const float4*>(gath + (warp + w * kWarps) * Ep + e);
        x[w][j][0] = v.x; x[w][j][1] = v.y; x[w][j][2] = v.z; x[w][j][3] = v.w;
        sum[w] += (x[w][j][0] + x[w][j][1]) + (x[w][j][2] + x[w][j][3]);
      }
    }
  }
  for (int pass = 0; pass < (fs != nullptr ? 2 : 1); ++pass) {
    const T* sc = pass == 0 ? s : fs;
    const T* bi = pass == 0 ? b : fb;
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      if (pass == 1) {
        sum[w] = 0.0f;
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (4 * lane + 128 * j < Ep)
            sum[w] += (x[w][j][0] + x[w][j][1]) + (x[w][j][2] + x[w][j][3]);
      }
      const float mean = warp_sum(sum[w]) / (float)E;
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * lane + 128 * j + i < E) {
            const float d = x[w][j][i] - mean;
            sq += d * d;
          }
      const float inv = rsqrtf(warp_sum(sq) / (float)E + eps);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = 4 * lane + 128 * j;
        if (e < Ep)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[w][j][i] = e + i < E ? (x[w][j][i] - mean) * inv * Num<T>::to_f(sc[e + i]) +
                                         Num<T>::to_f(bi[e + i])
                                   : 0.0f;
      }
    }
  }
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = warp + w * kWarps;
    if (Q && qt.xq != nullptr) {  // quantized with the row's abs-max (padding: 0)
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (4 * lane + 128 * j < Ep)
#pragma unroll
          for (int i = 0; i < 4; ++i) m = fmaxf(m, fabsf(quant_input<T>(x[w][j][i])));
      m = warp_max(m);
      const float inv = inv_scale(m);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = 4 * lane + 128 * j;
        if (e < Ep) {
          *reinterpret_cast<float4*>(xs + r * Ep + e) =
              make_float4(x[w][j][0], x[w][j][1], x[w][j][2], x[w][j][3]);
          *reinterpret_cast<char4*>(qt.xq + r * qt.ldq + e) =
              make_char4(quant8<T>(x[w][j][0], inv), quant8<T>(x[w][j][1], inv),
                         quant8<T>(x[w][j][2], inv), quant8<T>(x[w][j][3], inv));
        }
      }
      if (lane == 0) qt.xq_scale[r] = __fdiv_rn(m, 127.0f);
      continue;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = 4 * lane + 128 * j;
      if (e < Ep) {
        *reinterpret_cast<float4*>(xs + r * Ep + e) =
            make_float4(x[w][j][0], x[w][j][1], x[w][j][2], x[w][j][3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[r * lda + e + i] = Num<T>::from_f(x[w][j][i]);
      }
    }
  }
}

// The cluster-wide abs-max of the R rows of a K-split input, then the
// rows quantized with it (int8 mode).  src [R][lds] holds this CTA's Kc
// columns of each row (float32, padding 0).  Each warp takes the maxima of
// its rows' slices and stores them into every CTA's amx [kMaxCluster][R]
// at row h, counted on that CTA's mbarrier `bar` (one phase an exchange,
// `parity` as exchange_ln's, armed again by thread 0 as soon as it
// completes); once all G have arrived it takes the maximum over them (in
// rank order; max is exact, so every CTA gets the same), quantizes its
// slice into dst [R][ldd] and writes the rows' scales (abs-max / 127) to
// xscale.  amx is written again only after every CTA has read it: the
// next maxima go out after the sender's next gather phase, which needs
// every CTA's sums, each stored after that CTA quantized this exchange's
// slice.  Synchronises the block before it returns.
template <typename T, int R>
__device__ void quantize_split(const float* src, int lds, int Kc, float* amx, uint32_t bar,
                               uint32_t parity, int G, int h, int8_t* dst, int ldd,
                               float* xscale) {
  constexpr int RW = R / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = warp + w * kWarps;
    const float m = row_absmax<T>(src + r * lds, Kc);
    if (lane < G) store_counted(remote(smem_u32(amx + h * R + r), lane), m, remote(bar, lane));
  }
  wait_phase(bar, parity);
  if (threadIdx.x == 0) expect_bytes(bar, 4u * G * R);
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = warp + w * kWarps;
    float m = 0.0f;
    for (int g = 0; g < G; ++g) m = fmaxf(m, amx[g * R + r]);
    const float xs = quantize_row<T>(src + r * lds, Kc, m, dst + r * ldd);
    if (lane == 0) xscale[r] = xs;
  }
  __syncthreads();
}

// The N-split input rows src [R][lds] (K columns, whole in every CTA)
// quantized with their own abs-max into dst [R][ldd], their scales to
// xscale (int8 mode, the embedded rows).  Synchronises the block.
template <typename T, int R>
__device__ void quantize_rows(const float* src, int lds, int K, int8_t* dst, int ldd,
                              float* xscale) {
  constexpr int RW = R / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = warp + w * kWarps;
    const float xs = quantize_row<T>(src + r * lds, K, row_absmax<T>(src + r * lds, K),
                                     dst + r * ldd);
    if (lane == 0) xscale[r] = xs;
  }
  __syncthreads();
}

// The cycles the first thread of CTA 0 spends in each phase of a step (the
// embedding, the fourteen phases of a layer and the class head, the
// logits and argmax; in int8 mode then the three abs-max exchanges of a
// layer), summed over the launch into prof[phase]; a phase ends where that
// thread leaves it, so a barrier's wait counts to the phase it closes.
// prof is null unless the caller asks for the profile.
struct Marks {
  long long* prof;
  long long t0;
  __device__ void at(int phase) {
    if (prof != nullptr) {
      const long long t = clock64();
      prof[phase] += t - t0;
      t0 = t;
    }
  }
};

template <typename T, bool Q>
__global__ void __launch_bounds__(kThreads, 1) decode_cluster_kernel(Params<T> p) {
  constexpr int R = kRows, D = kDepth;
  using FT = Frag<T, R>;  // products in T: every one in float mode, the class head's in int8
  using FQ = FragQ<R>;    // int8 mode's six projections
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Geometry<T, Q> geo(p);
  const int E = p.E, Ep = geo.Ep, C = p.C, T_ = p.steps, L = p.L, G = p.G, Hc = geo.Hc;
  const int hd = geo.hd;
  const int hdp = geo.hdp, W = geo.W, Fg = geo.Fg, Fgp = geo.Fgp;
  const int lda = geo.lda, ldb = geo.ldb, lda8 = geo.lda8, ldb8 = geo.ldb8, ldf = geo.ldf;
  const int S = geo.S;
  char* ring = reinterpret_cast<char*>(smem);       // [kWarps][D][32 lanes][16 B]
  float* xs = reinterpret_cast<float*>(ring + (size_t)kWarps * D * kUnit);  // [R][Ep]
  T* xa = reinterpret_cast<T*>(xs + R * Ep);        // [R][lda] A operand of E-wide inputs
  int8_t* xa8 = reinterpret_cast<int8_t*>(xa);      // int8: [R][lda8] ... of the N-split ones
  unsigned char* kin = reinterpret_cast<unsigned char*>(xa) + geo.a_bytes(R);
  T* xb = reinterpret_cast<T*>(kin);                // [R][ldb] A operand of the K-split inputs
  int8_t* xb8 = reinterpret_cast<int8_t*>(kin);     // int8: [R][ldb8] ... quantized from
  float* hf = reinterpret_cast<float*>(kin + R * ldb8);  // int8: [R][ldf] the float32 rows
  float* qv = reinterpret_cast<float*>(kin + geo.b_bytes(R));  // [R][3W] q, k, v / cross q
  float* recv = qv + R * 3 * W;                     // [G][R][Ep/G] partials of this CTA's columns
  float* gath = recv + R * Ep;                      // [R][Ep] the rows before the layernorm
  float* red = gath + R * Ep;                       // attention chunk sums; the head's logits
  float* probs = red + geo.red_floats(R);           // [R][S]
  int* tok = reinterpret_cast<int*>(probs + R * S); // [R]
  int* done = tok + R;                              // [R] rows that have emitted eos_id
  float* amx = reinterpret_cast<float*>(done + R);  // int8: [kMaxCluster][R] slices' abs-max
  float* xsa = amx + kMaxCluster * R;               // int8: [R] scales of the N-split inputs
  float* xsk = xsa + R;                             // int8: [R] ... of the K-split inputs

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = (int)cl.block_rank();
  const int r0 = blockIdx.x / G * R;
  const int nrows = min(R, p.B - r0);  // the last tile may be ragged
  const size_t cache_l = (size_t)p.B * T_ * E;
  const size_t mem_l = (size_t)p.B * p.Tm * E;

  Stream<D> st;
  {
    int before = 0, before_head = 0;  // units of the warps before this one
    for (int w = 0; w < warp; ++w) {
      before += geo.units(w, 0, kProj - 1);
      before_head += geo.units(w, kProj - 1, kProj);
    }
    st.layer = (size_t)G * geo.layer_units * kUnit;
    st.first = p.packed + ((size_t)h * geo.layer_units + before) * kUnit + lane * 16;
    st.head = p.packed + L * st.layer + (size_t)before_head * kUnit + lane * 16;
    st.ring = ring + (size_t)warp * D * kUnit + lane * 16;
    st.src = st.first;
    st.L = L;
    st.U = geo.units(warp, 0, kProj - 1);
    st.UH = geo.units(warp, kProj - 1, kProj);
    st.l = 0;
    st.u = 0;
    st.settle();
    for (int i = 0; i < D; ++i) st.issue(i);
    st.slot = 0;
  }

  if (tid < R) {
    tok[tid] = p.go_id;
    done[tid] = tid >= nrows;  // rows past the batch count as stopped
  }
  __syncthreads();

  // the exchanges' mbarriers (partials, gathered rows; in int8 mode the
  // slices' abs-max), one phase an exchange; set up before any CTA of the
  // cluster can count bytes on them
  __shared__ __align__(8) unsigned long long bars[3];
  const uint32_t recv_bar = smem_u32(&bars[0]), gath_bar = smem_u32(&bars[1]);
  const uint32_t amax_bar = smem_u32(&bars[2]);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(recv_bar) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(gath_bar) : "memory");
    expect_bytes(recv_bar, 4u * R * Ep);  // the first exchange's
    expect_bytes(gath_bar, 4u * R * Ep);
    if (Q) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(amax_bar) : "memory");
      expect_bytes(amax_bar, 4u * G * R);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  uint32_t ex = 0;  // exchanges so far

  Marks mark{tid == 0 && blockIdx.x == 0 ? p.prof : nullptr, clock64()};
  for (int t = 0; t < T_; ++t) {
    const bool from_cls = t == 0 && p.cls0 != nullptr;
    for (int i = tid; i < R * Ep; i += nt) {
      const int r = i / Ep, e = i - r * Ep;
      float x = 0.0f;  // in the padding columns
      if (e < E) {
        x = from_cls ? p.cls0[(size_t)(r0 + min(r, nrows - 1)) * E + e]
                     : Num<T>::to_f(p.emb[(size_t)tok[r] * E + e]);
        x += p.pe[t * E + e];
      }
      xs[i] = x;
      if (!Q) xa[r * lda + e] = Num<T>::from_f(x);
    }
    __syncthreads();
    if (Q) quantize_rows<T, R>(xs, Ep, Ep, xa8, lda8, xsa);
    mark.at(0);

    for (int l = 0; l < L; ++l) {
      // -- self attention of this CTA's heads over the running KV cache --
      const Cols qkv{hdp, hd, Hc, E, hd, h * Hc * hd, 0, Q ? p.qs[0] + (size_t)l * 3 * E : nullptr,
                     xsa};
      if constexpr (Q)
        project<T, FQ, D, kQBias>(&st, xa8, lda8, Ep, 3 * W, p.b_qkv + (size_t)l * 3 * E, qkv, qv,
                                  3 * W);
      else
        project<T, FT, D, kBias>(&st, xa, lda, Ep, 3 * W, p.b_qkv + (size_t)l * 3 * E, qkv, qv,
                                 3 * W);
      __syncthreads();
      mark.at(1);
      T* kc = p.kc + l * cache_l + h * Hc * hd;
      T* vc = p.vc + l * cache_l + h * Hc * hd;
      for (int i = tid; i < nrows * Hc * hd; i += nt) {
        const int r = i / (Hc * hd), c = i - r * Hc * hd, j = c / hd, d = c - j * hd;
        const size_t off = ((size_t)(r0 + r) * T_ + t) * E + c;
        kc[off] = Num<T>::from_f(qv[r * 3 * W + W + j * hdp + d]);
        vc[off] = Num<T>::from_f(qv[r * 3 * W + 2 * W + j * hdp + d]);
      }
      __syncthreads();
      mark.at(2);
      for (int j = 0; j < Hc; ++j) {
        if constexpr (Q)
          attend_head<T, R, Q>(qv + j * hdp, 3 * W, kc + j * hd, vc + j * hd, (size_t)T_ * E, E, hd,
                            hdp, t + 1, r0, nrows, p.scale, probs, S, hf + j * hdp, ldf, red);
        else
          attend_head<T, R, Q>(qv + j * hdp, 3 * W, kc + j * hd, vc + j * hd, (size_t)T_ * E, E, hd,
                            hdp, t + 1, r0, nrows, p.scale, probs, S, xb + j * hdp, ldb, red);
      }
      mark.at(3);
      const Cols partial{Ep / G, Ep / G, 1, 0, 0, h * R, recv_bar};
      if constexpr (Q) {
        quantize_split<T, R>(hf, ldf, W, amx, amax_bar, ex & 1, G, h, xb8, ldb8, xsk);
        mark.at(15);
        project<T, FQ, D, kQPartial>(&st, xb8, ldb8, W, Ep, nullptr, partial, recv, 0);
      } else {
        project<T, FT, D, kPartial>(&st, xb, ldb, W, Ep, nullptr, partial, recv, 0);
      }
      mark.at(4);
      exchange_ln<T, R, Q>(recv, gath, recv_bar, gath_bar, ex++ & 1, G, h,
                           p.b_out + (size_t)l * E, xs, p.n1_s + l * E, p.n1_b + l * E, nullptr,
                           nullptr, E, Ep, p.eps, xa, lda,
                           Quant{Q ? p.qs[1] + (size_t)l * E : nullptr, xsk, xa8, lda8, xsa});
      __syncthreads();
      mark.at(5);

      // -- cross attention of this CTA's heads over the precomputed memory K/V --
      const Cols cq{hdp, hd, Hc, 0, hd, h * Hc * hd, 0, Q ? p.qs[2] + (size_t)l * E : nullptr, xsa};
      if constexpr (Q)
        project<T, FQ, D, kQBias>(&st, xa8, lda8, Ep, W, p.cb_q + (size_t)l * E, cq, qv, W);
      else
        project<T, FT, D, kBias>(&st, xa, lda, Ep, W, p.cb_q + (size_t)l * E, cq, qv, W);
      __syncthreads();
      mark.at(6);
      for (int j = 0; j < Hc; ++j) {
        const size_t at = l * mem_l + (size_t)(h * Hc + j) * hd;
        if constexpr (Q)
          attend_head<T, R, Q>(qv + j * hdp, W, p.ck + at, p.cv + at, (size_t)p.Tm * E, E, hd, hdp,
                            p.Tm, r0, nrows, p.scale, probs, S, hf + j * hdp, ldf, red);
        else
          attend_head<T, R, Q>(qv + j * hdp, W, p.ck + at, p.cv + at, (size_t)p.Tm * E, E, hd, hdp,
                            p.Tm, r0, nrows, p.scale, probs, S, xb + j * hdp, ldb, red);
      }
      mark.at(7);
      if constexpr (Q) {
        quantize_split<T, R>(hf, ldf, W, amx, amax_bar, ex & 1, G, h, xb8, ldb8, xsk);
        mark.at(16);
        project<T, FQ, D, kQPartial>(&st, xb8, ldb8, W, Ep, nullptr, partial, recv, 0);
      } else {
        project<T, FT, D, kPartial>(&st, xb, ldb, W, Ep, nullptr, partial, recv, 0);
      }
      mark.at(8);
      exchange_ln<T, R, Q>(recv, gath, recv_bar, gath_bar, ex++ & 1, G, h,
                           p.cb_o + (size_t)l * E, xs, p.n2_s + l * E, p.n2_b + l * E, nullptr,
                           nullptr, E, Ep, p.eps, xa, lda,
                           Quant{Q ? p.qs[3] + (size_t)l * E : nullptr, xsk, xa8, lda8, xsa});
      __syncthreads();
      mark.at(9);

      // -- feed-forward: this CTA's Fg hidden columns stay in it --
      const int fw = min(Fg, max(0, p.F - h * Fg));  // of which real
      const Cols ff{Fgp, fw, 1, 0, 0, h * Fg, 0, Q ? p.qs[4] + (size_t)l * p.F : nullptr, xsa};
      if constexpr (Q)
        project<T, FQ, D, kQRelu>(&st, xa8, lda8, Ep, Fgp, p.ff1_b + (size_t)l * p.F, ff, hf,
                                  ldf);
      else
        project<T, FT, D, kReluRoundT>(&st, xa, lda, Ep, Fgp, p.ff1_b + (size_t)l * p.F, ff, xb,
                                       ldb);
      __syncthreads();
      mark.at(10);
      if constexpr (Q) {
        quantize_split<T, R>(hf, ldf, Fgp, amx, amax_bar, ex & 1, G, h, xb8, ldb8, xsk);
        mark.at(17);
        project<T, FQ, D, kQPartial>(&st, xb8, ldb8, Fgp, Ep, nullptr, partial, recv, 0);
      } else {
        project<T, FT, D, kPartial>(&st, xb, ldb, Fgp, Ep, nullptr, partial, recv, 0);
      }
      mark.at(11);
      const bool last = l == L - 1;  // then the final norm follows, and the head reads T
      exchange_ln<T, R, Q>(recv, gath, recv_bar, gath_bar, ex++ & 1, G, h,
                           p.ff2_b + (size_t)l * E, xs, p.n3_s + l * E, p.n3_b + l * E,
                           last ? p.fn_s : nullptr, last ? p.fn_b : nullptr, E, Ep, p.eps, xa, lda,
                           Quant{Q ? p.qs[5] + (size_t)l * E : nullptr, xsk,
                                 last ? nullptr : xa8, lda8, xsa});
      __syncthreads();
      mark.at(12);
    }

    // -- class head, in every CTA alike --
    float* lg = red;  // [R][Cp]
    project<T, FT, D, kBias>(&st, xa, lda, Ep, geo.Cp, p.head_b, Cols{geo.Cp, C, 1, 0, 0, 0}, lg,
                             geo.Cp);
    __syncthreads();
    mark.at(13);
    if (h == 0) {
      for (int i = tid; i < R * C; i += nt) {
        const int r = i / C, c = i - r * C;
        if (r < nrows && !done[r])
          p.logits[((size_t)(r0 + r) * T_ + t) * C + c] = lg[r * geo.Cp + c];
      }
    }
    // first-index argmax per row, one warp per row
    for (int r = warp; r < R; r += nt >> 5) {
      float best = lane < C ? lg[r * geo.Cp + lane] : -__int_as_float(0x7f800000);
      int bi = lane < C ? lane : C;
      for (int c = lane + 32; c < C; c += 32) {
        float v = lg[r * geo.Cp + c];
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
      if (all_done) break;  // the same value in every thread of every CTA
      __syncthreads();
    }
    mark.at(14);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cl.sync();  // no CTA leaves while the cluster may still use its shared memory
}

template <typename T, bool Q>
int launch(const Params<T>& p, int smem_expected, cudaStream_t stream) {
  const Geometry<T, Q> geo(p);
  const size_t smem = geo.smem_bytes(kRows, kDepth);
  if ((int)smem != smem_expected) return (int)cudaErrorInvalidValue;
  const auto kernel = decode_cluster_kernel<T, Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.B + kRows - 1) / kRows * p.G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be resident is refused, never run another way
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, bool Q>
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
  p.logits = (float*)ptr[nw + 5];
  p.packed = (const char*)ptr[nw + 6];
  p.prof = (long long*)ptr[nw + 7];
  for (int j = 0; j < 6; ++j) p.qs[j] = Q ? (const float*)ptr[nw + 8 + j] : nullptr;
  p.B = dim[0]; p.steps = dim[1]; p.L = dim[2]; p.E = dim[3]; p.F = dim[4];
  p.C = dim[5]; p.H = dim[6]; p.Tm = dim[7]; p.go_id = dim[8]; p.eos_id = dim[9];
  const int smem = dim[10];
  p.G = dim[11];
  p.eps = eps;
  p.scale = scale;
  // the caller's cluster plan (ops/fused_decode.cluster_plan) must be this one
  const int Ep = padk(p.E, Geometry<T, Q>::kStep);
  if (p.H < 1 || p.E % p.H || Ep > kMaxE || p.G != cluster_size(Ep, p.H))
    return (int)cudaErrorInvalidValue;
  if (p.B == 0 || p.steps == 0) return 0;
  return launch<T, Q>(p, smem, stream);
}

}  // namespace

// ptr: the 23 weight tables in Params order, then pe, ck, cv, kc, vc,
// logits, the packed weight units and the int64 [15] phase profile (null:
// none; see Marks).  dim: B, T, L, E, F, C, H, Tm, go_id,
// eos_id (< 0: no early stop), and the shared-memory bytes and CTAs a
// cluster the caller planned (both checked).
// dtype: 0 = float32, 1 = bfloat16.  cls0: the [B, E] float32 step-0 rows,
// or null for the [GO] embedding.  Every pointer lies on the device of
// `stream`, which the caller makes the current device for the call.
extern "C" int fused_decode_cluster(int dtype, const void* const* ptr, const int* dim, float eps,
                                    float scale, const void* cls0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c0 = (const float*)cls0;
  if (dtype == 0) return run<float, false>(ptr, dim, eps, scale, c0, s);
  if (dtype == 1) return run<__nv_bfloat16, false>(ptr, dim, eps, scale, c0, s);
  return (int)cudaErrorInvalidValue;
}

// K1q: as fused_decode_cluster, with the units of pack_cluster_tables_int8
// (the six projections int8, the class head in the compute type; the int8
// tables' own slots are not read), an int64 [18] profile, and then the six
// per-channel scales [L, N] float32 (qkv, out, cross-q, cross-out, ff1,
// ff2).  dtype: the compute type of the other tables, as above.
extern "C" int fused_decode_cluster_int8(int dtype, const void* const* ptr, const int* dim,
                                         float eps, float scale, const void* cls0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c0 = (const float*)cls0;
  if (dtype == 0) return run<float, true>(ptr, dim, eps, scale, c0, s);
  if (dtype == 1) return run<__nv_bfloat16, true>(ptr, dim, eps, scale, c0, s);
  return (int)cudaErrorInvalidValue;
}
