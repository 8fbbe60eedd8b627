// The whole Swin block at any window and width, forward and backward, for
// Hopper, sm_90a: the generic variant of swin_block.cu.
//
// Replaces: dmhomo_tpu/ops/swin_block.py::_fwd_kernel and ::_bwd_kernel at
// the shapes the tuned library (swin_block.cu: 8x8 windows, C in 24, 48, 96,
// an MLP of 1-4 C) does not take: any window ws <= 12 dividing H and W, C =
// heads * hd with hd <= 64 and C <= 384, any MLP width 1..4 C, any shift < ws.
// Called through ctypes by ops/swin_block.py, which takes this variant
// wherever the tuned library does not.
//
// The function is the tuned kernels' (ops/swin_block.py::swin_block_reference,
// round() the rounding to the I/O dtype): on (B, H, W, C) tokens rolled by
// -shift and cut into ws x ws windows,
//   n1 = round(LN1(x)), qkv = round(n1 round(Wq)^T + bq), att = the window
//   attention of window_attention_any.cuh, h = round(x + round(att round(Wp)^T
//   + bp)), n2 = round(LN2(h)), gm = round(gelu(n2 round(W1)^T + c1)),
//   y = round(h + round(gm round(W2)^T + c2)), rolled back by +shift.
// Every intermediate is held in device memory at the precision the plain
// version holds it in (round() values in the I/O dtype, m1, dm1, dh and the
// LayerNorm input gradients in fp32), so the roundings fall where they fall
// there.
//
// Why a sequence of launches.  At ws = 12 and C = 384 a window's fp32 tokens
// alone take 221 KB, so one block per window (the tuned design) cannot hold
// them.  The forward is five launches:
//   0. the weights prepared once per call: round(W) in the I/O dtype,
//      zero-padded, laid out [K][N] as the products read them (the backward
//      also the four untransposed orientations its products take);
//   1. LN1 fused into the qkv product, each token gathered at its shifted
//      window coordinates (no roll copy);
//   2. the window attention (window_attention_any.cuh) over the window-order
//      qkv;
//   3. in one launch, each block on its tile of rows: the projection with
//      its bias and the residual x (gathered), then LN2 fused into fc1 on the
//      rows of h the block has just written (read back from L2), with the
//      exact-erf GELU;
//   4. fc2 with its bias and the residual h, each token scattered back to its
//      place in the image (the roll undone by the same map).
// The backward prepares its eight weight matrices, recomputes 1-3 (keeping
// n1, n2 and the fp32 m1), then runs the chain back: dm1 = (dy round(W2))
// gelu'(m1); dn2 = round(dm1) round(W1) and, in the same launch, the
// LayerNorm-2 rows (dh = dy + LN2'(dn2)); dao = round(round(dh) round(Wp));
// the attention's backward; dn1 = dqkv round(Wq) with the LayerNorm-1 rows
// (dx = round(dh + LN1'(dn1)), scattered); the four weight products over
// the tokens, each with a ones column for its bias vector; and one
// reduction: eleven launches.
//
// The products (swin_block_any_gemm_kernel).  A block owns a tile of token
// rows and every output column of its product: it stages its A rows once,
// in window order through the gather map (cp.async, 16 bytes a copy with
// neighbouring threads on neighbouring addresses, where a row's bytes are a
// multiple of 16; an fp32 A rounded to bf16 through 16-byte loads), computes
// each row's LayerNorm statistics once (a group of 8, 16 or 32 lanes a row,
// two passes over the staged row) and normalizes and rounds it in place,
// then walks the output columns in chunks, the prepared weights streaming
// through a two-stage cp.async ring of (column chunk, depth slice) pieces.
// Epilogues apply the bias, the roundings, the residual, the GELU or its
// derivative from the accumulators, 16 bytes a thread (fp32) or a quad of
// threads (bf16) a row.
//   bf16: 64 rows a block, 64 columns a chunk, mma.sync m16n8k16 fed by
//   ldmatrix (A: x4 from the row-major tile; B: x4.trans from the [k][n]
//   stage), each warp 16 rows x 32 columns; a warp whose columns all lie
//   past the output width skips its products.  Each MMA sums its 16
//   products from zero and the result is added to the fp32 accumulator
//   (mma_add; chained through the tensor core the 1x1-window dbias, a sum
//   that cancels, missed its 2e-2 tolerance).  bf16 x bf16 products summed
//   in fp32 otherwise differ from the plain version only in order.
//   fp32: CUDA cores, TF32 never used.  Each thread 4 rows x 4 columns: per
//   4 of depth, one float4 of A for each row and four float4 of the weights
//   for 64 FMAs, at 64 registers so that four blocks share an SM (8 x 4 a
//   thread at three blocks an SM was 4% slower on the backward at window 4).
//   A chunk is 4096 outputs (32 to 512 columns), the one whose padded work an
//   SM takes in whole waves is least among those that fit two blocks to an
//   SM, ring stages 32 deep where they fit (gemm_tile;
//   ops/swin_block.py::_gemm_tile mirrors the choice).
// dn2 and dn1 end with the LayerNorm backward of their rows (EPI_LNB): after
// the product the block reads its dn rows back from L2, and a group of
// lanes a row makes four passes over it (statistics, the two means, the
// output), each group adding its rows' (dn xhat, dn) to its own partials
// in shared memory; these launches take at most LN_MAX_BLOCKS blocks, each
// a fixed range of tiles, so the partials stay few.
//
// The weight products (swin_block_any_weights_kernel): part[split][a][b] =
// sum over the split's tokens of L[t][a] R[t][b], 64 x 64 output tiles, the
// tokens through a two-stage cp.async ring; the splits aim at 16 blocks an
// SM.  dW2 = dy^T gm and dWq = dqkv^T n1 take two bf16 operands in the bf16
// step: mma.sync from ldmatrix.x4.trans of both token-major stages (64
// tokens a stage).  dW1 = dm1^T n2 and dWp = dh^T ao take dm1 and dh in fp32
// (swin_block_backward_reference), so they stay fp32 products on CUDA cores
// (each thread 4 x 4 outputs from float4 reads, 32 tokens a stage), as does
// every product of the fp32 instantiation: rounding the fp32 operand would
// change the function, and the three-way bf16 split (hi + mid + lo) is not
// used: the two products are 4 C^2 of the block's 10 C^2 flops a token,
// and CUDA cores keep them exact at no risk to the tolerances.
//
// What bounds it on an H100.  The bound of a window-4 call is the operations
// (fp32) or the bytes (bf16) of the block and its attention: tens of
// microseconds.  What holds these kernels above it is latency: at the HEM's
// widths (K = C to 3C, 24 to 288) a tile's work is a chain of short phases
// (the rows' window map, staging, the LayerNorm, a few ring stages, the
// epilogue) with little arithmetic each, overlapped only across the 2-4
// blocks an SM holds; fp32 products also pay the CUDA cores' 67 TFLOP/s
// where K reaches 96.  The window attention inside is generic kernels 1-2's
// code (a warp per window and head, bf16 on tensor cores), launched with
// their own plan at the block's I/O dtype; the tensor-core and copy helpers
// below come from the same header.
//
// No atomics.  The weight gradients and bias vectors are summed over fixed
// ranges of tokens into per-split partials, the LayerNorm gains' and biases'
// over fixed ranges of tiles into per-block partials, dbias per chunk of
// windows into slabs; one reduction launch adds every family in a fixed
// order.  The same bits every run.

#include <cstdint>
#include <type_traits>

#include "window_attention_any.cuh"

namespace {

using wa_any::from_f;
using wa_any::round_to;
using wa_any::to_f;

typedef __nv_bfloat16 bf16;

constexpr int GT = 256;  // threads of every block but the attention's
constexpr int MAX_WS = 12;
constexpr int MAX_C = 384;
constexpr int WEIGHT_BLOCKS_PER_SM = 16;  // the weight products' splits aim at
constexpr int LN_MAX_BLOCKS = wa_any::SMS * 8;
constexpr float LN_EPS = 1e-5f;
// the products
constexpr int TC_BM = 64, TC_BN = 64, TC_KC = 32;  // bf16: rows, chunk columns, ring depth
constexpr int F_KC = 32;  // fp32: a ring stage's depth (16 where 32 does not fit)
constexpr int F_OUTPUTS = 4096;  // fp32: rows x chunk columns, 4 x 4 a thread
constexpr int GEMM_BLOCKS_PER_SM = 4;  // the products' launch bounds
// the weight products
constexpr int WT = 64;  // output tile side
constexpr int WKT = 64;  // tokens a ring stage, bf16
constexpr int WKT_F = 32;  // tokens a ring stage, fp32
constexpr int WLD = WT + 8;  // bf16 stage row stride (halves)
// the larger of the two rings (two stages of L and R)
constexpr int WEIGHT_SMEM = 2 * 2 * WKT * WLD * 2 > 2 * WKT_F * WT * 8 ? 2 * 2 * WKT * WLD * 2
                                                                       : 2 * WKT_F * WT * 8;
// the preparing launch
constexpr int PREP_MATS = 8;
constexpr int PREP_MAX_BLOCKS = wa_any::SMS * 8;

// ---------------------------------------------------------------------------
// PTX helpers: window_attention_any.cuh's
// ---------------------------------------------------------------------------

using wa_any::cp_async16;
using wa_any::cp_async_commit;
using wa_any::cp_async_wait;
using wa_any::ldsm_x4;
using wa_any::ldsm_x4_trans;
using wa_any::mma_add;

// W consecutive values at p as fp32 (vec: one aligned vector load), else
// the first `valid` of them and zeros
template <int W>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[W], bool vec, int valid) {
  if (vec) {
    if constexpr (W == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x, v[1] = q.y;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e) v[e] = e < valid ? p[e] : 0.0f;
}

template <int W>
__device__ __forceinline__ void load_vals(const bf16* p, float (&v)[W], bool vec, int valid) {
  if (vec) {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
    if constexpr (W == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
      const float2 a = __bfloat1622float2(*q);
      v[0] = a.x, v[1] = a.y;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e) v[e] = e < valid ? __bfloat162float(p[e]) : 0.0f;
}

template <int W>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[W], bool vec, int valid) {
  if (vec) {
    if constexpr (W == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e)
    if (e < valid) p[e] = v[e];
}

template <int W>
__device__ __forceinline__ void store_vals(bf16* p, const float (&v)[W], bool vec, int valid) {
  if (vec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    if constexpr (W == 4) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a);
      u.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(p) = u;
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = a;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e)
    if (e < valid) p[e] = __float2bfloat16_rn(v[e]);
}

// ---------------------------------------------------------------------------
// The window map: token t of the window-order sequence (window w = t / N,
// image-major, token n = t % N row-major in the window) and the image token
// it reads, at its coordinates shifted by +shift mod (H, W).
// ---------------------------------------------------------------------------

struct Geo {
  int B, H, W, ws, shift;
  int narrow;  // B H W < 2^31: the map in 32-bit arithmetic
};

__device__ __forceinline__ long long image_row(long long t, const Geo& g) {
  if (g.narrow) {
    const unsigned N = g.ws * g.ws, ws = g.ws;
    const unsigned nwx = g.W / ws, nwy = g.H / ws;
    const unsigned tt = static_cast<unsigned>(t);
    const unsigned w = tt / N, n = tt - w * N;
    const unsigned r = w / nwx, wx = w - r * nwx;
    const unsigned b = r / nwy, wy = r - b * nwy;
    const unsigned ny = n / ws, nx = n - ny * ws;
    unsigned y = wy * ws + ny + g.shift;
    if (y >= static_cast<unsigned>(g.H)) y -= g.H;
    unsigned x = wx * ws + nx + g.shift;
    if (x >= static_cast<unsigned>(g.W)) x -= g.W;
    return (static_cast<long long>(b) * g.H + y) * g.W + x;
  }
  const int N = g.ws * g.ws;
  const int nwx = g.W / g.ws, nwy = g.H / g.ws;
  const long long w = t / N;
  const int n = static_cast<int>(t - w * N);
  const int wx = static_cast<int>(w % nwx);
  const long long r = w / nwx;
  const int wy = static_cast<int>(r % nwy);
  const long long b = r / nwy;
  int y = wy * g.ws + n / g.ws + g.shift;
  if (y >= g.H) y -= g.H;
  int x = wx * g.ws + n % g.ws + g.shift;
  if (x >= g.W) x -= g.W;
  return (b * g.H + y) * g.W + x;
}

// The lanes that share a row of C values (8, 16 or 32: at most 12 values a
// lane), so that a warp keeps 32 / L rows in flight.
__host__ __device__ __forceinline__ int row_lanes(int C) {
  return C > 192 ? 32 : C > 96 ? 16 : 8;
}

// Sum over each aligned group of L lanes in a fixed butterfly: every lane
// of the group gets it.
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_cdf(float m) {
  return 0.5f * (1.0f + erff(m * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// The products: out[M, N] = epilogue(A[M, K] . B[K, N]), B the prepared
// round(W) in T, [kp][np] row-major, zero-padded
// ---------------------------------------------------------------------------

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A launch's block geometry, shared by the products it chains: bm rows, bn
// columns a chunk, ring stages kc deep, dynamic shared memory bytes.
struct GemmTile {
  int bm, bn, kc, smem;
};

// A product's staged A: its depth padded to kp, its row stride (elements).
inline int a_kp(int K, bool bf16_io) { return round_up(K, bf16_io ? 16 : 4); }
inline int a_lda(int K, bool bf16_io) {
  return bf16_io ? a_kp(K, true) + 8 : round_up(a_kp(K, false), 8) + 4;
}

// the per-row-group LayerNorm partials of a product with the fused
// LayerNorm backward (C columns)
inline int lnb_smem(int lnb_c) { return GT / row_lanes(lnb_c) * 2 * lnb_c * 4; }

// A block's shared memory: the staged rows, a two-stage weight ring, the
// rows' image indices, the LayerNorm partials (extra).
inline int tile_smem(int lda, int bm, int bn, int kc, bool bf16_io, int extra) {
  return bf16_io ? bm * lda * 2 + 2 * kc * (bn + 8) * 2 + bm * 8 + extra
                 : bm * lda * 4 + 2 * kc * bn * 4 + bm * 8 + extra;
}

// The tile of a launch of `count` chained products (depth K[i], width N[i])
// over M rows.  bf16: 64 rows, 64 columns a chunk.  fp32: 32 to 512 columns
// a chunk (4096 / that many rows), the one whose padded work an SM takes,
// in whole waves of the blocks it holds, is least, among those that let an
// SM hold two blocks where any does (a second block hides the first's
// latencies), ring stages 32 deep where that fits as well, else 16.  lnb_c:
// the C of the fused LayerNorm backward, or 0.
inline GemmTile gemm_tile(const int* K, const int* N, int count, bool bf16_io, long long M,
                          int lnb_c) {
  const int extra = lnb_c ? lnb_smem(lnb_c) : 0;
  auto smem_of = [&](int bm, int bn, int kc) {
    int most = 0;
    for (int i = 0; i < count; ++i) {
      const int b = tile_smem(a_lda(K[i], bf16_io), bm, bn, kc, bf16_io, extra);
      if (b > most) most = b;
    }
    return most;
  };
  GemmTile g{};
  if (bf16_io) {
    g.bm = TC_BM;
    g.bn = TC_BN;
    g.kc = TC_KC;
    g.smem = smem_of(g.bm, g.bn, g.kc);
    return g;
  }
  const int most = GEMM_BLOCKS_PER_SM;
  long long best = -1;
  bool best_two = false;
  g.bn = 512;  // not kept inside the envelope: some chunk fits
  g.kc = F_KC / 2;
  for (int kc = F_KC; kc >= F_KC / 2; kc /= 2)
    for (int bn = 32; bn <= 512; bn *= 2) {
      const int bm = F_OUTPUTS / bn;
      const int smem = smem_of(bm, bn, kc);
      if (smem > wa_any::SMEM_PER_BLOCK) continue;
      int per_sm = wa_any::SMEM_PER_SM / (smem + wa_any::SMEM_RESERVED);
      if (per_sm > most) per_sm = most;
      const long long slots = static_cast<long long>(wa_any::SMS) * per_sm;
      const long long waves = ((M + bm - 1) / bm + slots - 1) / slots;
      long long cost = 0;
      for (int i = 0; i < count; ++i)
        cost += waves * per_sm * bm * static_cast<long long>(round_up(N[i], bn));
      const bool two = per_sm >= 2;
      if (best < 0 || (two && !best_two) || (two == best_two && cost < best)) {
        best = cost;
        best_two = two;
        g.bn = bn;
        g.kc = kc;
      }
    }
  g.bm = F_OUTPUTS / g.bn;
  g.smem = smem_of(g.bm, g.bn, g.kc);
  return g;
}

enum Epilogue { EPI_ROUND, EPI_RESID, EPI_GELU, EPI_DGELU, EPI_F32, EPI_LNB };

template <typename T>
struct GemmArgs {
  const void* a;
  int a_f32;  // A is fp32 (else T); rounded to T as it is staged
  int a_gather;  // A row t is image row image_row(t)
  const float* ln_g;  // LayerNorm of each A row first (with ln_b), if set
  const float* ln_b;
  T* a_store;  // the staged A rows, written in window order, if set
  const T* w;  // the prepared B, [kp][np]
  int np;
  const float* bias;  // added to the product, if set
  int epi;
  const T* res;  // EPI_RESID: out = round(res + round(acc + bias))
  int res_gather;
  const float* aux;  // EPI_DGELU: out = acc * gelu'(aux)
  void* out;  // T for EPI_ROUND, EPI_RESID, EPI_GELU; fp32 otherwise
  int out_scatter;  // out row t is image row image_row(t)
  float* out2;  // EPI_GELU: acc + bias (fp32), if set
  // EPI_LNB: the product (dn, fp32, into out) then each row's LayerNorm
  // backward: lnout = lnres + LN'(dn) of the LayerNorm whose input rows are
  // lnx with gain lng, and the block's fixed-order sums of (dn xhat, dn)
  // into lnpart[block][C][2]
  const T* lnx;
  int lnx_gather;
  const float* lng;
  const void* lnres;
  int lnres_f32;
  void* lnout;
  int lnout_f32;
  int lnout_scatter;
  float* lnpart;
  long long M;
  int K, N;
  int kp, lda;  // A's padded depth and row stride
  GemmTile g;
  long long tiles;  // of bm rows
  int tiles_per_block;  // consecutive tiles a block takes
  Geo geo;
};

// One output row's W consecutive columns n.. (n a multiple of W): bias,
// epilogue, store.  t is the window-order row, img its image row.
template <typename T, int W>
__device__ __forceinline__ void epilogue(const GemmArgs<T>& p, long long t, long long img, int n,
                                         float (&v)[W]) {
  const int N = p.N;
  const int valid = N - n;
  const bool vec = valid >= W && N % W == 0;
  if (p.bias) {
    float b[W];
    load_vals<W>(p.bias + n, b, vec, valid);
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] += b[e];
  }
  const long long orow = p.out_scatter ? img : t;
  switch (p.epi) {
    case EPI_ROUND:
      store_vals<W>(static_cast<T*>(p.out) + orow * N + n, v, vec, valid);
      break;
    case EPI_RESID: {
      float r[W];
      load_vals<W>(p.res + (p.res_gather ? img : t) * N + n, r, vec, valid);
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = r[e] + round_to<T>(v[e]);
      store_vals<W>(static_cast<T*>(p.out) + orow * N + n, v, vec, valid);
      break;
    }
    case EPI_GELU:
      if (p.out2) store_vals<W>(p.out2 + t * N + n, v, vec, valid);
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = v[e] * gelu_cdf(v[e]);
      store_vals<W>(static_cast<T*>(p.out) + orow * N + n, v, vec, valid);
      break;
    case EPI_DGELU: {  // in place over aux is safe: this thread reads, then writes
      float m[W];
      load_vals<W>(p.aux + t * N + n, m, vec, valid);
#pragma unroll
      for (int e = 0; e < W; ++e)
        v[e] *= gelu_cdf(m[e]) + m[e] * expf(-0.5f * m[e] * m[e]) / 2.50662827463100050f;
      store_vals<W>(static_cast<float*>(p.out) + orow * N + n, v, vec, valid);
      break;
    }
    default:
      store_vals<W>(static_cast<float*>(p.out) + orow * N + n, v, vec, valid);
  }
}

// Stages the block's A rows into As [bm][lda] in T: copied or rounded, zeros
// past K (to kp) and in the rows past M.
template <typename T>
__device__ void stage_a(const GemmArgs<T>& p, T* As, const long long* img_s, long long m0) {
  const int K = p.K, kp = p.kp, lda = p.lda, bm = p.g.bm;
  if (!p.a_f32 || sizeof(T) == 4) {  // A in T: copied
    const T* a = static_cast<const T*>(p.a);
    constexpr int V = 16 / sizeof(T);
    if (K % V == 0) {  // rows of whole 16-byte pieces: cp.async
      const int per = kp / V;
      for (int e = threadIdx.x; e < bm * per; e += GT) {
        const int r = e / per, c = e - r * per;
        const bool ok = img_s[r] >= 0 && c * V < K;
        const long long row = p.a_gather ? img_s[r] : m0 + r;
        cp_async16(As + r * lda + c * V, ok ? a + row * K + c * V : a, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < bm * kp; e += GT) {
        const int r = e / kp, k = e - r * kp;
        const long long row = p.a_gather ? img_s[r] : m0 + r;
        As[r * lda + k] = img_s[r] >= 0 && k < K ? a[row * K + k] : from_f<T>(0.0f);
      }
    }
    return;
  }
  // fp32 A rounded to bf16
  const float* a = static_cast<const float*>(p.a);
  if (K % 4 == 0) {
    const int per = kp / 4;
    for (int e = threadIdx.x; e < bm * per; e += GT) {
      const int r = e / per, c = e - r * per;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (img_s[r] >= 0 && c * 4 < K)
        load_vals<4>(a + (p.a_gather ? img_s[r] : m0 + r) * K + c * 4, v, true, 4);
      store_vals<4>(reinterpret_cast<bf16*>(As) + r * lda + c * 4, v, true, 4);
    }
  } else {
    for (int e = threadIdx.x; e < bm * kp; e += GT) {
      const int r = e / kp, k = e - r * kp;
      const long long row = p.a_gather ? img_s[r] : m0 + r;
      As[r * lda + k] = from_f<T>(img_s[r] >= 0 && k < K ? a[row * K + k] : 0.0f);
    }
  }
}

// Ring stage `it` of the (column chunk, depth slice) walk: kc rows of the
// prepared B, bn columns, into dst [kc][sld] (zeros past kp and np).
template <typename T>
__device__ __forceinline__ void load_b(const GemmArgs<T>& p, T* dst, int it, int kst, int bn,
                                       int kc, int sld) {
  constexpr int V = 16 / sizeof(T);
  const int chunk = it / kst, ks = it - chunk * kst;
  const int n0 = chunk * bn, k0 = ks * kc;
  const int per = bn / V;
  for (int e = threadIdx.x; e < kc * per; e += GT) {
    const int kk = e / per, c = e - kk * per;
    const int k = k0 + kk, n = n0 + c * V;
    const bool ok = k < p.kp && n < p.np;
    cp_async16(dst + kk * sld + c * V, ok ? p.w + static_cast<long long>(k) * p.np + n : p.w,
               ok ? 16 : 0);
  }
}

// The LayerNorm backward of a product block's rows (EPI_LNB), dn the
// product it just wrote: dln = rstd (dn g - mean(dn g) - xhat mean(dn g
// xhat)), lnout = lnres + dln.  A group of row_lanes(C) lanes takes a row,
// passing over it four times (statistics, the two means, the output; the
// later passes hit L1), and adds the row's (dn xhat, dn) to the group's own
// partials part_s[group] in a fixed order.
template <typename T>
__device__ void ln_backward_rows(const GemmArgs<T>& p, const long long* img_s, long long m0,
                                 float* part_s) {
  const int C = p.N, L = row_lanes(C), bm = p.g.bm;
  const int group = threadIdx.x / L, sl = threadIdx.x % L;
  const float* dnb = static_cast<const float*>(p.out);
  float* mine = part_s + group * 2 * C;
  for (int r0 = 0; r0 < bm; r0 += GT / L) {
    const int r = r0 + group;
    const bool ok = r < bm && img_s[r] >= 0;
    const long long t = m0 + r;
    const long long img = ok ? img_s[r] : 0;
    const T* x = p.lnx + (p.lnx_gather ? img : t) * C;
    const float* dn = dnb + t * C;
    float s = 0.0f;
    if (ok)
      for (int c = sl; c < C; c += L) s += to_f(x[c]);
    const float mean = group_sum(s, L) / C;
    float v = 0.0f;
    if (ok)
      for (int c = sl; c < C; c += L) {
        const float d = to_f(x[c]) - mean;
        v = fmaf(d, d, v);
      }
    const float rstd = 1.0f / sqrtf(group_sum(v, L) / C + LN_EPS);
    float s1 = 0.0f, s2 = 0.0f;
    if (ok)
      for (int c = sl; c < C; c += L) {
        const float dxh = dn[c] * __ldg(p.lng + c);
        s1 += dxh;
        s2 = fmaf(dxh, (to_f(x[c]) - mean) * rstd, s2);
      }
    const float m1 = group_sum(s1, L) / C, m2 = group_sum(s2, L) / C;
    if (!ok) continue;
    const long long orow = p.lnout_scatter ? img : t;
    for (int c = sl; c < C; c += L) {
      const float xhat = (to_f(x[c]) - mean) * rstd;
      const float dxh = dn[c] * __ldg(p.lng + c);
      const float dln = rstd * ((dxh - m1) - xhat * m2);
      const float res = p.lnres_f32 ? static_cast<const float*>(p.lnres)[t * C + c]
                                    : to_f(static_cast<const T*>(p.lnres)[t * C + c]);
      if (p.lnout_f32)
        static_cast<float*>(p.lnout)[orow * C + c] = res + dln;
      else
        static_cast<T*>(p.lnout)[orow * C + c] = from_f<T>(res + dln);
      mine[2 * c] = fmaf(dn[c], xhat, mine[2 * c]);
      mine[2 * c + 1] += dn[c];
    }
  }
}

// One tile of bm rows from m0: stage, normalize, walk the columns, and
// (EPI_LNB) the rows' LayerNorm backward; ends with the block synchronized.
template <typename T>
__device__ __forceinline__ void gemm_tile_body(const GemmArgs<T>& p, long long m0, T* As, T* ring,
                                               long long* img_s, float* part_s) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  const int bm = p.g.bm, lda = p.lda;
  const int bn = TC ? TC_BN : p.g.bn;
  const int kc = p.g.kc;
  const int sld = TC ? TC_BN + 8 : bn;  // a ring stage's row stride
  const int tid = threadIdx.x;
  const bool need_img =
      p.a_gather || p.res_gather || p.out_scatter || p.lnx_gather || p.lnout_scatter;
  for (int r = tid; r < bm; r += GT) {
    const long long t = m0 + r;
    img_s[r] = t < p.M ? (need_img ? image_row(t, p.geo) : t) : -1;
  }
  __syncthreads();
  const int kst = (p.kp + kc - 1) / kc;
  const int total = (p.N + bn - 1) / bn * kst;
  stage_a<T>(p, As, img_s, m0);
  load_b<T>(p, ring, 0, kst, bn, kc, sld);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (p.ln_g || p.a_store) {  // a group of lanes a row: two-pass fp32 statistics, in place
    const int K = p.K, L = row_lanes(K);
    const int lane = tid % 32, sl = lane % L;
    for (int r0 = (tid / 32) * (32 / L); r0 < bm; r0 += GT / L) {
      const int r = r0 + lane / L;
      const bool ok = r < bm && img_s[r] >= 0;
      T* row = As + r * lda;
      if (p.ln_g) {
        float s = 0.0f;
        if (ok)
          for (int k = sl; k < K; k += L) s += to_f(row[k]);
        const float mean = group_sum(s, L) / K;
        float v = 0.0f;
        if (ok)
          for (int k = sl; k < K; k += L) {
            const float d = to_f(row[k]) - mean;
            v = fmaf(d, d, v);
          }
        const float rstd = 1.0f / sqrtf(group_sum(v, L) / K + LN_EPS);
        if (ok)
          for (int k = sl; k < K; k += L)
            row[k] = from_f<T>(__fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(to_f(row[k]), mean), rstd), __ldg(p.ln_g + k)),
                __ldg(p.ln_b + k)));
      }
      if (p.a_store && ok) {
        T* dst = p.a_store + (m0 + r) * K;
        for (int k = sl; k < K; k += L) dst[k] = row[k];
      }
    }
    __syncthreads();
  }
  const int stage = kc * sld;
  if constexpr (TC) {
    const int warp = tid / 32, lane = tid & 31, wm = warp & 3, wn = warp >> 2;
    float acc[4][4];
    for (int it = 0; it < total; ++it) {
      const int chunk = it / kst, ks = it - chunk * kst;
      if (it + 1 < total) {
        load_b<T>(p, ring + ((it + 1) & 1) * stage, it + 1, kst, bn, kc, sld);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
      }
      const T* st = ring + (it & 1) * stage;
      const int col0 = chunk * bn + 32 * wn;
      const int steps = min(kc, p.kp - ks * kc) / 16;
      if (col0 < p.N) {
        for (int s = 0; s < steps; ++s) {
          uint32_t af[4];
          ldsm_x4(af, As + (16 * wm + (lane & 15)) * lda + ks * kc + 16 * s + (lane >> 4) * 8);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            if (col0 + 16 * jj < p.N) {
              uint32_t bf[4];
              ldsm_x4_trans(bf, st + (16 * s + (lane & 15)) * sld + 32 * wn + 16 * jj +
                                    (lane >> 4) * 8);
              mma_add(acc[2 * jj], af, bf[0], bf[1]);
              mma_add(acc[2 * jj + 1], af, bf[2], bf[3]);
            }
          }
        }
      }
      if (ks == kst - 1 && col0 < p.N) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = col0 + 8 * j + 2 * (lane & 3);
          if (n >= p.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wm + (lane >> 2) + 8 * h;
            if (img_s[r] < 0) continue;
            float v[2] = {acc[j][2 * h], acc[j][2 * h + 1]};
            epilogue<T, 2>(p, m0 + r, img_s[r], n, v);
          }
        }
      }
      __syncthreads();
    }
  } else {
    const int tgn = bn / 4, tgm = GT / tgn;  // bm = 4 tgm
    const int tn = tid % tgn, tm = tid / tgn;
    float acc[4][4];
    for (int it = 0; it < total; ++it) {
      const int chunk = it / kst, ks = it - chunk * kst;
      if (it + 1 < total) {
        load_b<T>(p, ring + ((it + 1) & 1) * stage, it + 1, kst, bn, kc, sld);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      const float* st = reinterpret_cast<const float*>(ring + (it & 1) * stage) + 4 * tn;
      const float* arow = reinterpret_cast<const float*>(As) + tm * lda + ks * kc;
      const int depth = min(kc, p.kp - ks * kc);
      for (int kk = 0; kk < depth; kk += 4) {
        float4 b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = *reinterpret_cast<const float4*>(st + (kk + q) * sld);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(arow + i * tgm * lda + kk);
          acc[i][0] = fmaf(a.x, b[0].x, acc[i][0]);
          acc[i][1] = fmaf(a.x, b[0].y, acc[i][1]);
          acc[i][2] = fmaf(a.x, b[0].z, acc[i][2]);
          acc[i][3] = fmaf(a.x, b[0].w, acc[i][3]);
          acc[i][0] = fmaf(a.y, b[1].x, acc[i][0]);
          acc[i][1] = fmaf(a.y, b[1].y, acc[i][1]);
          acc[i][2] = fmaf(a.y, b[1].z, acc[i][2]);
          acc[i][3] = fmaf(a.y, b[1].w, acc[i][3]);
          acc[i][0] = fmaf(a.z, b[2].x, acc[i][0]);
          acc[i][1] = fmaf(a.z, b[2].y, acc[i][1]);
          acc[i][2] = fmaf(a.z, b[2].z, acc[i][2]);
          acc[i][3] = fmaf(a.z, b[2].w, acc[i][3]);
          acc[i][0] = fmaf(a.w, b[3].x, acc[i][0]);
          acc[i][1] = fmaf(a.w, b[3].y, acc[i][1]);
          acc[i][2] = fmaf(a.w, b[3].z, acc[i][2]);
          acc[i][3] = fmaf(a.w, b[3].w, acc[i][3]);
        }
      }
      const int n = chunk * bn + 4 * tn;
      if (ks == kst - 1 && n < p.N) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tm + i * tgm;
          if (img_s[r] >= 0) epilogue<T, 4>(p, m0 + r, img_s[r], n, acc[i]);
        }
      }
      __syncthreads();
    }
  }
  if (p.epi == EPI_LNB) {
    ln_backward_rows<T>(p, img_s, m0, part_s);
    __syncthreads();
  }
}


// One launch of one product, or of two chained on the same tiles: the
// second reads rows the first wrote in the same block (the projection's h,
// read back by fc1 from L2).  They share the tile geometry; the staged rows
// take the deeper one's room.
template <typename T>
struct GemmLaunch {
  GemmArgs<T> p[2];
  int count;
};

template <typename T>
__global__ void __launch_bounds__(GT, GEMM_BLOCKS_PER_SM)
    swin_block_any_gemm_kernel(const GemmLaunch<T> q) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const GemmArgs<T>& p = q.p[0];
  const int bm = p.g.bm;
  const int kc = p.g.kc;
  const int sld = TC ? TC_BN + 8 : p.g.bn;  // a ring stage's row stride
  T* As = reinterpret_cast<T*>(smem);
  int lda = 0;  // the chain's deepest staged rows
  for (int i = 0; i < q.count; ++i) lda = q.p[i].lda > lda ? q.p[i].lda : lda;
  T* ring = As + bm * lda;
  long long* img_s = reinterpret_cast<long long*>(ring + 2 * kc * sld);
  float* part_s = reinterpret_cast<float*>(img_s + bm);  // EPI_LNB: [row group][C][2]
  const int tid = threadIdx.x;
  const bool lnb = p.epi == EPI_LNB;
  const int groups = GT / row_lanes(p.N);
  if (lnb)
    for (int e = tid; e < groups * 2 * p.N; e += GT) part_s[e] = 0.0f;
  const long long first = static_cast<long long>(blockIdx.x) * p.tiles_per_block;
  const long long last = first + p.tiles_per_block < p.tiles ? first + p.tiles_per_block : p.tiles;
  for (long long tile = first; tile < last; ++tile)
    for (int i = 0; i < q.count; ++i) gemm_tile_body<T>(q.p[i], tile * bm, As, ring, img_s, part_s);
  if (lnb) {  // the row groups' partials added in order
    for (int e = tid; e < 2 * p.N; e += GT) {
      float acc = 0.0f;
      for (int g = 0; g < groups; ++g) acc += part_s[g * 2 * p.N + e];
      p.lnpart[blockIdx.x * 2ll * p.N + e] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// The weights prepared once per call: dst[j] [kp][np] in T, B(k, n) =
// round(w[n][k]) (an nn.Linear weight read transposed) or round(w[k][n])
// ---------------------------------------------------------------------------

struct PrepArgs {
  const float* w[PREP_MATS];
  void* dst[PREP_MATS];
  int K[PREP_MATS], N[PREP_MATS], kp[PREP_MATS], np[PREP_MATS], trans[PREP_MATS];
  long long first[PREP_MATS + 1];  // each matrix's first element in the launch
  int count;
};

template <typename T>
__global__ void __launch_bounds__(GT) swin_block_any_prep_kernel(const PrepArgs a) {
  const long long end = a.first[a.count];
  for (long long e = static_cast<long long>(blockIdx.x) * GT + threadIdx.x; e < end;
       e += static_cast<long long>(gridDim.x) * GT) {
    int j = 0;
    while (j + 1 < a.count && e >= a.first[j + 1]) ++j;
    const long long i = e - a.first[j];
    const int k = static_cast<int>(i / a.np[j]), n = static_cast<int>(i - k * a.np[j]);
    float v = 0.0f;
    if (k < a.K[j] && n < a.N[j])
      v = __ldg(a.w[j] + (a.trans[j] ? static_cast<long long>(n) * a.K[j] + k
                                     : static_cast<long long>(k) * a.N[j] + n));
    static_cast<T*>(a.dst[j])[i] = from_f<T>(v);
  }
}

// ---------------------------------------------------------------------------
// The weight products: part[split][a][b] = sum over the split's tokens of
// L[t][a] R[t][b], with R[t][k] = 1 (the bias vector's column)
// ---------------------------------------------------------------------------

struct WeightJob {
  const void* l;
  const void* r;
  float* part;
  int n, k;  // L's and R's widths
  int l_f32;
  int tiles_k, tiles;
};

struct WeightArgs {
  WeightJob job[4];
  long long M;
  long long tokens_per_split;
};

// Stages tokens tt.. (WK of them, zeros past t1) of columns col0.. (WT of
// them) of a token-major operand of `width` columns into dst [WK][ld] in E:
// 16-byte cp.async copies where a piece lies inside the row, element copies
// elsewhere, the ones column (ones) at column `width`.
template <typename E, int WK>
__device__ __forceinline__ void stage_tokens(E* dst, int ld, const E* src, int width, int col0,
                                             long long tt, long long t1, bool ones) {
  constexpr int V = 16 / sizeof(E);
  for (int e = threadIdx.x; e < WK * (WT / V); e += GT) {
    const int tk = e / (WT / V), c = V * (e % (WT / V));
    const long long t = tt + tk;
    const bool row_ok = t < t1;
    const int col = col0 + c;
    E* d = dst + tk * ld + c;
    if (width % V == 0 && col + V <= width) {
      cp_async16(d, row_ok ? src + t * width + col : src, row_ok ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        float v = 0.0f;
        if (row_ok) v = col + q < width ? to_f(src[t * width + col + q]) : ones && col + q == width;
        d[q] = from_f<E>(v);
      }
    }
  }
}

// bf16 L and R: tensor cores, a two-stage cp.async ring of WKT tokens.
// Warp w: a rows 16 (w % 4).., b columns 32 (w / 4).., four m16n8
// accumulators.
__device__ void weights_tc(const WeightJob& jb, long long t0, long long t1, int a0, int b0,
                           float* part, unsigned char* sm) {
  constexpr int STAGE = 2 * WKT * WLD;  // L then R, token-major
  bf16* ring = reinterpret_cast<bf16*>(sm);
  const bf16* L = static_cast<const bf16*>(jb.l);
  const bf16* R = static_cast<const bf16*>(jb.r);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31, wa = warp & 3, wb = warp >> 2;
  float acc[4][4] = {};
  const int n_st = static_cast<int>((t1 - t0 + WKT - 1) / WKT);
  auto load_stage = [&](int i) {
    bf16* st = ring + (i & 1) * STAGE;
    const long long tt = t0 + static_cast<long long>(i) * WKT;
    stage_tokens<bf16, WKT>(st, WLD, L, jb.n, a0, tt, t1, false);
    stage_tokens<bf16, WKT>(st + WKT * WLD, WLD, R, jb.k, b0, tt, t1, true);
    cp_async_commit();
  };
  if (n_st > 0) load_stage(0);
  for (int i = 0; i < n_st; ++i) {
    if (i + 1 < n_st) {
      load_stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ls = ring + (i & 1) * STAGE;
    const bf16* Rs = Ls + WKT * WLD;
#pragma unroll
    for (int s = 0; s < WKT / 16; ++s) {
      uint32_t af[4];
      ldsm_x4_trans(af, Ls + (16 * s + (lane & 7) + 8 * (lane >> 4)) * WLD + 16 * wa +
                            8 * ((lane >> 3) & 1));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, Rs + (16 * s + (lane & 15)) * WLD + 32 * wb + 16 * jj + 8 * (lane >> 4));
        mma_add(acc[2 * jj], af, bf[0], bf[1]);
        mma_add(acc[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  const int width = jb.k + 1;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int a = a0 + 16 * wa + (lane >> 2) + 8 * (q >> 1);
      const int b = b0 + 32 * wb + 8 * j + 2 * (lane & 3) + (q & 1);
      if (a < jb.n && b < width) part[static_cast<long long>(a) * width + b] = acc[j][q];
    }
}

// fp32 L (and R in TR): CUDA cores, a two-stage cp.async ring of WKT_F
// tokens; thread (ty, tx) the 4 x 4 outputs a rows 4 ty.., b columns
// 4 tx.., from float4 reads of L and four values of R.
template <typename TR>
__device__ void weights_fp32(const WeightJob& jb, long long t0, long long t1, int a0, int b0,
                             float* part, unsigned char* sm) {
  constexpr int STAGE = WKT_F * WT * 4 + WKT_F * WT * sizeof(TR);  // bytes: L fp32, then R
  const float* L = static_cast<const float*>(jb.l);
  const TR* R = static_cast<const TR*>(jb.r);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  const int n_st = static_cast<int>((t1 - t0 + WKT_F - 1) / WKT_F);
  auto load_stage = [&](int i) {
    unsigned char* st = sm + (i & 1) * STAGE;
    const long long tt = t0 + static_cast<long long>(i) * WKT_F;
    stage_tokens<float, WKT_F>(reinterpret_cast<float*>(st), WT, L, jb.n, a0, tt, t1, false);
    stage_tokens<TR, WKT_F>(reinterpret_cast<TR*>(st + WKT_F * WT * 4), WT, R, jb.k, b0, tt, t1,
                            true);
    cp_async_commit();
  };
  if (n_st > 0) load_stage(0);
  for (int i = 0; i < n_st; ++i) {
    if (i + 1 < n_st) {
      load_stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ls = reinterpret_cast<const float*>(sm + (i & 1) * STAGE);
    const TR* Rs = reinterpret_cast<const TR*>(sm + (i & 1) * STAGE + WKT_F * WT * 4);
#pragma unroll 8
    for (int tk = 0; tk < WKT_F; ++tk) {
      const float4 l = *reinterpret_cast<const float4*>(Ls + tk * WT + 4 * ty);
      float rv[4];
      load_vals<4>(Rs + tk * WT + 4 * tx, rv, true, 4);
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(lv[a], rv[b], acc[a][b]);
    }
    __syncthreads();
  }
  const int width = jb.k + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + 4 * ty + i;
    if (a >= jb.n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + 4 * tx + j;
      if (b < width) part[static_cast<long long>(a) * width + b] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GT) swin_block_any_weights_kernel(const WeightArgs a) {
  const WeightJob& jb = a.job[blockIdx.z];
  if (static_cast<int>(blockIdx.x) >= jb.tiles) return;
  __shared__ __align__(16) unsigned char sm[WEIGHT_SMEM];
  const int tn = blockIdx.x / jb.tiles_k, tk = blockIdx.x - tn * jb.tiles_k;
  const long long t0 = blockIdx.y * a.tokens_per_split;
  const long long t1 = t0 + a.tokens_per_split < a.M ? t0 + a.tokens_per_split : a.M;
  float* part = jb.part + static_cast<long long>(blockIdx.y) * jb.n * (jb.k + 1);
  if constexpr (std::is_same<T, bf16>::value) {
    if (!jb.l_f32)
      weights_tc(jb, t0, t1, tn * WT, tk * WT, part, sm);
    else
      weights_fp32<bf16>(jb, t0, t1, tn * WT, tk * WT, part, sm);
  } else {
    weights_fp32<float>(jb, t0, t1, tn * WT, tk * WT, part, sm);
  }
}

// ---------------------------------------------------------------------------
// The plan: everything a launch needs, from the shapes alone
// (ops/swin_block.py::_generic_plan mirrors it)
// ---------------------------------------------------------------------------

enum Scratch { S_W, S_N1, S_QKV, S_AO, S_H, S_N2, S_M1, S_GM, S_DY, S_DN, S_DH, S_DAO, S_DQKV,
               S_WPART, S_LNPART, S_BPART, S_COUNT };
enum FwdScratch { F_W, F_QKV, F_AO, F_H, F_GM, F_COUNT };
// the prepared matrices: the forward's (W^T) then the backward's own (W)
enum Mat { M_QKV, M_PROJ, M_FC1, M_FC2, M_DM1, M_DN2, M_DAO, M_DN1 };
// the product launches (the projection and fc1 chained in one)
enum Launch { L_QKV, L_PROJ_FC1, L_FC2, L_DM1, L_DN2, L_DAO, L_DN1, L_COUNT };

struct BlockPlan {
  long long M;  // tokens
  int N, Bn, nW, hd;
  long long tokens_per_split;
  int splits;
  int wn[4], wk[4], wtiles_k[4], wtiles[4], wtiles_max;
  long long reduce_blocks;
  wa_any::Plan att_fwd, att_bwd;
  GemmTile tile[L_COUNT];  // each product launch's
  int ln_blocks2, ln_blocks1;  // dn2's and dn1's blocks, each a fixed range of tiles
  int ln_tpb2, ln_tpb1;
  int mk[PREP_MATS], mn[PREP_MATS], mkp[PREP_MATS], mnp[PREP_MATS];
  long long moff[PREP_MATS];  // byte offsets in the prepared weights' buffer
  long long prep_bytes[2];  // the buffer: the forward's 4 matrices, or all 8
  long long prep_elems[2];
  int prep_blocks[2];
  long long fwd_off[F_COUNT + 1];  // [F_COUNT] = total bytes
  long long bwd_off[S_COUNT + 1];  // [S_COUNT] = total bytes
};

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

// A product with the fused LayerNorm backward: at most LN_MAX_BLOCKS blocks,
// each the same number of consecutive tiles of bm rows (the last fewer).
inline void ln_range(long long M, int bm, int* blocks, int* tiles_per_block) {
  const long long tiles = (M + bm - 1) / bm;
  long long b = tiles < LN_MAX_BLOCKS ? tiles : LN_MAX_BLOCKS;
  const long long per = (tiles + b - 1) / b;
  *tiles_per_block = static_cast<int>(per);
  *blocks = static_cast<int>((tiles + per - 1) / per);
}

inline bool valid(int B, int H, int W, int C, int heads, int hidden, int ws, int shift) {
  return B >= 1 && ws >= 1 && ws <= MAX_WS && H % ws == 0 && W % ws == 0 && H > 0 && W > 0 &&
         heads >= 1 && C % heads == 0 && C / heads <= wa_any::MAX_HD && C <= MAX_C &&
         hidden >= 1 && hidden <= 4 * C && shift >= 0 && shift < ws;
}

inline BlockPlan make_plan(int B, int H, int W, int C, int heads, int hidden, int ws,
                           int itemsize) {
  BlockPlan p{};
  const bool bf16_io = itemsize == 2;
  p.M = static_cast<long long>(B) * H * W;
  p.N = ws * ws;
  p.Bn = static_cast<int>(p.M / p.N);
  p.nW = (H / ws) * (W / ws);
  p.hd = C / heads;
  p.att_fwd = wa_any::make_plan(p.Bn, p.N, p.hd, heads, itemsize, false);
  p.att_bwd = wa_any::make_plan(p.Bn, p.N, p.hd, heads, itemsize, true);
  // the prepared weights: (K, N) of each product's B
  const int mk[PREP_MATS] = {C, C, C, hidden, C, hidden, C, 3 * C};
  const int mn[PREP_MATS] = {3 * C, C, hidden, C, hidden, C, C, C};
  {
    const int mats[L_COUNT][2] = {{M_QKV}, {M_PROJ, M_FC1}, {M_FC2}, {M_DM1},
                                  {M_DN2}, {M_DAO}, {M_DN1}};
    const int counts[L_COUNT] = {1, 2, 1, 1, 1, 1, 1};
    for (int l = 0; l < L_COUNT; ++l) {
      int K[2], N[2];
      for (int i = 0; i < counts[l]; ++i) {
        K[i] = mk[mats[l][i]];
        N[i] = mn[mats[l][i]];
      }
      p.tile[l] = gemm_tile(K, N, counts[l], bf16_io, p.M, l == L_DN2 || l == L_DN1 ? C : 0);
    }
  }
  ln_range(p.M, p.tile[L_DN2].bm, &p.ln_blocks2, &p.ln_tpb2);
  ln_range(p.M, p.tile[L_DN1].bm, &p.ln_blocks1, &p.ln_tpb1);
  long long off = 0;
  for (int j = 0; j < PREP_MATS; ++j) {
    p.mk[j] = mk[j];
    p.mn[j] = mn[j];
    p.mkp[j] = round_up(mk[j], bf16_io ? 16 : 4);
    p.mnp[j] = round_up(mn[j], 8);
    p.moff[j] = off;
    off += align256(static_cast<long long>(p.mkp[j]) * p.mnp[j] * itemsize);
    if (j == 3 || j == 7) {
      const int w = j == 3 ? 0 : 1;
      p.prep_bytes[w] = off;
      long long elems = 0;
      for (int i = 0; i <= j; ++i) elems += static_cast<long long>(p.mkp[i]) * p.mnp[i];
      p.prep_elems[w] = elems;
      long long blocks = (elems + GT - 1) / GT;
      if (blocks > PREP_MAX_BLOCKS) blocks = PREP_MAX_BLOCKS;
      p.prep_blocks[w] = static_cast<int>(blocks);
    }
  }
  // the weight products: w2 (C x hidden), w1 (hidden x C), wp (C x C), wq (3C x C)
  const int wn[4] = {C, hidden, C, 3 * C}, wk[4] = {hidden, C, C, C};
  int tiles = 0;
  p.wtiles_max = 0;
  for (int j = 0; j < 4; ++j) {
    p.wn[j] = wn[j];
    p.wk[j] = wk[j];
    p.wtiles_k[j] = (wk[j] + 1 + WT - 1) / WT;
    p.wtiles[j] = (wn[j] + WT - 1) / WT * p.wtiles_k[j];
    tiles += p.wtiles[j];
    if (p.wtiles[j] > p.wtiles_max) p.wtiles_max = p.wtiles[j];
  }
  long long splits = static_cast<long long>(wa_any::SMS) * WEIGHT_BLOCKS_PER_SM / tiles;
  const long long most = (p.M + 255) / 256;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  p.tokens_per_split = (p.M + splits - 1) / splits;
  p.splits = static_cast<int>((p.M + p.tokens_per_split - 1) / p.tokens_per_split);
  long long part = 0;  // floats of one split's weight partials
  for (int j = 0; j < 4; ++j) part += static_cast<long long>(wn[j]) * (wk[j] + 1);
  const long long elems[7] = {
      static_cast<long long>(wn[0]) * (wk[0] + 1), static_cast<long long>(wn[1]) * (wk[1] + 1),
      static_cast<long long>(wn[2]) * (wk[2] + 1), static_cast<long long>(wn[3]) * (wk[3] + 1),
      2ll * C, 2ll * C, static_cast<long long>(heads) * p.N * p.N};
  p.reduce_blocks = wa_any::reduce_blocks(elems, 7);
  const long long M = p.M;
  const long long it = itemsize;
  const long long fwd[F_COUNT] = {p.prep_bytes[0], it * M * 3 * C, it * M * C, it * M * C,
                                  it * M * hidden};
  off = 0;
  for (int i = 0; i < F_COUNT; ++i) {
    p.fwd_off[i] = off;
    off += align256(fwd[i]);
  }
  p.fwd_off[F_COUNT] = off;
  const long long bwd[S_COUNT] = {
      p.prep_bytes[1],  // the prepared weights
      it * M * C, it * M * 3 * C, it * M * C, it * M * C, it * M * C,  // n1 qkv ao h n2
      4 * M * hidden, it * M * hidden, it * M * C,  // m1 (then dm1), gm, dy in window order
      4 * M * C, 4 * M * C, it * M * C, it * M * 3 * C,  // dn, dh, dao, dqkv
      4 * p.splits * part,  // the weight partials
      4 * 2ll * C * (p.ln_blocks2 + p.ln_blocks1),  // the LayerNorm partials
      4ll * p.att_bwd.partials * heads * p.N * p.N};  // dbias slabs
  off = 0;
  for (int i = 0; i < S_COUNT; ++i) {
    p.bwd_off[i] = off;
    off += align256(bwd[i]);
  }
  p.bwd_off[S_COUNT] = off;
  return p;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

enum Param { G1, B1, WQ, BQ, BIAS, WP, BP, G2, B2, W1, C1, W2, C2 };

// the preparing launch: the first 4 matrices (the forward) or all 8
template <typename T>
cudaError_t prepare_weights(const float* const* w, char* buf, const BlockPlan& p, bool backward,
                            cudaStream_t s) {
  const float* src[PREP_MATS] = {w[WQ], w[WP], w[W1], w[W2], w[W2], w[W1], w[WP], w[WQ]};
  PrepArgs a{};
  a.count = backward ? 8 : 4;
  long long first = 0;
  for (int j = 0; j < a.count; ++j) {
    a.w[j] = src[j];
    a.dst[j] = buf + p.moff[j];
    a.K[j] = p.mk[j];
    a.N[j] = p.mn[j];
    a.kp[j] = p.mkp[j];
    a.np[j] = p.mnp[j];
    a.trans[j] = j < 4;
    a.first[j] = first;
    first += static_cast<long long>(p.mkp[j]) * p.mnp[j];
  }
  a.first[a.count] = first;
  swin_block_any_prep_kernel<T><<<p.prep_blocks[backward ? 1 : 0], GT, 0, s>>>(a);
  return cudaGetLastError();
}

// Launches a (and then b on the same tiles, where given).
template <typename T>
cudaError_t gemm(const GemmArgs<T>& a, cudaStream_t stream, const GemmArgs<T>* b = nullptr) {
  constexpr auto kernel = swin_block_any_gemm_kernel<T>;
  const cudaError_t err = wa_any::prepare<kernel>();
  if (err != cudaSuccess) return err;
  GemmLaunch<T> q{};
  q.p[0] = a;
  q.count = 1;
  if (b) q.p[q.count++] = *b;
  for (int i = 0; i < q.count; ++i) q.p[i].tiles = (a.M + a.g.bm - 1) / a.g.bm;
  const long long blocks = (q.p[0].tiles + a.tiles_per_block - 1) / a.tiles_per_block;
  kernel<<<static_cast<unsigned>(blocks), GT, a.g.smem, stream>>>(q);
  return cudaGetLastError();
}

template <typename T>
GemmArgs<T> gemm_args(const void* a, int K, const char* wbuf, int mat, int launch, void* out,
                      int epi, const BlockPlan& p, const Geo& geo) {
  GemmArgs<T> g{};
  g.a = a;
  g.K = K;
  g.kp = a_kp(K, sizeof(T) == 2);
  g.lda = a_lda(K, sizeof(T) == 2);
  g.w = reinterpret_cast<const T*>(wbuf + p.moff[mat]);
  g.np = p.mnp[mat];
  g.N = p.mn[mat];
  g.epi = epi;
  g.out = out;
  g.M = p.M;
  g.g = p.tile[launch];
  g.tiles_per_block = launch == L_DN1 ? p.ln_tpb1 : launch == L_DN2 ? p.ln_tpb2 : 1;
  g.geo = geo;
  return g;
}

// The forward's first launches (recomputed by the backward): qkv (n1 kept
// where set) and the attention.
template <typename T>
cudaError_t qkv_attention(const T* x, const float* const* w, const float* mask, const char* wbuf,
                          T* n1, T* qkv, T* ao, const BlockPlan& p, const Geo& geo, int C,
                          int heads, float scale_io, cudaStream_t s) {
  auto a = gemm_args<T>(x, C, wbuf, M_QKV, L_QKV, qkv, EPI_ROUND, p, geo);
  a.a_gather = 1;
  a.ln_g = w[G1];
  a.ln_b = w[B1];
  a.a_store = n1;
  a.bias = w[BQ];
  const cudaError_t err = gemm(a, s);
  if (err != cudaSuccess) return err;
  return wa_any::forward<T>(qkv, w[BIAS], mask, ao, p.Bn, p.N, C, heads, p.nW, scale_io, s);
}

// The projection (h = x + round(ao Wp + bp)) and LN2 fused into fc1 (gm, n2
// and m1 kept where set) on the rows of h the same block wrote.
template <typename T>
void proj_fc1_args(const T* x, const float* const* w, const char* wbuf, const T* ao, T* h, T* n2,
                   float* m1, T* gm, int launch, const BlockPlan& p, const Geo& geo, int C,
                   int hidden, GemmArgs<T>* proj, GemmArgs<T>* fc1) {
  *proj = gemm_args<T>(ao, C, wbuf, M_PROJ, launch, h, EPI_RESID, p, geo);
  proj->bias = w[BP];
  proj->res = x;
  proj->res_gather = 1;
  *fc1 = gemm_args<T>(h, C, wbuf, M_FC1, launch, gm, EPI_GELU, p, geo);
  fc1->ln_g = w[G2];
  fc1->ln_b = w[B2];
  fc1->a_store = n2;
  fc1->bias = w[C1];
  fc1->out2 = m1;
}

template <typename T>
cudaError_t block_forward(const T* x, T* y, const float* const* w, const float* mask,
                          char* scratch, const BlockPlan& p, const Geo& geo, int C, int heads,
                          int hidden, float scale_io, cudaStream_t s) {
  char* wbuf = scratch + p.fwd_off[F_W];
  T* qkv = reinterpret_cast<T*>(scratch + p.fwd_off[F_QKV]);
  T* ao = reinterpret_cast<T*>(scratch + p.fwd_off[F_AO]);
  T* h = reinterpret_cast<T*>(scratch + p.fwd_off[F_H]);
  T* gm = reinterpret_cast<T*>(scratch + p.fwd_off[F_GM]);
  cudaError_t err = prepare_weights<T>(w, wbuf, p, false, s);
  if (err != cudaSuccess) return err;
  err = qkv_attention<T>(x, w, mask, wbuf, nullptr, qkv, ao, p, geo, C, heads, scale_io, s);
  if (err != cudaSuccess) return err;
  GemmArgs<T> proj, fc1;
  proj_fc1_args<T>(x, w, wbuf, ao, h, nullptr, nullptr, gm, L_PROJ_FC1, p, geo, C, hidden, &proj,
                   &fc1);
  if ((err = gemm(proj, s, &fc1)) != cudaSuccess) return err;
  // y = round(h + round(gm W2 + c2)), scattered
  auto fc2 = gemm_args<T>(gm, hidden, wbuf, M_FC2, L_FC2, y, EPI_RESID, p, geo);
  fc2.bias = w[C2];
  fc2.res = h;
  fc2.out_scatter = 1;
  return gemm(fc2, s);
}

template <typename T>
cudaError_t block_backward(const T* x, const T* dy, T* dx, const float* const* w,
                           const float* mask, float* const* grads, char* scratch,
                           const BlockPlan& p, const Geo& geo, int C, int heads, int hidden,
                           float scale_io, float scale, cudaStream_t s) {
  auto buf = [&](int i) { return scratch + p.bwd_off[i]; };
  const char* wbuf = buf(S_W);
  T* n1 = reinterpret_cast<T*>(buf(S_N1));
  T* qkv = reinterpret_cast<T*>(buf(S_QKV));
  T* ao = reinterpret_cast<T*>(buf(S_AO));
  T* h = reinterpret_cast<T*>(buf(S_H));
  T* n2 = reinterpret_cast<T*>(buf(S_N2));
  float* m1 = reinterpret_cast<float*>(buf(S_M1));
  T* gm = reinterpret_cast<T*>(buf(S_GM));
  T* dyw = reinterpret_cast<T*>(buf(S_DY));
  float* dn = reinterpret_cast<float*>(buf(S_DN));
  float* dh = reinterpret_cast<float*>(buf(S_DH));
  T* dao = reinterpret_cast<T*>(buf(S_DAO));
  T* dqkv = reinterpret_cast<T*>(buf(S_DQKV));
  float* wpart = reinterpret_cast<float*>(buf(S_WPART));
  float* lnpart = reinterpret_cast<float*>(buf(S_LNPART));
  float* bpart = reinterpret_cast<float*>(buf(S_BPART));
  cudaError_t err = prepare_weights<T>(w, buf(S_W), p, true, s);
  if (err != cudaSuccess) return err;
  err = qkv_attention<T>(x, w, mask, wbuf, n1, qkv, ao, p, geo, C, heads, scale_io, s);
  if (err != cudaSuccess) return err;
  GemmArgs<T> proj, fc1;
  proj_fc1_args<T>(x, w, wbuf, ao, h, n2, m1, gm, L_PROJ_FC1, p, geo, C, hidden, &proj, &fc1);
  if ((err = gemm(proj, s, &fc1)) != cudaSuccess) return err;
  // dm1 = (dy round(W2)) gelu'(m1), over m1 in place; dy kept in window order
  auto a = gemm_args<T>(dy, C, wbuf, M_DM1, L_DM1, m1, EPI_DGELU, p, geo);
  a.a_gather = 1;
  a.a_store = dyw;
  a.aux = m1;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  // dn2 = round(dm1) round(W1), then dh = dy + LN2'(dn2)
  a = gemm_args<T>(m1, hidden, wbuf, M_DN2, L_DN2, dn, EPI_LNB, p, geo);
  a.a_f32 = 1;
  a.lnx = h;
  a.lng = w[G2];
  a.lnres = dyw;
  a.lnout = dh;
  a.lnout_f32 = 1;
  a.lnpart = lnpart;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  // dao = round(round(dh) round(Wp))
  a = gemm_args<T>(dh, C, wbuf, M_DAO, L_DAO, dao, EPI_ROUND, p, geo);
  a.a_f32 = 1;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  err = wa_any::backward<T>(qkv, w[BIAS], mask, dao, dqkv, bpart, p.Bn, p.N, C, heads, p.nW,
                            scale_io, scale, s);
  if (err != cudaSuccess) return err;
  // dn1 = dqkv round(Wq), then dx = round(dh + LN1'(dn1)), scattered
  a = gemm_args<T>(dqkv, 3 * C, wbuf, M_DN1, L_DN1, dn, EPI_LNB, p, geo);
  a.lnx = x;
  a.lnx_gather = 1;
  a.lng = w[G1];
  a.lnres = dh;
  a.lnres_f32 = 1;
  a.lnout = dx;
  a.lnout_scatter = 1;
  a.lnpart = lnpart + 2ll * p.ln_blocks2 * C;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  // the weight products: (dy, gm) -> W2, c2; (dm1, n2) -> W1, c1; (dh, ao) -> Wp,
  // bp; (dqkv, n1) -> Wq, bq
  WeightArgs wa{};
  const void* ls[4] = {dyw, m1, dh, dqkv};
  const void* rs[4] = {gm, n2, ao, n1};
  const int lf[4] = {0, 1, 1, 0};
  float* parts[4];
  float* cur = wpart;
  for (int j = 0; j < 4; ++j) {
    parts[j] = cur;
    wa.job[j] = {ls[j], rs[j], cur, p.wn[j], p.wk[j], lf[j], p.wtiles_k[j], p.wtiles[j]};
    cur += static_cast<long long>(p.splits) * p.wn[j] * (p.wk[j] + 1);
  }
  wa.M = p.M;
  wa.tokens_per_split = p.tokens_per_split;
  swin_block_any_weights_kernel<T><<<dim3(p.wtiles_max, p.splits, 4), GT, 0, s>>>(wa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // one reduction of every family, into the gradients
  wa_any::Segments ss{};
  const int dst0[4] = {W2, W1, WP, WQ}, dst1[4] = {C2, C1, BP, BQ};
  for (int j = 0; j < 4; ++j) {
    const long long width = p.wn[j] * (p.wk[j] + 1ll);
    ss.s[j] = {parts[j], grads[dst0[j]], grads[dst1[j]], p.wn[j], width, p.wk[j], p.splits, 0};
  }
  ss.s[4] = {lnpart, grads[G2], grads[B2], C, 2ll * C, 1, p.ln_blocks2, 0};
  ss.s[5] = {lnpart + 2ll * p.ln_blocks2 * C, grads[G1], grads[B1], C, 2ll * C, 1, p.ln_blocks1,
             0};
  const long long nn = static_cast<long long>(heads) * p.N * p.N;
  ss.s[6] = {bpart, nullptr, grads[BIAS], nn, nn, 0, p.att_bwd.partials, 0};
  ss.count = 7;
  return wa_any::launch_reduce(ss, s);
}


// (grid x, y, z, threads, dynamic shared memory) of each launch, in order.
void launches(const BlockPlan& p, bool backward, int* out) {
  auto set = [](int* o, int x, int y, int z, int t, int smem) {
    o[0] = x;
    o[1] = y;
    o[2] = z;
    o[3] = t;
    o[4] = smem;
  };
  auto gemm_grid = [&](const GemmTile& g, int* o) {
    set(o, static_cast<int>((p.M + g.bm - 1) / g.bm), 1, 1, GT, g.smem);
  };
  int i = 0;
  set(out + 5 * i++, p.prep_blocks[backward ? 1 : 0], 1, 1, GT, 0);
  gemm_grid(p.tile[L_QKV], out + 5 * i++);
  set(out + 5 * i++, p.att_fwd.grid_x, p.att_fwd.grid_y, 1, p.att_fwd.threads, p.att_fwd.smem);
  gemm_grid(p.tile[L_PROJ_FC1], out + 5 * i++);  // the projection and fc1
  if (!backward) {
    gemm_grid(p.tile[L_FC2], out + 5 * i++);
    return;
  }
  gemm_grid(p.tile[L_DM1], out + 5 * i++);
  set(out + 5 * i++, p.ln_blocks2, 1, 1, GT, p.tile[L_DN2].smem);  // dn2 and LN2'
  gemm_grid(p.tile[L_DAO], out + 5 * i++);
  set(out + 5 * i++, p.att_bwd.grid_x, p.att_bwd.grid_y, 1, p.att_bwd.threads, p.att_bwd.smem);
  set(out + 5 * i++, p.ln_blocks1, 1, 1, GT, p.tile[L_DN1].smem);  // dn1 and LN1'
  set(out + 5 * i++, p.wtiles_max, p.splits, 4, GT, 0);
  set(out + 5 * i++, static_cast<int>(p.reduce_blocks), 1, 1, wa_any::THREADS, 0);
}

}  // namespace

// x and y (B, H, W, C) fp32 or bf16, contiguous; params the 13 fp32 pointers in
// ops/swin_block.py's PARAM_NAMES order (the port's layout: Linear weights
// (out, in); bias (heads, N, N)); mask (nW, N, N) fp32 or null; scratch of
// the size dmh_swin_block_any_scratch_layout(backward = 0) gives.  Launches
// the five kernels on `stream` and returns the first error (0 = launched).
extern "C" int dmh_swin_block_any_fwd(const void* x, void* y, const float* const* params,
                                      const float* mask, void* scratch, long long nbytes, int B,
                                      int H, int W, int C, int heads, int hidden, int ws,
                                      int shift, float scale_io, int is_bf16, void* stream) {
  if (!valid(B, H, W, C, heads, hidden, ws, shift)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  if (nbytes < p.fwd_off[F_COUNT] || !wa_any::plan_fits(p.att_fwd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo geo{B, H, W, ws, shift, p.M < (1ll << 31)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (is_bf16)
    return static_cast<int>(block_forward<bf16>(static_cast<const bf16*>(x),
                                                static_cast<bf16*>(y), params, mask, sc, p, geo,
                                                C, heads, hidden, scale_io, s));
  return static_cast<int>(block_forward<float>(static_cast<const float*>(x),
                                               static_cast<float*>(y), params, mask, sc, p, geo,
                                               C, heads, hidden, scale_io, s));
}

// The forward's arguments, plus dy and dx (B, H, W, C) in the dtype of x, the
// 13 fp32 gradients (each written whole) in PARAM_NAMES order, scratch of the
// size dmh_swin_block_any_scratch_layout(backward = 1) gives, scale = hd^-0.5
// in fp32.  Launches the eleven kernels on `stream`.
extern "C" int dmh_swin_block_any_bwd(const void* x, const void* dy, void* dx,
                                      const float* const* params, const float* mask,
                                      float* const* grads, void* scratch, long long nbytes,
                                      int B, int H, int W, int C, int heads, int hidden, int ws,
                                      int shift, float scale_io, float scale, int is_bf16,
                                      void* stream) {
  if (!valid(B, H, W, C, heads, hidden, ws, shift)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  if (nbytes < p.bwd_off[S_COUNT] || !wa_any::plan_fits(p.att_fwd) ||
      !wa_any::plan_fits(p.att_bwd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo geo{B, H, W, ws, shift, p.M < (1ll << 31)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (is_bf16)
    return static_cast<int>(block_backward<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<bf16*>(dx), params,
        mask, grads, sc, p, geo, C, heads, hidden, scale_io, scale, s));
  return static_cast<int>(block_backward<float>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx),
      params, mask, grads, sc, p, geo, C, heads, hidden, scale_io, scale, s));
}

// The scratch the forward (backward = 0: the prepared weights, qkv, ao, h,
// gm and the total) or the backward (the prepared weights, n1, qkv, ao, h,
// n2, m1, gm, dy, dn, dh, dao, dqkv, the weight, LayerNorm and dbias
// partials, and the total) carves: byte offsets into out.
extern "C" int dmh_swin_block_any_scratch_layout(int B, int H, int W, int C, int heads,
                                                 int hidden, int ws, int is_bf16, int backward,
                                                 long long* out) {
  if (!valid(B, H, W, C, heads, hidden, ws, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  if (backward)
    for (int i = 0; i <= S_COUNT; ++i) out[i] = p.bwd_off[i];
  else
    for (int i = 0; i <= F_COUNT; ++i) out[i] = p.fwd_off[i];
  return 0;
}

// Each launch of the forward (5) or the backward (11), in order, into out[5 *
// launches]: grid x, y, z, threads, dynamic shared memory bytes.
extern "C" int dmh_swin_block_any_plan(int B, int H, int W, int C, int heads, int hidden,
                                       int ws, int is_bf16, int backward, int* out) {
  if (!valid(B, H, W, C, heads, hidden, ws, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  launches(p, backward != 0, out);
  return 0;
}
