// Whole Swin block forward and backward for Hopper, sm_90a.
//
// Replaces: dmhomo_tpu/ops/swin_block.py::_fwd_kernel and ::_bwd_kernel (the
// Pallas TPU kernels behind fused_swin_block and its custom_vjp).  The
// forward computes, on (B, H, W, C) tokens in 8x8 windows, with round() the
// rounding to the I/O dtype:
//   n1  = round(LN1(x))                  fp32 two-pass statistics, eps 1e-5
//   qkv = round(n1 . round(Wq) + bq)     fp32 accumulation
//   att = the max-free window attention of window_attention.cu per head:
//         q scaled by hd^-0.5 in the I/O dtype, e = round(exp(clip(q k^T +
//         bias[g] (+ mask[w]), +-60))), att = round((e v) / sum(e))
//   h   = round(x + round(att . round(Wp) + bp))
//   n2  = round(LN2(h))
//   gm  = round(gelu(n2 . round(W1) + c1))   exact erf, fp32 argument
//   y   = round(h + round(gm . round(W2) + c2))
// The backward recomputes that forward from x (all but the last product) and
// follows _bwd_kernel: with dy the gradient of y,
//   dW2 += dy^T gm,  dm1 = (dy . round(W2)) * gelu'(m1)  (fp32),
//   dW1 += dm1^T n2, dn2 = round(dm1) . round(W1),  dh = dy + LN2'(dn2),
//   dWp += dh^T att, dao = round(round(dh) . round(Wp)),
//   the window attention's backward of window_attention.cu into dq, dk, dv
//   (rounded) and dbias, dWq += dqkv^T n1,  dx = round(dh + LN1'(dqkv . round(Wq))),
// with every bias and LayerNorm gradient summed alongside, all in fp32.
// A shifted block reads and writes each window's tokens at coordinates
// shifted by `shift` mod (H, W): the cyclic roll and its inverse without the
// two copies.  The mask row w of a window is its index within its image.
// Weights come in nn.Linear's (out, in) layout, fp32, rounded to the I/O
// dtype as they are staged.
//
// What bounds them on an H100.  At the shipped HEM widths (C = 24, 48, 96, MLP
// 3C) a window reads and writes 64*C values and does 2*64*(10*C^2) flops of
// projections plus 4*64*64*C of attention in the forward, about 2.9-3.2
// times that in the backward: 2,300 flops per fp32 byte and more, far above
// the 20 where the card's 67 TFLOP/s of fp32 CUDA cores take over from its
// 3.35 TB/s of HBM.  Both are operations bound; but the weights (10*C^2
// fp32, 369 KB at C = 96) and the relative-position bias and mask (heads *
// 16 KB each) are read again for every window, from L2, and in bf16 that
// traffic outweighs the tensor cores' work.
//
// The forward, one block of 256 threads per window: the window stays in
// shared memory from x to y, so device memory sees x twice (the second read
// from L2, for the residual) and y once.  Three window buffers of 64 rows
// and one C x C weight block, in the I/O dtype (round() makes every kept
// value exact in it): n1, then the attention output, then n2; q, k and v
// (q stored scaled, as the attention uses it); x again, then h, then y.  At
// C = 96 the heads go in three groups of C / 3 columns, each group's q, k
// and v made from its rows of Wq and its attention written at once, so
// that no buffer is 3C wide.  The MLP's hidden axis streams C columns at a
// time through the q | k | v buffer, its second product summed in
// registers.  At C = 96: 95 KB in bf16, 113 KB in fp32, two blocks per SM;
// the launch bounds hold 4, 3 and 2 blocks per SM at C = 24, 48, 96 by
// registers.  The weights go through the block buffer in use order (Wq in
// three, Wp, W1 and W2 per hidden block), copied by cp.async, which holds
// no registers in flight: bf16 copies the next block into an fp32 staging
// area while the current one is used and rounds it into the buffer; fp32
// copies straight into the buffer, in flight while the attention or a
// LayerNorm runs.  The bf16 launches run every product on tensor cores:
// mma.sync m16n8k16 (m16n8k8 for C = 24's last step and the attention's
// head dims 4 and 8) fed by ldmatrix from the bf16 buffers, whose row
// strides are an odd number of 16-byte units; e stays in registers as the
// A fragments of e v.  The fp32 launches keep fp32 CUDA cores: the
// register-tiled SGEMM (each thread TR rows x TC columns of a 64 x C tile,
// float4 reads along the reduction, row strides of 4 (mod 8) floats), the
// attention's logits in mma.sync's layout by FMAs, e v with e in
// registers, each thread summing its keys and the four lanes of a row
// adding by shuffles.  The attention (shared with the backward's recompute
// kernel) takes two heads at a time, four warps each, 16 query rows a warp,
// 16 keys at a time in the forward (64 for fp32 at head dim 32), and reads
// each bias and mask value once as a float2 (bf16 at C = 96: one key chunk
// ahead).  LayerNorm takes four threads per token.  No wgmma: a window's
// products are 64 x C x C with C <= 96, a few k16 steps each, and wgmma's
// shared-memory layouts would need the buffers restaged for the
// attention's per-head columns.
//
// The backward is five kernels, so that no gradient is summed with global
// atomics, which one block per window would need: every window's 10 C^2
// weight-gradient and heads * 4096 dbias values go to the same addresses.
//  1. recompute, one block per window: the forward (LN1, qkv, the attention,
//     the projection and residual, LN2, the MLP's first product), then the
//     MLP's and LN2's backward and dao = round(round(dh) . round(Wp)).  It
//     writes the window's rows of n1, qkv, ao, n2, gm, dao (I/O dtype), dm1
//     and dh (fp32) to a scratch buffer, and its dg2, db2 to its own slot.
//  2. attention, one block of four warps per head and chunk of windows: the
//     head's bias tile is staged once, its dbias summed in registers over
//     the chunk and written once.  Per window the logits are computed once
//     per head and e and dsim kept in shared memory for dq, dk and dv, which
//     replace q, k, v.
//  3. input, one block per window: dn1 = dqkv . round(Wq) and dx = round(dh
//     + LN1'(dn1)), with its dg1, db1.
//  4. weights: each weight gradient as C x C blocks of a product over the
//     token axis (dW2 = dy^T gm, dW1 = dm1^T n2, dWp = dh^T ao, dWq = dqkv^T
//     n1, with the bias-vector gradients as column sums), split into token
//     ranges; each block stores its range's partial.
//  5. reduce: every gradient summed over its partials in a fixed order, so
//     a launch's gradients are the same bits run to run.
// The bf16 launches run every product on tensor cores (mma.sync m16n8k16,
// m16n8k8 for head dims 4 and 8 and for C = 24's last step), operands
// rounded to bf16 as they are packed from fp32 shared memory, as the Pallas
// kernel rounds them; the two products over an fp32 gradient (dW1 over dm1,
// dWp over dh) split it into two bf16 parts and two products (its value to
// 2^-17).  The fp32 launches keep fp32 CUDA cores: the forward's register
// tiles for the projections and the weight products, the mma layout
// computed with FMAs for the attention.  The bias and mask are read as
// float2s where each value is used once (the recompute kernel), the bias
// staged where a block reuses it (the attention's backward).  Global loads
// are fetched into registers one step ahead (the next weight block, window
// or token chunk) so that they are in flight while the current one is used.
// The bf16 window buffers have row strides of 8 (mod 16) floats for the
// fragments' float2 reads.  The scratch costs about 0.9 KB a token in bf16
// and 1.4 KB in fp32, written once and read once or twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int WS = 8;                 // window side
constexpr int N = WS * WS;            // tokens per window
constexpr int THREADS = 256;
constexpr int LN_THREADS = 4;         // threads per token in a LayerNorm
constexpr int MAX_MLP_RATIO = 4;
constexpr float CLIP = 60.0f;
constexpr float LN_EPS = 1e-5f;

// Row stride (floats) of a shared buffer `width` floats wide: 4 (mod 8), so
// float4 reads of 8 consecutive rows land in 8 distinct groups of 4 banks.
__host__ __device__ constexpr int pad(int width) { return width + 4; }

// A 64 x C output tile on 256 threads: CG column groups (columns cg + CG*j)
// by RG row groups (rows rg + RG*i).
template <int C>
struct Tiling {
  static constexpr int CG = C % 16 == 0 ? 16 : 8;
  static constexpr int TC = C / CG;
  static constexpr int RG = THREADS / CG;
  static constexpr int TR = N / RG;
  static_assert(TC * CG == C && TR * RG == N, "C must be a multiple of 8 (16 above 24)");
};

struct Params {
  const float* g1;
  const float* b1;
  const float* wq;    // (3C, C)
  const float* bq;    // (3C)
  const float* bias;  // (heads, 64, 64)
  const float* mask;  // (nW, 64, 64) or null
  const float* wp;    // (C, C)
  const float* bp;
  const float* g2;
  const float* b2;
  const float* w1;    // (hidden, C)
  const float* c1;
  const float* w2;    // (C, hidden)
  const float* c2;
};

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ void load4(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    x[0] = __low2float(a); x[1] = __high2float(a);
    x[2] = __low2float(b); x[3] = __high2float(b);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The same on bf16 shared buffers (the forward's bf16 launches): four values
// as floats, four floats stored rounded (exact for the rounded values the
// kernel stores), and one element either way.
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// dst = round(LN(src)) for the window's 64 tokens, C channels each; rows
// LD elements apart, fp32 or bf16 buffers.  Four threads per token,
// combined with shuffles.
template <typename T, int C, int LD = pad(C), typename S>
__device__ __forceinline__ void layer_norm(const S* src, S* dst,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b, int tid) {
  const int t = tid / LN_THREADS;
  const int part = tid % LN_THREADS;
  const S* row = src + t * LD;
  float sum = 0.0f;
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    sum += (v.x + v.y) + (v.z + v.w);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float mean = sum / C;
  float sq = 0.0f;
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    const float a = v.x - mean, bb = v.y - mean, cc = v.z - mean, d = v.w - mean;
    sq += (a * a + bb * bb) + (cc * cc + d * d);
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  sq += __shfl_xor_sync(0xffffffffu, sq, 2);
  const float rstd = rsqrtf(sq / C + LN_EPS);
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + c));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + c));
    st4(dst + t * LD + c,
        make_float4(IO<T>::round((v.x - mean) * rstd * gg.x + bb.x),
                    IO<T>::round((v.y - mean) * rstd * gg.y + bb.y),
                    IO<T>::round((v.z - mean) * rstd * gg.z + bb.z),
                    IO<T>::round((v.w - mean) * rstd * gg.w + bb.w)));
  }
}

template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(IO<T>::round(v.x), IO<T>::round(v.y), IO<T>::round(v.z), IO<T>::round(v.w));
}

// acc[i][j] += sum_k a[(rg + RG*i) * lda + k0 + k] * ws[(cg + CG*j) * pad(C) + k]
template <int C>
__device__ __forceinline__ void mma_block(const float* a, int lda, int k0, const float* ws,
                                          float (&acc)[Tiling<C>::TR][Tiling<C>::TC],
                                          int rg, int cg) {
  using Tl = Tiling<C>;
  constexpr int LD = pad(C);
  const float* arow = a + rg * lda + k0;
  const float* wrow = ws + cg * LD;
#pragma unroll 2
  for (int k = 0; k < C; k += 4) {
    float4 av[Tl::TR], bv[Tl::TC];
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i) av[i] = ld4(arow + Tl::RG * i * lda + k);
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j) bv[j] = ld4(wrow + Tl::CG * j * LD + k);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i) {
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[Tiling<C>::TR][Tiling<C>::TC]) {
#pragma unroll
  for (int i = 0; i < Tiling<C>::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tiling<C>::TC; ++j) acc[i][j] = 0.0f;
}

// Element offset of window token t (row-major within the 8x8 window) of
// window w of image b, in the frame shifted by `shift` mod (H, W).
struct WindowTokens {
  int b, h0, w0, H, W, C;
  __device__ WindowTokens(int block, int H_, int W_, int C_, int shift) : H(H_), W(W_), C(C_) {
    const int nwc = W / WS;
    const int nW = (H / WS) * nwc;
    b = block / nW;
    const int w = block % nW;
    h0 = (w / nwc) * WS + shift;
    w0 = (w % nwc) * WS + shift;
  }
  __device__ __forceinline__ size_t operator()(int t) const {
    int gh = h0 + t / WS, gw = w0 + t % WS;  // h0 < H and w0 < W: one wrap at most
    if (gh >= H) gh -= H;
    if (gw >= W) gw -= W;
    return ((static_cast<size_t>(b) * H + gh) * W + gw) * C;
  }
};

// dst (N rows LD floats apart) = the window's C-channel tokens of src.
template <typename T, int C, int LD = pad(C)>
__device__ __forceinline__ void load_window(const T* __restrict__ src, const WindowTokens& token,
                                            float* dst, int tid) {
  constexpr int Q = C / 4;
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    float v[4];
    IO<T>::load4(src + token(t) + c, v);
    st4(dst + t * LD + c, make_float4(v[0], v[1], v[2], v[3]));
  }
}

// dst (N rows LD elements apart) = the window's tokens of src, and back:
// 16-byte copies, the I/O dtype kept
template <typename T, int C, int LD>
__device__ __forceinline__ void copy_window_in(const T* __restrict__ src, const WindowTokens& token,
                                               T* dst, int tid) {
  constexpr int V = 16 / sizeof(T), Q = C / V;
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = V * (e % Q);
    *reinterpret_cast<uint4*>(dst + t * LD + c) =
        __ldg(reinterpret_cast<const uint4*>(src + token(t) + c));
  }
}
template <typename T, int C, int LD>
__device__ __forceinline__ void copy_window_out(const T* src, const WindowTokens& token,
                                                T* __restrict__ dst, int tid) {
  constexpr int V = 16 / sizeof(T), Q = C / V;
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = V * (e % Q);
    *reinterpret_cast<uint4*>(dst + token(t) + c) =
        *reinterpret_cast<const uint4*>(src + t * LD + c);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct Grads {  // fp32, in the parameters' layouts; written once, by the reduction
  float* g1;
  float* b1;
  float* wq;    // (3C, C)
  float* bq;
  float* bias;  // (heads, 64, 64)
  float* wp;    // (C, C)
  float* bp;
  float* g2;
  float* b2;
  float* w1;    // (hidden, C)
  float* c1;
  float* w2;    // (C, hidden)
  float* c2;
};

// What the window kernels hand the weight-gradient product and each other.
// Token rows in window order (row = window * 64 + token in the window).
struct Scratch {
  void* n1;      // (tokens, C) I/O dtype: round(LN1(x))
  void* qkv;     // (tokens, 3C) I/O: qkv; the attention's backward writes round(dq, dk, dv) over it
  void* ao;      // (tokens, C) I/O: the attention output
  void* n2;      // (tokens, C) I/O: round(LN2(h))
  void* gm;      // (tokens, hidden) I/O: round(gelu(m1))
  float* dm1;    // (tokens, hidden) fp32
  float* dh;     // (tokens, C) fp32
  void* dao;     // (tokens, C) I/O: the attention output's gradient
  float* ln;     // (windows, 4C): dg1, db1, dg2, db2 of each window
  float* wpart;  // (splits, PartLayout::size): weight and bias-vector gradients of each token split
  float* bpart;  // (chunks, heads, 64, 64): dbias of each chunk of windows
};

// Offsets (floats) of the gradients within one token split's partial.
struct PartLayout {
  int C, hidden;
  __host__ __device__ int w2() const { return 0; }
  __host__ __device__ int w1() const { return C * hidden; }
  __host__ __device__ int wp() const { return 2 * C * hidden; }
  __host__ __device__ int wq() const { return 2 * C * hidden + C * C; }
  __host__ __device__ int c2() const { return 2 * C * hidden + 4 * C * C; }
  __host__ __device__ int c1() const { return c2() + C; }
  __host__ __device__ int bp() const { return c1() + hidden; }
  __host__ __device__ int bq() const { return bp() + C; }
  __host__ __device__ int size() const { return bq() + 3 * C; }
};

// Byte offsets of Scratch's buffers (in its field order) within one
// allocation, each at a multiple of 256 bytes, and the allocation's size
// (off[SCRATCH_BUFFERS]), for a launch of `windows` windows with chunks of
// per_block windows (the attention) and token ranges of split_tokens (the
// weight products).
constexpr int SCRATCH_BUFFERS = 11;
void scratch_layout(long long windows, int C, int heads, int hidden, int per_block,
                    int split_tokens, bool bf16, long long* off) {
  const long long tokens = windows * N, io = bf16 ? 2 : 4, f = 4;
  const long long chunks = (windows + per_block - 1) / per_block;
  const long long splits = (tokens + split_tokens - 1) / split_tokens;
  const long long bytes[SCRATCH_BUFFERS] = {
      io * tokens * C,     io * tokens * 3 * C, io * tokens * C,  io * tokens * C,
      io * tokens * hidden, f * tokens * hidden, f * tokens * C,   io * tokens * C,
      f * windows * 4 * C, f * splits * PartLayout{C, hidden}.size(),
      f * chunks * heads * N * N};
  long long o = 0;
  for (int i = 0; i < SCRATCH_BUFFERS; ++i) {
    off[i] = o;
    o += (bytes[i] + 255) / 256 * 256;
  }
  off[SCRATCH_BUFFERS] = o;
}

template <typename T>
struct Bf16 {
  static constexpr bool value = false;
};
template <>
struct Bf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

// Row stride (floats) of the backward's window buffers, `width` floats wide:
// the forward's for fp32 (float4 reads of the register-tiled SGEMM); for bf16
// 8 (mod 16), so that the float2 reads of a tensor-core fragment (rows g,
// columns 2t) fall in 16 distinct bank pairs per half-warp.
template <typename T>
__host__ __device__ constexpr int bpad(int width) {
  return Bf16<T>::value ? width + ((width + 8) % 16 == 8 ? 8 : 16) : pad(width);
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// packed bf16 pair (lo in the low half) and its two values
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// d += a . b on tensor cores, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

template <int M>
__device__ __forceinline__ void zero_tiles(float (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
}

// One warp's 16 x 8NT tile in mma.sync's accumulator layout: with g = lane / 4
// and t = lane % 4, acc[j][q] is row g + 8 (q / 2), column 8 j + 2 t + q % 2.
//   acc[j] += sum over k < K of a(m, k) b(k, n),  m < 16, n < 8 NT,
// with the operands read in pairs along k through the callers' functions:
// a(m, k) gives (a(m, k), a(m, k + 1)) and b(k, n) gives (b(k, n), b(k + 1,
// n)) for even k, as float2s (0 outside the operands).  bf16: mma.sync on
// tensor cores, each operand rounded to bf16 as it is packed (exact for the
// rounded values the callers give it); with SPLIT, a is taken as hi + lo,
// two bf16 parts and two products, which keeps an fp32 operand to 2^-17 of
// itself.  K a multiple of 8 (m16n8k16 steps, one m16n8k8 for the rest).
// fp32: FMAs on CUDA cores, the same layout, K even.
template <typename T, int NT, int K, bool SPLIT = false>
struct WarpMma;

template <int NT, int K, bool SPLIT>
struct WarpMma<float, NT, K, SPLIT> {
  template <typename FA, typename FB>
  static __device__ __forceinline__ void run(float (&acc)[NT][4], FA a, FB b) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k = 0; k < K; k += 2) {
      const float2 a0 = a(g, k), a1 = a(g + 8, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b0 = b(k, 8 * j + 2 * t), b1 = b(k, 8 * j + 2 * t + 1);
        acc[j][0] = fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, acc[j][0]));
        acc[j][1] = fmaf(a0.y, b1.y, fmaf(a0.x, b1.x, acc[j][1]));
        acc[j][2] = fmaf(a1.y, b0.y, fmaf(a1.x, b0.x, acc[j][2]));
        acc[j][3] = fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, acc[j][3]));
      }
    }
  }
};

template <int NT, int K, bool SPLIT>
struct WarpMma<__nv_bfloat16, NT, K, SPLIT> {
  static_assert(K % 8 == 0, "the reduction must be a multiple of 8");

  // the pair a(m, k), a(m, k + 1) packed, and with SPLIT its remainder
  template <typename FA>
  static __device__ __forceinline__ void frag(FA a, int m, int k, uint32_t& hi, uint32_t& lo) {
    const float2 x = a(m, k);
    hi = pack_bf16(x.x, x.y);
    lo = SPLIT ? pack_bf16(x.x - bf16_lo(hi), x.y - bf16_hi(hi)) : 0u;
  }

  template <typename FB>
  static __device__ __forceinline__ uint32_t bfrag(FB b, int k, int n) {
    const float2 x = b(k, n);
    return pack_bf16(x.x, x.y);
  }

  template <typename FA, typename FB>
  static __device__ __forceinline__ void run(float (&acc)[NT][4], FA a, FB b) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 + 16 <= K; k0 += 16) {
      uint32_t ah[4], al[4];
      frag(a, g, k0 + 2 * t, ah[0], al[0]);
      frag(a, g + 8, k0 + 2 * t, ah[1], al[1]);
      frag(a, g, k0 + 8 + 2 * t, ah[2], al[2]);
      frag(a, g + 8, k0 + 8 + 2 * t, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        const uint32_t b0 = bfrag(b, k0 + 2 * t, n), b1 = bfrag(b, k0 + 8 + 2 * t, n);
        mma16(acc[j], ah, b0, b1);
        if (SPLIT) mma16(acc[j], al, b0, b1);
      }
    }
    if constexpr (K % 16 != 0) {
      constexpr int k0 = K - 8;
      uint32_t ah0, al0, ah1, al1;
      frag(a, g, k0 + 2 * t, ah0, al0);
      frag(a, g + 8, k0 + 2 * t, ah1, al1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t b0 = bfrag(b, k0 + 2 * t, 8 * j + g);
        mma8(acc[j], ah0, ah1, b0);
        if (SPLIT) mma8(acc[j], al0, al1, b0);
      }
    }
  }
};

// operand pairs for WarpMma: p[i] and p[i + 1] (i even), or p[i] and p[i + ld]
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const float* p, int ld) { return make_float2(p[0], p[ld]); }
__device__ __forceinline__ float2 zero2() { return make_float2(0.0f, 0.0f); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p, int ld) {
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[ld]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// ldmatrix: one, two or four 8 x 8 bf16 matrices of shared memory, the row
// addresses given by lanes 0-7, 8-15, ... (16-byte aligned); thread (g, t)
// gets row g, elements 2t and 2t + 1 of each, which is an mma.sync fragment
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t ldsm1(const void* p) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p)));
  return r;
}

// 16 bytes from device to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cdf = Phi(m) and phi = exp(-m^2 / 2) / sqrt(2 pi) of the exact GELU, by
// erff and expf as the forward computes its GELU
__device__ __forceinline__ void gelu_parts(float m, float& cdf, float& phi) {
  cdf = 0.5f * (1.0f + erff(m * 0.70710678118654752f));
  phi = 0.3989422804014327f * expf(-0.5f * m * m);
}

// round(|v|) of a pair (the attention's e from its stored +-e32)
template <typename T>
__device__ __forceinline__ float2 rounded_abs(float2 v) {
  return make_float2(IO<T>::round(fabsf(v.x)), IO<T>::round(fabsf(v.y)));
}

// exp(clip(v, +-60)) by expf, as the forward's attention computes it
__device__ __forceinline__ float clipped_exp(float v) {
  return expf(fminf(fmaxf(v, -CLIP), CLIP));
}

// A 64 x C projection tile (rows the window's tokens, columns output
// features) on the block's 256 threads, in its dtype's layout:
//   acc[r][n] += sum over k < C of a[r * lda + k] ws[n * bpad<T>(C) + k].
// fp32: the register-tiled SGEMM of the forward (mma_block); bf16: warp w
// takes rows 16 (w % 4) .. and every other 8-column tile from w / 4, on
// tensor cores (a rounded to bf16 as it is packed, as every product here
// wants it).
template <typename T, int C>
struct Proj;

template <int C>
struct Proj<float, C> {
  using Tl = Tiling<C>;
  float acc[Tl::TR][Tl::TC];
  int rg, cg;
  __device__ explicit Proj(int tid) : rg(tid / Tl::CG), cg(tid % Tl::CG) { zero<C>(acc); }
  __device__ __forceinline__ void mma(const float* a, int lda, const float* ws) {
    mma_block<C>(a, lda, 0, ws, acc, rg, cg);
  }
  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) f(rg + Tl::RG * i, cg + Tl::CG * j, acc[i][j]);
  }
};

template <int C>
struct Proj<__nv_bfloat16, C> {
  static constexpr int TILES = C / 8;            // 8-column tiles of the output
  static constexpr int NT = (TILES + 1) / 2;     // a warp's: every other one
  float acc[NT][4];
  int m0, half;
  __device__ explicit Proj(int tid) : m0(16 * ((tid >> 5) & 3)), half(tid >> 7) { zero_tiles(acc); }
  __device__ __forceinline__ void mma(const float* a, int lda, const float* ws) {
    const float* ar = a + m0 * lda;
    const int hf = half;
    WarpMma<__nv_bfloat16, NT, C>::run(
        acc, [&](int m, int k) { return pair(ar + m * lda + k); },
        [&](int k, int n) {
          const int tile = hf + 2 * (n >> 3);
          return tile < TILES ? pair(ws + (8 * tile + (n & 7)) * bpad<__nv_bfloat16>(C) + k) : zero2();
        });
  }
  // the same tile from bf16 buffers (the forward's bf16 launches; rows
  // bpad(C) elements apart, an odd number of 16-byte units): the fragments
  // by ldmatrix, without conflicts or packing
  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* ws) {
    constexpr int LW = bpad<__nv_bfloat16>(C);
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* ar = a + (m0 + (lane & 15)) * lda;
    const __nv_bfloat16* br = ws + (lane & 7) * LW + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int k0 = 0; k0 + 16 <= C; k0 += 16) {
      uint32_t af[4];
      ldsm4(af, ar + k0 + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tile = half + 2 * j;
        if (tile < TILES) {
          uint32_t b0, b1;
          ldsm2(b0, b1, br + 8 * tile * LW + k0);
          mma16(acc[j], af, b0, b1);
        }
      }
    }
    if constexpr (C % 16 != 0) {  // the last 8 of the reduction (C = 24)
      constexpr int k0 = C - 8;
      uint32_t a0, a1;
      ldsm2(a0, a1, ar + k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tile = half + 2 * j;
        if (tile < TILES) mma8(acc[j], a0, a1, ldsm1(br + 8 * tile * LW + k0));
      }
    }
  }
  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int tile = half + 2 * j;
      if (tile < TILES) {
#pragma unroll
        for (int q = 0; q < 4; ++q) f(m0 + g + 8 * (q >> 1), 8 * tile + 2 * t + (q & 1), acc[j][q]);
      }
    }
  }
};

// dst[t * ldd + c] = src[t * lds + c] in S, for the window's 64 rows, c < K
template <typename S, int K>
__device__ __forceinline__ void store_rows(S* dst, int ldd, const float* src, int lds, int tid) {
  constexpr int Q = K / 4;
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    IO<S>::store4(dst + static_cast<size_t>(t) * ldd + c, src + t * lds + c);
  }
}

// dst[t * ldd + c] = src[t * lds + c] for the window's 64 rows, c < K
template <typename S, int K>
__device__ __forceinline__ void load_rows(const S* src, int lds, float* dst, int ldd, int tid) {
  constexpr int Q = K / 4;
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    float v[4];
    IO<S>::load4(src + static_cast<size_t>(t) * lds + c, v);
    st4(dst + t * ldd + c, make_float4(v[0], v[1], v[2], v[3]));
  }
}

// One C x C block of an (out, in) fp32 weight w (rows ldw apart), fetched
// into registers, so that the next block's loads are in flight while the
// current one is used, then put into ws (rows bpad<T>(C) floats apart)
// rounded to T: row n of ws holds
//   plain:      w[(r0 + n) * ldw + c0 + k] for k < C (output column r0 + n);
//   transposed: w[(r0 + k) * ldw + c0 + n] for k < C (input column c0 + n),
// for a product that reduces over the weight's output axis.  A transposed
// block is fetched down the rows, so that the puts are free of bank
// conflicts.
template <typename T, int C>
struct WeightStage {
  static constexpr int Q = C / 4, ELEMS = C * Q, E = (ELEMS + THREADS - 1) / THREADS;
  float4 v[E];
  bool transposed;

  __device__ __forceinline__ void fetch(const float* __restrict__ w, int ldw, int r0, int c0,
                                        bool t, int tid) {
    transposed = t;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * THREADS;
      const int row = t ? e % C : e / Q, c = 4 * (t ? e / C : e % Q);
      if (e < ELEMS)
        v[i] = __ldg(reinterpret_cast<const float4*>(w + static_cast<size_t>(r0 + row) * ldw +
                                                     c0 + c));
    }
  }

  __device__ __forceinline__ void put(float* ws, int tid) const {
    constexpr int LD = bpad<T>(C);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * THREADS;
      if (e >= ELEMS) continue;
      const float4 r = round4<T>(v[i]);
      if (transposed) {
        const int k = e % C, n = 4 * (e / C);
        ws[n * LD + k] = r.x;
        ws[(n + 1) * LD + k] = r.y;
        ws[(n + 2) * LD + k] = r.z;
        ws[(n + 3) * LD + k] = r.w;
      } else {
        st4(ws + (e / Q) * LD + 4 * (e % Q), r);
      }
    }
  }
};

// LayerNorm backward over the window, in fp32: with xhat and rstd of src (C
// channels, rows LD floats apart, as dres's; statistics as layer_norm
// computes them) and dxh = dn * g,
//   dres += rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))   (in place)
// and the window's gain and bias gradients dg = sum_t dn * xhat, db = sum_t
// dn stored (not added) to dg[0..C), db[0..C).  Ends with a barrier.
template <int C, int LD>
__device__ __forceinline__ void layer_norm_bwd(const float* src, const float* dn, int ldn,
                                               float* dres, const float* __restrict__ g,
                                               float* dg, float* db, float* st, int tid) {
  const int t = tid / LN_THREADS;
  const int part = tid % LN_THREADS;
  const float* row = src + t * LD;
  float sum = 0.0f;
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    sum += (v.x + v.y) + (v.z + v.w);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float mean = sum / C;
  float sq = 0.0f;
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    const float a = v.x - mean, bb = v.y - mean, cc = v.z - mean, d = v.w - mean;
    sq += (a * a + bb * bb) + (cc * cc + d * d);
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  sq += __shfl_xor_sync(0xffffffffu, sq, 2);
  const float rstd = rsqrtf(sq / C + LN_EPS);
  if (part == 0) {
    st[2 * t] = mean;
    st[2 * t + 1] = rstd;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {  // the gain and bias gradients
    float sg = 0.0f, sb = 0.0f;
    for (int u = 0; u < N; ++u) {
      const float d = dn[u * ldn + c];
      sg = fmaf(d, (src[u * LD + c] - st[2 * u]) * st[2 * u + 1], sg);
      sb += d;
    }
    dg[c] = sg;
    db[c] = sb;
  }
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    const float4 d = ld4(dn + t * ldn + c);
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + c));
    const float h[4] = {(v.x - mean) * rstd, (v.y - mean) * rstd, (v.z - mean) * rstd,
                        (v.w - mean) * rstd};
    const float e[4] = {d.x * gg.x, d.y * gg.y, d.z * gg.z, d.w * gg.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      m1 += e[u];
      m2 = fmaf(e[u], h[u], m2);
    }
  }
  m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
  m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
  m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
  m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
  m1 /= C;
  m2 /= C;
  for (int c = 4 * part; c < C; c += 4 * LN_THREADS) {
    const float4 v = ld4(row + c);
    const float4 d = ld4(dn + t * ldn + c);
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + c));
    float4 r = ld4(dres + t * LD + c);
    r.x += rstd * (d.x * gg.x - m1 - (v.x - mean) * rstd * m2);
    r.y += rstd * (d.y * gg.y - m1 - (v.y - mean) * rstd * m2);
    r.z += rstd * (d.z * gg.z - m1 - (v.z - mean) * rstd * m2);
    r.w += rstd * (d.w * gg.w - m1 - (v.w - mean) * rstd * m2);
    st4(dres + t * LD + c, r);
  }
  __syncthreads();
}

constexpr int ELD = N + 4;          // row stride of a 64 x 64 tile (e, dsim, bias)
constexpr int ATT_THREADS = 128;    // the attention's backward: four warps, one head

// the reduction over a head dim: bf16 pads it to the mma's k (8)
template <typename T, int HD>
struct HeadK {
  static constexpr int value = Bf16<T>::value && HD < 8 ? 8 : HD;
};

__host__ __device__ constexpr int head_ld(int hd) { return hd + 4; }

// Floats of the region that holds one weight block, or (fp32) the forward
// attention's e tiles of the two heads in flight.
template <typename T>
__host__ __device__ constexpr int weight_region(int C) {
  return Bf16<T>::value || C * bpad<T>(C) > 2 * N * ELD ? C * bpad<T>(C) : 2 * N * ELD;
}

// Floats of shared memory of each backward kernel.
template <typename T>
__host__ __device__ constexpr size_t recompute_smem_floats(int C) {
  return static_cast<size_t>(3 * N * bpad<T>(C) + N * bpad<T>(3 * C) + weight_region<T>(C) +
                             2 * N);
}
__host__ __device__ constexpr size_t attention_smem_floats(int hd) {
  return static_cast<size_t>(3 * N * ELD + 5 * N * head_ld(hd));
}
// attention blocks an SM holds (their launch bounds; head dim 32's shared
// memory allows two)
__host__ __device__ constexpr int attention_blocks_per_sm(int hd) { return hd < 32 ? 3 : 2; }
template <typename T>
__host__ __device__ constexpr size_t input_smem_floats(int C) {
  return static_cast<size_t>(2 * N * bpad<T>(C) + N * bpad<T>(3 * C) + C * bpad<T>(C) + 2 * N);
}
// windows of tokens the weight-gradient kernel stages at a time (three
// float4s of each operand per thread)
__host__ __device__ constexpr int weight_windows(int C) { return C <= 24 ? 2 : 1; }
// weight-gradient blocks an SM holds (its launch bounds; the plan sizes the
// splits to fill the card with them once)
__host__ __device__ constexpr int weight_blocks_per_sm(int C) { return C <= 24 ? 4 : 2; }
__host__ __device__ constexpr size_t weights_smem_floats(int C) {
  return static_cast<size_t>(2 * weight_windows(C) * N * pad(C));
}

// out[i][h HD + d] = round((e v)_i / s_i), the window attention of the heads
// h_base .. h_base + QW / HD of qkv: q, k and v each QW columns wide (q at
// column 0, k at QW, v at 2 QW; rows bpad<T>(3 QW) apart), the output C wide
// (rows bpad<T>(C) apart); buffers of S (fp32, or the forward's bf16).  Two
// heads in flight, four warps each, a warp's 16 query rows; the logits on
// tensor cores (bf16) or CUDA cores (fp32), KC keys at a time (the softmax
// has no max, so e and its sums need no second pass; the sums and e v
// accumulate in key order either way).  e stays in registers (EREG: the A
// fragments of e v on tensor cores for bf16; for fp32 each thread sums its
// keys and the four lanes of a row add up by shuffles) or, for fp32 without
// EREG, is staged in et (2 x 64 x ELD; KC = 64).  Each bias and mask value
// is read once, as a float2, with PF one chunk ahead (where the registers
// allow it).  QSCALED: q comes scaled (round(q hd^-0.5), as the forward's
// qkv product stores it), else it is scaled here.  No barrier at the end.
template <typename T, int C, int HD, int QW = C, bool EREG = Bf16<T>::value, int KC = N,
          bool PF = false, bool QSCALED = false, typename S>
__device__ __forceinline__ void attention_fwd(const S* qs, S* out, const Params& p, int w,
                                              float scale_io, float* et, int h_base, int tid) {
  static_assert(EREG || !Bf16<T>::value, "bf16 keeps e in registers");
  static_assert(EREG || KC == N, "a staged e tile takes every key at once");
  static_assert(KC % 16 == 0 && N % KC == 0 && (!PF || KC < N), "keys in whole 16-key steps");
  constexpr int LD = bpad<T>(C), LDQ = bpad<T>(3 * QW), HEADS = QW / HD;
  constexpr int HK = HeadK<T, HD>::value, NO = (HD + 7) / 8, KT = KC / 8;
  // fp32 with e in registers: e v summed per chunk of keys into 2 x HD
  // registers, or (every key at once) per 8 head dims after the last key
  constexpr bool FE = !Bf16<T>::value && EREG, DCH = FE && KC == N;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3);
  float* e_s = EREG ? nullptr : et + (warp >> 2) * N * ELD;
  const float* mask_w = p.mask ? p.mask + static_cast<size_t>(w) * N * N : nullptr;
  for (int h0 = 0; h0 < HEADS; h0 += 2) {
    const int hl = h0 + (warp >> 2), h = h_base + hl;
    if (hl >= HEADS) break;
    const S* q = qs + hl * HD;
    const S* k = qs + QW + hl * HD;
    const S* v = qs + 2 * QW + hl * HD;
    const float* bias_h = p.bias + static_cast<size_t>(h) * N * N;
    float s[2] = {0.0f, 0.0f};
    float o[NO][4];    // bf16 and the staged tile: e v in mma.sync's layout
    float of[2][HD];   // fp32 with EREG: this thread's keys' share of rows g, g + 8
    zero_tiles(o);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int d = 0; d < HD; ++d) of[hr][d] = 0.0f;
    // the bias and mask of a chunk of keys, fetched one chunk ahead (PF) so
    // that their L2 latency hides behind the chunk before
    float2 bm[KT][2][2];
    const auto fetch_bm = [&](int kc) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = m0 + g + 8 * hr, c = kc + 8 * j + 2 * t;
          bm[j][hr][0] = __ldg(reinterpret_cast<const float2*>(bias_h + r * N + c));
          bm[j][hr][1] = mask_w ? __ldg(reinterpret_cast<const float2*>(mask_w + r * N + c))
                                : zero2();
        }
      }
    };
    if (PF) fetch_bm(0);
    float sim[KT][4];      // a chunk's logits, then (fp32) its e
    uint32_t ep[KT][2];    // bf16: its e, rows g and g + 8, packed (the A fragments of e v)
#pragma unroll
    for (int kc = 0; kc < N; kc += KC) {
      float2 cur[KT][2][2];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) cur[j][hr][0] = bm[j][hr][0], cur[j][hr][1] = bm[j][hr][1];
      if (PF && kc + KC < N) fetch_bm(kc + KC);
      zero_tiles(sim);
      WarpMma<T, KT, HK>::run(
          sim,
          [&](int m, int kk) {
            if (kk >= HD) return zero2();
            const float2 v2 = pair(q + (m0 + m) * LDQ + kk);
            if (QSCALED) return v2;
            return make_float2(IO<T>::round(v2.x * scale_io), IO<T>::round(v2.y * scale_io));
          },
          [&](int kk, int n) { return kk < HD ? pair(k + (kc + n) * LDQ + kk) : zero2(); });
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = m0 + g + 8 * hr, c = kc + 8 * j + 2 * t;
          float x0, x1;
          if constexpr (PF) {
            x0 = sim[j][2 * hr] + cur[j][hr][0].x;
            x1 = sim[j][2 * hr + 1] + cur[j][hr][0].y;
            if (mask_w) {
              x0 += cur[j][hr][1].x;
              x1 += cur[j][hr][1].y;
            }
          } else {
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias_h + r * N + c));
            x0 = sim[j][2 * hr] + b2.x;
            x1 = sim[j][2 * hr + 1] + b2.y;
            if (mask_w) {
              const float2 m2 = __ldg(reinterpret_cast<const float2*>(mask_w + r * N + c));
              x0 += m2.x;
              x1 += m2.y;
            }
          }
          if constexpr (Bf16<T>::value) {  // e rounded as it is packed
            ep[j][hr] = pack_bf16(clipped_exp(x0), clipped_exp(x1));
            s[hr] += bf16_lo(ep[j][hr]) + bf16_hi(ep[j][hr]);
            continue;
          }
          const float e0 = IO<T>::round(clipped_exp(x0)), e1 = IO<T>::round(clipped_exp(x1));
          if constexpr (EREG) {  // e stays in registers
            sim[j][2 * hr] = e0;
            sim[j][2 * hr + 1] = e1;
          } else {
            put2(e_s + r * ELD + c, e0, e1);
          }
          s[hr] += e0 + e1;
        }
      }
      if constexpr (Bf16<T>::value) {
        // e v with e's accumulator tiles as the A fragments: tiles 2kk and
        // 2kk + 1 are keys kc + 16kk .. kc + 16kk + 15
#pragma unroll
        for (int kk = 0; kk < KT / 2; ++kk) {
          const uint32_t a[4] = {ep[2 * kk][0], ep[2 * kk][1], ep[2 * kk + 1][0],
                                 ep[2 * kk + 1][1]};
          const int key = kc + 16 * kk + 2 * t;
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            const int n = 8 * j + g;
            const float2 b0 = n < HD ? pair(v + key * LDQ + n, LDQ) : zero2();
            const float2 b1 = n < HD ? pair(v + (key + 8) * LDQ + n, LDQ) : zero2();
            mma16(o[j], a, pack_bf16(b0.x, b0.y), pack_bf16(b1.x, b1.y));
          }
        }
      } else if constexpr (FE && !DCH) {
        // this thread's keys kc + 8j + 2t + u for rows g and g + 8
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const S* vr = v + (kc + 8 * j + 2 * t + u) * LDQ;
#pragma unroll
            for (int d = 0; d < HD; d += 4) {
              const float4 vv = ld4(vr + d);
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const float e = sim[j][2 * hr + u];
                of[hr][d] = fmaf(e, vv.x, of[hr][d]);
                of[hr][d + 1] = fmaf(e, vv.y, of[hr][d + 1]);
                of[hr][d + 2] = fmaf(e, vv.z, of[hr][d + 2]);
                of[hr][d + 3] = fmaf(e, vv.w, of[hr][d + 3]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 1);
      s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 2);
    }
    if constexpr (DCH) {
      // e is every key's (sim); DC head dims at a time, the four lanes of a
      // row add their keys' sums, then each stores DC / 4 of the dims
      constexpr int DC = HD < 8 ? HD : 8, PER = DC / 4;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += DC) {
        float od[2][DC];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int d = 0; d < DC; ++d) od[hr][d] = 0.0f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const S* vr = v + (8 * j + 2 * t + u) * LDQ + d0;
#pragma unroll
            for (int d = 0; d < DC; d += 4) {
              const float4 vv = ld4(vr + d);
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const float e = sim[j][2 * hr + u];
                od[hr][d] = fmaf(e, vv.x, od[hr][d]);
                od[hr][d + 1] = fmaf(e, vv.y, od[hr][d + 1]);
                od[hr][d + 2] = fmaf(e, vv.z, od[hr][d + 2]);
                od[hr][d + 3] = fmaf(e, vv.w, od[hr][d + 3]);
              }
            }
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int d = 0; d < DC; ++d) {
            od[hr][d] += __shfl_xor_sync(0xffffffffu, od[hr][d], 1);
            od[hr][d] += __shfl_xor_sync(0xffffffffu, od[hr][d], 2);
            if (d / PER == t)
              stf(out + (m0 + g + 8 * hr) * LD + h * HD + d0 + d,
                  IO<T>::round(od[hr][d] / s[hr]));
          }
        }
      }
    } else if constexpr (FE) {
      // the four lanes of a row add their keys' sums; lane t stores dims
      // t HD / 4 .. (t + 1) HD / 4
      constexpr int PER = HD / 4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          of[hr][d] += __shfl_xor_sync(0xffffffffu, of[hr][d], 1);
          of[hr][d] += __shfl_xor_sync(0xffffffffu, of[hr][d], 2);
          if (d / PER == t)
            stf(out + (m0 + g + 8 * hr) * LD + h * HD + d, IO<T>::round(of[hr][d] / s[hr]));
        }
      }
    } else {
      if constexpr (!EREG) {
        __syncwarp();
        WarpMma<T, NO, N>::run(
            o, [&](int m, int kk) { return pair(e_s + (m0 + m) * ELD + kk); },
            [&](int kk, int n) { return n < HD ? pair(v + kk * LDQ + n, LDQ) : zero2(); });
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int r = m0 + g + 8 * (q4 >> 1), c = 8 * j + 2 * t + (q4 & 1);
          if (c < HD) stf(out + r * LD + h * HD + c, IO<T>::round(o[j][q4] / s[q4 >> 1]));
        }
      }
    }
    __syncwarp();  // the next head overwrites the warp's e rows
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Kernel 5's launch bounds: blocks of 256 threads per SM, so at most 64, 80
// and 128 registers a thread at C = 24, 48, 96.
__host__ __device__ constexpr int fwd_min_blocks(int C) { return C <= 24 ? 4 : C <= 48 ? 3 : 2; }

// Head groups of the forward's qkv (three at C = 96, whose q, k and v columns
// would not fit beside two blocks per SM; one below), and the width of a
// group's q, k and v each.
__host__ __device__ constexpr int fwd_groups(int C) { return C >= 96 ? 3 : 1; }
__host__ __device__ constexpr int fwd_qkv_width(int C) { return C / fwd_groups(C); }

// Bytes of shared memory of the forward in I/O dtype T: two window buffers,
// a head group's q | k | v, one weight block and, for bf16, the weight
// block's fp32 staging area.
template <typename T>
__host__ __device__ constexpr size_t fwd_smem_bytes(int C) {
  return sizeof(T) * static_cast<size_t>(2 * N * bpad<T>(C) + N * bpad<T>(3 * fwd_qkv_width(C)) +
                                         C * bpad<T>(C)) +
         (Bf16<T>::value ? sizeof(float) * static_cast<size_t>(C) * C : 0);
}

// The forward's weight blocks, each C x C, in the order it uses them: Wq in
// three (with head groups: each group's q, k and v rows), Wp, then W1 and
// W2 of each hidden block; each put into ws (rows bpad<T>(C)
// apart, row n the block's output column n) while no product reads ws.
// Copied by cp.async, which holds no registers while the copy is in flight:
// fp32 into ws itself when put; bf16 into the fp32 staging area st when
// fetched, one block ahead, each thread rounding its own 16-byte chunks into
// ws when put (so no barrier between the copy and the rounding).
template <typename T, int C>
struct FwdWeights {
  static constexpr int QW = fwd_qkv_width(C), LD = bpad<T>(C), Q = C / 4;
  int cur = -1;  // the block fetch() took last

  // cp.async of block i, chunk (row n, columns k .. k + 3) of the block to
  // dst(e, n, k); the weights read from the kernel's parameters where used
  template <typename D>
  __device__ __forceinline__ void copy(const Params& p, int hidden, int i, D dst, int tid) const {
    const float* w;
    int ldw = C, r0 = 0, c0 = 0;
    if (i < 3) {
      w = p.wq;
      r0 = i * QW;
    } else if (i == 3) {
      w = p.wp;
    } else if ((i - 4) % 2 == 0) {
      w = p.w1;
      r0 = (i - 4) / 2 * C;
    } else {
      w = p.w2;
      ldw = hidden;
      c0 = (i - 4) / 2 * C;
    }
    for (int e = tid; e < C * Q; e += THREADS) {
      const int n = e / Q, k = 4 * (e % Q);
      const int row = r0 + (i < 3 ? (n / QW) * C + n % QW : n);
      cp_async16(dst(e, n, k), w + static_cast<size_t>(row) * ldw + c0 + k);
    }
    cp_async_commit();
  }

  // takes the next block (bf16: its copy into st in flight)
  __device__ __forceinline__ void fetch(const Params& p, int hidden, float* st, int tid) {
    ++cur;
    if constexpr (Bf16<T>::value) {
      if (cur < 4 + 2 * (hidden / C))
        copy(p, hidden, cur, [&](int e, int, int) { return st + 4 * e; }, tid);
    }
  }

  // the block fetch() took into ws; wait() before the barrier that hands ws on
  __device__ __forceinline__ void put(const Params& p, int hidden, const float* st, T* ws,
                                      int tid) {
    if constexpr (Bf16<T>::value) {
      cp_async_wait();
      for (int e = tid; e < C * Q; e += THREADS)
        st4(ws + (e / Q) * LD + 4 * (e % Q), ld4(st + 4 * e));
    } else {
      copy(p, hidden, cur, [&](int, int n, int k) { return ws + n * LD + k; }, tid);
    }
  }

  __device__ __forceinline__ void wait() const {
    if constexpr (!Bf16<T>::value) cp_async_wait();
  }
};

// Kernel 5: one block per window, b * nW + w with w the window within its
// image (row-major over the shifted frame); its buffers in the I/O dtype.
template <typename T, int C, int HD>
__global__ void __launch_bounds__(THREADS, fwd_min_blocks(C))
swin_block_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p, int H, int W,
                      int hidden, int shift, float scale_io) {
  constexpr int LD = bpad<T>(C), GROUPS = fwd_groups(C), QW = fwd_qkv_width(C);
  constexpr int LDQ = bpad<T>(3 * QW);
  static_assert(QW % HD == 0, "a head group holds whole heads");
  const int mlp_blocks = hidden / C;

  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);  // N x LD: x; the attention output; n2
  T* as = xs + N * LD;                  // n1; x again, then h, then y
  T* qs = as + N * LD;                  // N x LDQ: a head group's q | k | v; a hidden block of gm
  T* ws = qs + N * LDQ;                 // C x LD: one weight block
  float* st = reinterpret_cast<float*>(ws + C * LD);  // bf16: C x C, the next block in fp32

  const int tid = threadIdx.x;
  // the window's token coordinates and mask row, derived where used
  const auto token = [=] { return WindowTokens(blockIdx.x, H, W, C, shift); };
  const auto w = [=] { return static_cast<int>(blockIdx.x % ((H / WS) * (W / WS))); };
  FwdWeights<T, C> wt;
  wt.fetch(p, hidden, st, tid);  // Wq, block 0
  copy_window_in<T, C, LD>(x, token(), xs, tid);
  wt.put(p, hidden, st, ws, tid);
  wt.fetch(p, hidden, st, tid);  // Wq, block 1
  __syncthreads();
  layer_norm<T, C, LD>(xs, as, p.g1, p.b1, tid);
  wt.wait();
  __syncthreads();

  // q, k, v = round(n1 . Wq + bq) in three C-column products (with head
  // groups: one group's each), the attention after the last (after each)
  for (int blk = 0; blk < 3; ++blk) {
    {
      Proj<T, C> pr(tid);
      pr.mma(as, LD, ws);
      pr.for_each([&](int r, int n, float v) {
        // q kept scaled by hd^-0.5 in the I/O dtype, as the attention uses it
        const int col = (n / QW) * C + blk * QW + n % QW;
        float qkv = IO<T>::round(v + __ldg(p.bq + col));
        if (col < C) qkv = IO<T>::round(qkv * scale_io);
        stf(qs + r * LDQ + (GROUPS == 1 ? blk * C : 0) + n, qkv);
      });
    }
    __syncthreads();
    wt.put(p, hidden, st, ws, tid);  // Wq's next block, or Wp
    wt.fetch(p, hidden, st, tid);
    if (GROUPS == 3 || blk == 2)
      attention_fwd<T, C, HD, QW, true, (Bf16<T>::value || HD < 32 ? 16 : N),
                    (Bf16<T>::value && C >= 96), true>(
          qs, xs, p, w(), scale_io, nullptr, GROUPS == 3 ? blk * (QW / HD) : 0, tid);
    wt.wait();
    __syncthreads();
  }

  // h = round(x + round(att . Wp + bp)), x read again (from L2) over n1
  copy_window_in<T, C, LD>(x, token(), as, tid);
  __syncthreads();
  {
    Proj<T, C> pr(tid);
    pr.mma(xs, LD, ws);
    pr.for_each([&](int r, int n, float v) {
      T* hp = as + r * LD + n;
      stf(hp, IO<T>::round(ldf(hp) + IO<T>::round(v + __ldg(p.bp + n))));
    });
  }
  __syncthreads();
  wt.put(p, hidden, st, ws, tid);  // W1, block 0
  wt.fetch(p, hidden, st, tid);
  layer_norm<T, C, LD>(as, xs, p.g2, p.b2, tid);
  wt.wait();
  __syncthreads();

  // the MLP one hidden block of C columns at a time: gm = round(gelu(n2 . W1
  // + c1)) into qs, its product with W2 summed in registers
  Proj<T, C> acc(tid);
  for (int blk = 0; blk < mlp_blocks; ++blk) {
    {
      Proj<T, C> pr(tid);
      pr.mma(xs, LD, ws);
      pr.for_each([&](int r, int n, float v) {
        const float m = v + __ldg(p.c1 + blk * C + n);
        const float cdf = 0.5f * (1.0f + erff(m * 0.70710678118654752f));
        stf(qs + r * LDQ + n, IO<T>::round(m * cdf));
      });
    }
    __syncthreads();
    wt.put(p, hidden, st, ws, tid);  // W2, block blk
    wt.fetch(p, hidden, st, tid);
    wt.wait();
    __syncthreads();
    acc.mma(qs, LDQ, ws);
    __syncthreads();
    if (blk + 1 < mlp_blocks) {
      wt.put(p, hidden, st, ws, tid);  // W1, block blk + 1
      wt.fetch(p, hidden, st, tid);
      wt.wait();
      __syncthreads();
    }
  }
  // y = round(h + round(gm . W2 + c2)), in place of h
  acc.for_each([&](int r, int n, float v) {
    T* hp = as + r * LD + n;
    stf(hp, IO<T>::round(ldf(hp) + IO<T>::round(v + __ldg(p.c2 + n))));
  });
  __syncthreads();
  copy_window_out<T, C, LD>(as, token(), y, tid);
}

// Kernel 1 of the backward, one block per window: the forward recomputed
// (LN1, qkv, the attention, the projection and residual, LN2, the MLP's first
// product), the MLP's and LN2's backward and the projection's input
// gradient.  Writes the window's rows of n1, qkv, ao, n2, gm, dm1, dh and dao
// and its dg2, db2; no atomics.
template <typename T, int C, int HD>
__global__ void __launch_bounds__(THREADS)
swin_block_bwd_recompute_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                const Params p, const Scratch s, int H, int W, int hidden,
                                int shift, float scale_io) {
  constexpr int LD = bpad<T>(C), LDQ = bpad<T>(3 * C);
  const int mlp_blocks = hidden / C;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x, then h
  float* as = xs + N * LD;                      // n1, then att, then n2
  float* es = as + N * LD;                      // dy, then dh (fp32)
  float* qs = es + N * LD;                      // N x LDQ: qkv; gm | gelu'(m1), dm1 blocks; dn2
  float* ws = qs + N * LDQ;                     // a weight block, or the attention's e tiles
  float* st = ws + weight_region<T>(C);         // N x 2: LayerNorm statistics

  const int win = blockIdx.x, tid = threadIdx.x;
  const WindowTokens token(win, H, W, C, shift);
  const int w = win % ((H / WS) * (W / WS));
  const size_t row0 = static_cast<size_t>(win) * N;
  T* n1_g = static_cast<T*>(s.n1) + row0 * C;
  T* qkv_g = static_cast<T*>(s.qkv) + row0 * 3 * C;
  T* ao_g = static_cast<T*>(s.ao) + row0 * C;
  T* n2_g = static_cast<T*>(s.n2) + row0 * C;
  T* gm_g = static_cast<T*>(s.gm) + row0 * hidden;
  float* dm1_g = s.dm1 + row0 * hidden;
  float* dh_g = s.dh + row0 * C;
  T* dao_g = static_cast<T*>(s.dao) + row0 * C;
  float* ln_w = s.ln + static_cast<size_t>(win) * 4 * C;

  // ---- the forward: n1, qkv, att, h, n2 ----
  // the weight blocks in order, each fetched while the one before is used:
  // Wq (3), Wp, then per MLP block W1, W2^T, W1^T, and Wp^T
  WeightStage<T, C> wst;
  wst.fetch(p.wq, C, 0, 0, false, tid);
  load_window<T, C, LD>(x, token, xs, tid);
  __syncthreads();
  layer_norm<T, C, LD>(xs, as, p.g1, p.b1, tid);
  __syncthreads();
  store_rows<T, C>(n1_g, C, as, LD, tid);
  for (int blk = 0; blk < 3; ++blk) {
    wst.put(ws, tid);
    __syncthreads();
    if (blk < 2)
      wst.fetch(p.wq, C, (blk + 1) * C, 0, false, tid);
    else
      wst.fetch(p.wp, C, 0, 0, false, tid);
    Proj<T, C> pr(tid);
    pr.mma(as, LD, ws);
    pr.for_each([&](int r, int n, float v) {
      qs[r * LDQ + blk * C + n] = IO<T>::round(v + __ldg(p.bq + blk * C + n));
    });
    __syncthreads();
  }
  store_rows<T, 3 * C>(qkv_g, 3 * C, qs, LDQ, tid);
  attention_fwd<T, C, HD>(qs, as, p, w, scale_io, ws, 0, tid);
  __syncthreads();
  store_rows<T, C>(ao_g, C, as, LD, tid);
  wst.put(ws, tid);
  __syncthreads();
  wst.fetch(p.w1, C, 0, 0, false, tid);
  {
    Proj<T, C> pr(tid);
    pr.mma(as, LD, ws);
    pr.for_each([&](int r, int n, float v) {
      const float pv = IO<T>::round(v + __ldg(p.bp + n));
      xs[r * LD + n] = IO<T>::round(xs[r * LD + n] + pv);
    });
  }
  __syncthreads();
  layer_norm<T, C, LD>(xs, as, p.g2, p.b2, tid);
  load_window<T, C, LD>(dy, token, es, tid);
  __syncthreads();
  store_rows<T, C>(n2_g, C, as, LD, tid);

  // ---- the MLP, one hidden block of C columns at a time; dn2 in registers ----
  Proj<T, C> dn2(tid);
  for (int blk = 0; blk < mlp_blocks; ++blk) {
    wst.put(ws, tid);  // W1[block]
    __syncthreads();
    wst.fetch(p.w2, hidden, 0, blk * C, true, tid);
    {
      Proj<T, C> pr(tid);
      pr.mma(as, LD, ws);
      pr.for_each([&](int r, int n, float v) {
        const float m = v + __ldg(p.c1 + blk * C + n);
        float cdf, phi;
        gelu_parts(m, cdf, phi);
        qs[r * LDQ + n] = IO<T>::round(m * cdf);
        qs[r * LDQ + C + n] = cdf + m * phi;
      });
    }
    __syncthreads();
    store_rows<T, C>(gm_g + blk * C, hidden, qs, LDQ, tid);
    // dm1 = (dy . round(W2[:, block])) * gelu'(m1)
    wst.put(ws, tid);
    __syncthreads();
    wst.fetch(p.w1, C, blk * C, 0, true, tid);
    {
      Proj<T, C> pd(tid);
      pd.mma(es, LD, ws);
      pd.for_each([&](int r, int n, float v) { qs[r * LDQ + C + n] *= v; });
    }
    __syncthreads();
    store_rows<float, C>(dm1_g + blk * C, hidden, qs + C, LDQ, tid);
    // dn2 += round(dm1) . round(W1[block])
    wst.put(ws, tid);
    __syncthreads();
    if (blk + 1 < mlp_blocks)
      wst.fetch(p.w1, C, (blk + 1) * C, 0, false, tid);
    else
      wst.fetch(p.wp, C, 0, 0, true, tid);
    dn2.mma(qs + C, LDQ, ws);
    __syncthreads();
  }
  dn2.for_each([&](int r, int n, float v) { qs[r * LDQ + n] = v; });
  __syncthreads();
  // dh = dy + LN2'(dn2), in place of dy
  layer_norm_bwd<C, LD>(xs, qs, LDQ, es, p.g2, ln_w + 2 * C, ln_w + 3 * C, st, tid);
  store_rows<float, C>(dh_g, C, es, LD, tid);
  // dao = round(round(dh) . round(Wp)), over h
  wst.put(ws, tid);
  __syncthreads();
  {
    Proj<T, C> pa(tid);
    pa.mma(es, LD, ws);
    pa.for_each([&](int r, int n, float v) { xs[r * LD + n] = IO<T>::round(v); });
  }
  __syncthreads();
  store_rows<T, C>(dao_g, C, xs, LD, tid);
}

// One window's q, k, v and dao columns of one head (64 x HD each, from
// qkv and dao rows 3C and C apart), fetched into registers and put into
// four 64 x head_ld(HD) tiles, q scaled by hd^-0.5 in the I/O dtype.
template <typename T, int C, int HD>
struct HeadStage {
  static constexpr int Q = HD / 4, ELEMS = 4 * N * Q;
  static constexpr int E = (ELEMS + ATT_THREADS - 1) / ATT_THREADS;
  float v[E][4];

  __device__ __forceinline__ void fetch(const T* qkv_w, const T* dao_w, int tid) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * ATT_THREADS;
      const int a = e / (N * Q), t = (e / Q) % N, c = 4 * (e % Q);
      if (e < ELEMS)
        IO<T>::load4(a < 3 ? qkv_w + static_cast<size_t>(t) * 3 * C + a * C + c
                           : dao_w + static_cast<size_t>(t) * C + c,
                     v[i]);
    }
  }

  __device__ __forceinline__ void put(float* q_s, float scale_io, int tid) const {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * ATT_THREADS;
      const int a = e / (N * Q), t = (e / Q) % N, c = 4 * (e % Q);
      const float mul = a == 0 ? scale_io : 1.0f;
      if (e < ELEMS)
        st4(q_s + (a * N + t) * head_ld(HD) + c,
            make_float4(IO<T>::round(v[i][0] * mul), IO<T>::round(v[i][1] * mul),
                        IO<T>::round(v[i][2] * mul), IO<T>::round(v[i][3] * mul)));
    }
  }
};

// Kernel 2: the window attention's backward.  Block (h, chunk) owns head h
// of windows chunk * per_block .. (+ per_block): the head's bias tile is
// staged once, its dbias summed in registers over those windows and written
// once to bpart.  Per window, warp w takes query rows 16 w .. 16 w + 15: the
// logits once (q k^T + bias + mask), e = round(exp(clip)), s, e v, gg =
// dao / s, ds, de = round(gg) v^T + ds, dsim = round(e32 de) where |sim| <
// 60, dq = dsim k; then key rows 16 w ..: dk = dsim^T q, dv = e^T round(gg)
// from the e and dsim tiles in shared memory.  dq, dk, dv (rounded) replace
// the head's q, k, v columns of qkv.
template <typename T, int C, int HD>
__global__ void __launch_bounds__(ATT_THREADS, attention_blocks_per_sm(HD))
swin_block_bwd_attention_kernel(T* qkv, const T* __restrict__ dao,
                                const float* __restrict__ bias, const float* __restrict__ mask,
                                float* bpart, int nW, int windows, int per_block, float scale_io,
                                float scale) {
  constexpr int HEADS = C / HD, LH = head_ld(HD), LQ = 3 * C;
  constexpr int HK = HeadK<T, HD>::value, NO = (HD + 7) / 8;
  extern __shared__ float4 smem4[];
  float* bias_s = reinterpret_cast<float*>(smem4);  // 64 x ELD each
  float* e_s = bias_s + N * ELD;
  float* ds_s = e_s + N * ELD;
  float* q_s = ds_s + N * ELD;  // 64 x LH each: q scaled, k, v, dao, round(gg)
  float* k_s = q_s + N * LH;
  float* v_s = k_s + N * LH;
  float* d_s = v_s + N * LH;
  float* gg_s = d_s + N * LH;

  const int h = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (tid >> 5);
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  for (int e = tid; e < N * N / 4; e += ATT_THREADS) {
    const int r = e / (N / 4), c = 4 * (e % (N / 4));
    st4(bias_s + r * ELD + c, __ldg(reinterpret_cast<const float4*>(bias_h + r * N + c)));
  }
  float db[8][4];
  zero_tiles(db);
  const int w_begin = blockIdx.y * per_block;
  const int w_end = min(windows, w_begin + per_block);
  // the next window's inputs in flight while this one is worked on (up to
  // head dim 16: 32 registers)
  constexpr bool AHEAD = HD <= 16;
  HeadStage<T, C, HD> stage;
  const auto fetch = [&](int win) {
    stage.fetch(qkv + static_cast<size_t>(win) * N * LQ + h * HD,
                dao + static_cast<size_t>(win) * N * C + h * HD, tid);
  };
  if (AHEAD && w_begin < w_end) fetch(w_begin);
  for (int win = w_begin; win < w_end; ++win) {
    T* qkv_w = qkv + static_cast<size_t>(win) * N * LQ + h * HD;
    if (!AHEAD) fetch(win);
    stage.put(q_s, scale_io, tid);
    __syncthreads();
    if (AHEAD && win + 1 < w_end) fetch(win + 1);

    // the logits of the warp's query rows, once; e and its row sums
    float sim[8][4];
    zero_tiles(sim);
    WarpMma<T, 8, HK>::run(
        sim, [&](int m, int k) { return k < HD ? pair(q_s + (m0 + m) * LH + k) : zero2(); },
        [&](int k, int n) { return k < HD ? pair(k_s + n * LH + k) : zero2(); });
    const float* mask_w = mask ? mask + static_cast<size_t>(win % nW) * N * N : nullptr;
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        const float2 b2 = *reinterpret_cast<const float2*>(bias_s + r * ELD + c);
        float x0 = sim[j][2 * hr] + b2.x, x1 = sim[j][2 * hr + 1] + b2.y;
        if (mask_w) {
          const float2 m2 = __ldg(reinterpret_cast<const float2*>(mask_w + r * N + c));
          x0 += m2.x;
          x1 += m2.y;
        }
        const float e0 = clipped_exp(x0), e1 = clipped_exp(x1);
        // e32, negated outside the clip (dsim is 0 there); e = round(e32)
        put2(e_s + r * ELD + c, fabsf(x0) < CLIP ? e0 : -e0, fabsf(x1) < CLIP ? e1 : -e1);
        s[hr] += IO<T>::round(e0) + IO<T>::round(e1);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 1);
      s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 2);
    }
    __syncwarp();
    // ctx = e v; gg = dao / s; ds = -(gg . ctx) / s
    float ctx[NO][4];
    zero_tiles(ctx);
    WarpMma<T, NO, N>::run(
        ctx, [&](int m, int k) { return rounded_abs<T>(pair(e_s + (m0 + m) * ELD + k)); },
        [&](int k, int n) { return n < HD ? pair(v_s + k * LH + n, LH) : zero2(); });
    float dsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        if (c < HD) {
          const float g0 = d_s[r * LH + c] / s[hr], g1 = d_s[r * LH + c + 1] / s[hr];
          dsum[hr] = fmaf(g0, ctx[j][2 * hr], dsum[hr]);
          dsum[hr] = fmaf(g1, ctx[j][2 * hr + 1], dsum[hr]);
          gg_s[r * LH + c] = IO<T>::round(g0);
          gg_s[r * LH + c + 1] = IO<T>::round(g1);
        }
      }
    }
    float dsr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dsum[hr] += __shfl_xor_sync(0xffffffffu, dsum[hr], 1);
      dsum[hr] += __shfl_xor_sync(0xffffffffu, dsum[hr], 2);
      dsr[hr] = -dsum[hr] / s[hr];
    }
    __syncwarp();
    // de = round(gg) v^T + ds; dsim = round(e32 de) inside the clip
    float de[8][4];
    zero_tiles(de);
    WarpMma<T, 8, HK>::run(
        de, [&](int m, int k) { return k < HD ? pair(gg_s + (m0 + m) * LH + k) : zero2(); },
        [&](int k, int n) { return k < HD ? pair(v_s + n * LH + k) : zero2(); });
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        const float2 e2 = pair(e_s + r * ELD + c);
        const float ev[2] = {e2.x, e2.y};
        float d2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          d2[u] = ev[u] > 0.0f ? IO<T>::round(ev[u] * (de[j][2 * hr + u] + dsr[hr])) : 0.0f;
          db[j][2 * hr + u] += d2[u];
        }
        put2(ds_s + r * ELD + c, d2[0], d2[1]);
      }
    }
    __syncwarp();
    // dq = dsim k, scaled by hd^-0.5 (fp32) and rounded
    float dq[NO][4];
    zero_tiles(dq);
    WarpMma<T, NO, N>::run(
        dq, [&](int m, int k) { return pair(ds_s + (m0 + m) * ELD + k); },
        [&](int k, int n) { return n < HD ? pair(k_s + k * LH + n, LH) : zero2(); });
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        if (c < HD) put2(qkv_w + r * LQ + c, dq[j][2 * hr] * scale, dq[j][2 * hr + 1] * scale);
      }
    }
    __syncthreads();
    // key rows m0 ..: dk = dsim^T q, dv = e^T round(gg)
    float dk[NO][4], dv[NO][4];
    zero_tiles(dk);
    zero_tiles(dv);
    WarpMma<T, NO, N>::run(
        dk, [&](int m, int k) { return pair(ds_s + k * ELD + m0 + m, ELD); },
        [&](int k, int n) { return n < HD ? pair(q_s + k * LH + n, LH) : zero2(); });
    WarpMma<T, NO, N>::run(
        dv, [&](int m, int k) { return rounded_abs<T>(pair(e_s + k * ELD + m0 + m, ELD)); },
        [&](int k, int n) { return n < HD ? pair(gg_s + k * LH + n, LH) : zero2(); });
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        if (c < HD) {
          put2(qkv_w + C + r * LQ + c, dk[j][2 * hr], dk[j][2 * hr + 1]);
          put2(qkv_w + 2 * C + r * LQ + c, dv[j][2 * hr], dv[j][2 * hr + 1]);
        }
      }
    }
    __syncthreads();
  }
  float* out = bpart + (static_cast<size_t>(blockIdx.y) * HEADS + h) * N * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
      put2(out + r * N + c, db[j][2 * hr], db[j][2 * hr + 1]);
    }
  }
}

// Kernel 3, one block per window: dn1 = dqkv . round(Wq), then dx =
// round(dh + LN1'(dn1)) and the window's dg1, db1.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
swin_block_bwd_input_kernel(const T* __restrict__ x, T* __restrict__ dx, const Params p,
                            const Scratch s, int H, int W, int shift) {
  constexpr int LD = bpad<T>(C), LDQ = bpad<T>(3 * C), Q = C / 4;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x
  float* es = xs + N * LD;                      // dh, then dx
  float* qs = es + N * LD;                      // N x LDQ: dqkv, then dn1
  float* ws = qs + N * LDQ;                     // a weight block
  float* st = ws + C * LD;

  const int win = blockIdx.x, tid = threadIdx.x;
  const WindowTokens token(win, H, W, C, shift);
  const size_t row0 = static_cast<size_t>(win) * N;
  float* ln_w = s.ln + static_cast<size_t>(win) * 4 * C;
  WeightStage<T, C> wst;
  wst.fetch(p.wq, C, 0, 0, true, tid);
  load_window<T, C, LD>(x, token, xs, tid);
  load_rows<T, 3 * C>(static_cast<const T*>(s.qkv) + row0 * 3 * C, 3 * C, qs, LDQ, tid);
  load_rows<float, C>(s.dh + row0 * C, C, es, LD, tid);
  Proj<T, C> acc(tid);
  for (int blk = 0; blk < 3; ++blk) {
    wst.put(ws, tid);
    __syncthreads();
    if (blk < 2) wst.fetch(p.wq, C, (blk + 1) * C, 0, true, tid);
    acc.mma(qs + blk * C, LDQ, ws);
    __syncthreads();
  }
  acc.for_each([&](int r, int n, float v) { qs[r * LDQ + n] = v; });
  __syncthreads();
  layer_norm_bwd<C, LD>(xs, qs, LDQ, es, p.g1, ln_w, ln_w + C, st, tid);
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    IO<T>::store4(dx + token(t) + c, es + t * LD + c);
  }
}

// KW windows of tokens from t0 (zeros from t_end on), C columns each:
// fetched into registers, so that the next chunk's loads are in flight while
// the current one is used, then put into rows pad(C) floats apart.  The
// source: window-ordered rows ld apart from column off, or (image) an
// image-layout tensor's tokens through their windows' coordinates.
template <int C, int KW>
struct TokenStage {
  static constexpr int Q = C / 4, ELEMS = KW * N * Q;
  static constexpr int E = (ELEMS + THREADS - 1) / THREADS;
  float v[E][4];

  template <typename S>
  __device__ __forceinline__ void fetch(const S* __restrict__ src, int ld, int off, int t0,
                                        int t_end, bool image, int H, int W, int shift,
                                        int tid) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * THREADS;
      const int t = e / Q, c = 4 * (e % Q), tok = t0 + t;
      v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.0f;
      if (e < ELEMS && tok < t_end) {
        const size_t at = image ? WindowTokens(tok / N, H, W, C, shift)(tok % N)
                                : static_cast<size_t>(tok) * ld + off;
        IO<S>::load4(src + at + c, v[i]);
      }
    }
  }

  __device__ __forceinline__ void put(float* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * THREADS;
      if (e < ELEMS)
        st4(dst + (e / Q) * pad(C) + 4 * (e % Q), make_float4(v[i][0], v[i][1], v[i][2], v[i][3]));
    }
  }
};

// A C x C weight-gradient tile summed over staged chunks of KT tokens:
//   acc[n][k] += sum over t < KT of a[t * pad(C) + n] b[t * pad(C) + k],
// and stored (not added) to out[n * ld + k].
template <typename T, int C>
struct WeightAcc;

// fp32: a register tile on CUDA cores, CG column groups by RG row groups
// (rows past C idle)
template <int C>
struct WeightAcc<float, C> {
  static constexpr int CG = C % 16 == 0 ? 16 : 8;
  static constexpr int TC = C / CG;
  static constexpr int RG = THREADS / CG;
  static constexpr int TR = (C + RG - 1) / RG;
  float acc[TR][TC];
  int rg, cg;
  __device__ explicit WeightAcc(int tid) : rg(tid / CG), cg(tid % CG) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
  }
  template <int KT>
  __device__ __forceinline__ void add(const float* a, const float* b, bool) {
    constexpr int LD = pad(C);
#pragma unroll 2
    for (int t = 0; t < KT; ++t) {
      float av[TR], bv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int n = rg + RG * i;
        av[i] = n < C ? a[t * LD + n] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) bv[j] = b[t * LD + cg + CG * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* out, int ld) const {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int n = rg + RG * i;
      if (n < C) {
#pragma unroll
        for (int j = 0; j < TC; ++j) out[n * ld + cg + CG * j] = acc[i][j];
      }
    }
  }
};

// bf16: tensor cores, the staged tokens the reduction; warp w takes the 16-row
// tiles w % 2 + 2 i and the 8-column tiles w / 2 + 4 j (rows past C zero).
// An fp32 operand a (dm1, dh) is split into two bf16 parts (SPLIT).
template <int C>
struct WeightAcc<__nv_bfloat16, C> {
  static constexpr int MT = (C + 15) / 16, NTL = C / 8;
  static constexpr int MI = (MT + 1) / 2, NJ = (NTL + 3) / 4;
  float acc[MI][NJ][4];
  int wr, wc;
  __device__ explicit WeightAcc(int tid) : wr((tid >> 5) & 1), wc(tid >> 6) {
#pragma unroll
    for (int i = 0; i < MI; ++i) zero_tiles(acc[i]);
  }
  template <int KT, bool SPLIT>
  __device__ __forceinline__ void tile(int i, const float* a, const float* b) {
    constexpr int LD = pad(C);
    const int mt = wr + 2 * i, c0 = wc;
    WarpMma<__nv_bfloat16, NJ, KT, SPLIT>::run(
        acc[i],
        [&](int m, int k) {
          const int row = 16 * mt + m;
          return row < C ? pair(a + k * LD + row, LD) : zero2();
        },
        [&](int k, int n) {
          const int nt = c0 + 4 * (n >> 3);
          return nt < NTL ? pair(b + k * LD + 8 * nt + (n & 7), LD) : zero2();
        });
  }
  template <int KT>
  __device__ __forceinline__ void add(const float* a, const float* b, bool split) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (wr + 2 * i >= MT) continue;
      if (split)
        tile<KT, true>(i, a, b);
      else
        tile<KT, false>(i, a, b);
    }
  }
  __device__ __forceinline__ void store(float* out, int ld) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int mt = wr + 2 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nt = wc + 4 * j;
        if (mt >= MT || nt >= NTL) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 16 * mt + g + 8 * (q >> 1);
          if (row < C) out[row * ld + 8 * nt + 2 * t + (q & 1)] = acc[i][j][q];
        }
      }
    }
  }
};

// Kernel 4: every weight gradient as C x C blocks, each a product over the
// token axis split into ranges of split_tokens.  Block (split, blk) sums its
// range, weight_windows(C) windows of tokens at a time (the next ones' loads in
// flight), and stores its tile and the
// column sums of its left operand (a bias-vector gradient) into its split's
// partial:
//   blk < R (= hidden / C):  dW2[:, blk C ..]     = dy^T gm,   dc2 (blk 0)
//   blk < 2R:               dW1[(blk - R) C ..]  = dm1^T n2,  dc1
//   blk = 2R:               dWp                  = dh^T ao,   dbp
//   blk > 2R:               dWq[(blk-2R-1) C ..] = dqkv^T n1, dbq
template <typename T, int C>
__global__ void __launch_bounds__(THREADS, weight_blocks_per_sm(C))
swin_block_bwd_weights_kernel(const T* __restrict__ dy, const Scratch s, int H, int W, int hidden,
                              int shift, int tokens, int split_tokens) {
  constexpr int LD = pad(C), KW = weight_windows(C), KT = KW * N;
  const int R = hidden / C, blk = blockIdx.y, tid = threadIdx.x;
  const PartLayout L{C, hidden};
  const void* a_src;
  const T* b_src;
  int a_ld, a_off = 0, b_ld = C, b_off = 0, dst, dst_ld = C, vec;
  bool a_f32 = false, a_image = false;
  if (blk < R) {
    a_src = dy;
    a_ld = C;
    a_image = true;
    b_src = static_cast<const T*>(s.gm);
    b_ld = hidden;
    b_off = blk * C;
    dst = L.w2() + blk * C;
    dst_ld = hidden;
    vec = blk == 0 ? L.c2() : -1;
  } else if (blk < 2 * R) {
    const int b = blk - R;
    a_src = s.dm1;
    a_ld = hidden;
    a_off = b * C;
    a_f32 = true;
    b_src = static_cast<const T*>(s.n2);
    dst = L.w1() + b * C * C;
    vec = L.c1() + b * C;
  } else if (blk == 2 * R) {
    a_src = s.dh;
    a_ld = C;
    a_f32 = true;
    b_src = static_cast<const T*>(s.ao);
    dst = L.wp();
    vec = L.bp();
  } else {
    const int b = blk - 2 * R - 1;
    a_src = s.qkv;
    a_ld = 3 * C;
    a_off = b * C;
    b_src = static_cast<const T*>(s.n1);
    dst = L.wq() + b * C * C;
    vec = L.bq() + b * C;
  }

  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // KT x LD each
  float* b_s = a_s + KT * LD;
  WeightAcc<T, C> acc(tid);
  constexpr int PARTS = THREADS / C;  // threads per column of the column sums
  const int col = tid % C, part = tid / C;
  float colsum = 0.0f;
  const int t_begin = blockIdx.x * split_tokens;
  const int t_end = min(tokens, t_begin + split_tokens);
  TokenStage<C, KW> sa, sb;
  const auto fetch = [&](int t0) {
    if (a_f32)
      sa.fetch(static_cast<const float*>(a_src), a_ld, a_off, t0, t_end, false, H, W, shift, tid);
    else
      sa.fetch(static_cast<const T*>(a_src), a_ld, a_off, t0, t_end, a_image, H, W, shift, tid);
    sb.fetch(b_src, b_ld, b_off, t0, t_end, false, H, W, shift, tid);
  };
  if (t_begin < t_end) fetch(t_begin);
  for (int t0 = t_begin; t0 < t_end; t0 += KT) {
    sa.put(a_s, tid);
    sb.put(b_s, tid);
    __syncthreads();
    if (t0 + KT < t_end) fetch(t0 + KT);
    if (part < PARTS) {
      for (int t = part; t < KT; t += PARTS) colsum += a_s[t * LD + col];
    }
    acc.template add<KT>(a_s, b_s, a_f32);
    __syncthreads();
  }
  float* out = s.wpart + static_cast<size_t>(blockIdx.x) * L.size();
  acc.store(out + dst, dst_ld);
  if (part < PARTS) a_s[part * C + col] = colsum;
  __syncthreads();
  if (vec >= 0 && tid < C) {
    float sum = 0.0f;
    for (int q = 0; q < PARTS; ++q) sum += a_s[q * C + tid];
    out[vec + tid] = sum;
  }
}

// Kernel 5: each gradient summed over its partials in a fixed order (one
// thread per element, or with many partials one warp: lane-strided sums and
// a shuffle tree), so a launch's gradients are the same bits run to run.
struct Segment {
  float* dst;
  const float* src;  // partial c of element i at src[c * stride + i]
  long long stride;
  int n, count, lanes, first_block;
};
constexpr int MAX_SEGMENTS = 13;
struct Segments {
  Segment seg[MAX_SEGMENTS];
  int num;
};

__global__ void __launch_bounds__(THREADS) swin_block_bwd_reduce_kernel(const Segments ss) {
  int si = 0;
  while (si + 1 < ss.num && static_cast<int>(blockIdx.x) >= ss.seg[si + 1].first_block) ++si;
  const Segment& sg = ss.seg[si];
  const int i = (blockIdx.x - sg.first_block) * (THREADS / sg.lanes) + threadIdx.x / sg.lanes;
  const int lane = threadIdx.x % sg.lanes;
  float v = 0.0f;
  if (i < sg.n) {
    for (int c = lane; c < sg.count; c += sg.lanes) v += sg.src[c * sg.stride + i];
  }
  for (int off = sg.lanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (i < sg.n && lane == 0) sg.dst[i] = v;
}

// One launch's arguments, as the C entry points take them.
struct Args {
  const void* x;
  const void* dy;  // backward only
  void* out;       // forward: y; backward: dx
  Params p;
  Grads gr;        // backward only
  Scratch s;       // backward only
  int B, H, W, C, heads, hidden, shift;
  float scale_io;  // hd^-0.5 rounded to the I/O dtype: scales q
  float scale;     // hd^-0.5 in fp32: scales dq (backward only)
  int per_block;   // backward: windows per attention block
  int split_tokens;  // backward: tokens per weight-gradient split (a multiple of 64)
};

// Raises Kernel's dynamic shared-memory limit to `smem` bytes (the same at
// every call for one instantiation) on the first call on each device, not
// on every call.
template <auto Kernel>
cudaError_t prepare(size_t smem) {
  static std::atomic<unsigned long long> ready{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launches Kernel with `smem_floats_` floats of dynamic shared memory and
// returns the launch's error.
template <auto Kernel, typename... A>
cudaError_t launch(size_t smem_floats_, dim3 grid, int threads, cudaStream_t stream, A... args) {
  const size_t smem = smem_floats_ * sizeof(float);
  const cudaError_t err = prepare<Kernel>(smem);
  if (err != cudaSuccess) return err;
  Kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Fwd {
  template <typename T, int C, int HD>
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const long long blocks = static_cast<long long>(a.B) * (a.H / WS) * (a.W / WS);
    return launch<swin_block_fwd_kernel<T, C, HD>>(
        fwd_smem_bytes<T>(C) / sizeof(float), dim3(static_cast<unsigned>(blocks)), THREADS, stream,
        static_cast<const T*>(a.x), static_cast<T*>(a.out), a.p, a.H, a.W, a.hidden, a.shift,
        a.scale_io);
  }
};

// The forward's resident blocks per SM on this device (a.out: an int).
struct FwdOccupancy {
  template <typename T, int C, int HD>
  static cudaError_t run(const Args& a, cudaStream_t) {
    const size_t smem = fwd_smem_bytes<T>(C);
    const cudaError_t err = prepare<swin_block_fwd_kernel<T, C, HD>>(smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        static_cast<int*>(a.out), swin_block_fwd_kernel<T, C, HD>, THREADS, smem);
  }
};

struct Bwd {
  template <typename T, int C, int HD>
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const int nW = (a.H / WS) * (a.W / WS);
    const int windows = a.B * nW, tokens = windows * N;
    const int heads = C / HD, R = a.hidden / C;
    const int chunks = (windows + a.per_block - 1) / a.per_block;
    const int splits = (tokens + a.split_tokens - 1) / a.split_tokens;
    const T* x = static_cast<const T*>(a.x);
    const T* dy = static_cast<const T*>(a.dy);
    cudaError_t err = launch<swin_block_bwd_recompute_kernel<T, C, HD>>(
        recompute_smem_floats<T>(C), dim3(windows), THREADS, stream, x, dy, a.p, a.s, a.H, a.W,
        a.hidden, a.shift, a.scale_io);
    if (err != cudaSuccess) return err;
    err = launch<swin_block_bwd_attention_kernel<T, C, HD>>(
        attention_smem_floats(HD), dim3(heads, chunks), ATT_THREADS, stream,
        static_cast<T*>(a.s.qkv), static_cast<const T*>(a.s.dao), a.p.bias, a.p.mask, a.s.bpart,
        nW, windows, a.per_block, a.scale_io, a.scale);
    if (err != cudaSuccess) return err;
    err = launch<swin_block_bwd_input_kernel<T, C>>(input_smem_floats<T>(C), dim3(windows),
                                                    THREADS, stream, x, static_cast<T*>(a.out),
                                                    a.p, a.s, a.H, a.W, a.shift);
    if (err != cudaSuccess) return err;
    err = launch<swin_block_bwd_weights_kernel<T, C>>(weights_smem_floats(C),
                                                      dim3(splits, 2 * R + 4), THREADS, stream,
                                                      dy, a.s, a.H, a.W, a.hidden, a.shift,
                                                      tokens, a.split_tokens);
    if (err != cudaSuccess) return err;

    const PartLayout L{C, a.hidden};
    const long long P = L.size();
    Segments ss{};
    int blocks = 0;
    const auto add = [&](float* dst, const float* src, long long stride, int n, int count) {
      Segment& sg = ss.seg[ss.num++];
      sg = {dst, src, stride, n, count, count >= 64 ? 32 : 1, blocks};
      const int per = THREADS / sg.lanes;
      blocks += (n + per - 1) / per;
    };
    const float* ln = a.s.ln;
    const float* wp = a.s.wpart;
    add(a.gr.g1, ln, 4 * C, C, windows);
    add(a.gr.b1, ln + C, 4 * C, C, windows);
    add(a.gr.wq, wp + L.wq(), P, 3 * C * C, splits);
    add(a.gr.bq, wp + L.bq(), P, 3 * C, splits);
    add(a.gr.bias, a.s.bpart, static_cast<long long>(heads) * N * N, heads * N * N, chunks);
    add(a.gr.wp, wp + L.wp(), P, C * C, splits);
    add(a.gr.bp, wp + L.bp(), P, C, splits);
    add(a.gr.g2, ln + 2 * C, 4 * C, C, windows);
    add(a.gr.b2, ln + 3 * C, 4 * C, C, windows);
    add(a.gr.w1, wp + L.w1(), P, a.hidden * C, splits);
    add(a.gr.c1, wp + L.c1(), P, a.hidden, splits);
    add(a.gr.w2, wp + L.w2(), P, C * a.hidden, splits);
    add(a.gr.c2, wp + L.c2(), P, C, splits);
    swin_block_bwd_reduce_kernel<<<blocks, THREADS, 0, stream>>>(ss);
    return cudaGetLastError();
  }
};

template <typename Op, typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const int hd = a.C / a.heads;
  switch (a.C) {
    case 24:
      if (hd == 4) return Op::template run<T, 24, 4>(a, s);
      if (hd == 8) return Op::template run<T, 24, 8>(a, s);
      break;
    case 48:
      if (hd == 4) return Op::template run<T, 48, 4>(a, s);
      if (hd == 8) return Op::template run<T, 48, 8>(a, s);
      if (hd == 16) return Op::template run<T, 48, 16>(a, s);
      break;
    case 96:
      if (hd == 4) return Op::template run<T, 96, 4>(a, s);
      if (hd == 8) return Op::template run<T, 96, 8>(a, s);
      if (hd == 16) return Op::template run<T, 96, 16>(a, s);
      if (hd == 32) return Op::template run<T, 96, 32>(a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename Op>
int checked_dispatch(const Args& a, int is_bf16, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.W <= 0 || a.H % WS || a.W % WS || a.heads <= 0 ||
      a.C % a.heads || a.hidden <= 0 || a.hidden % a.C || a.hidden / a.C > MAX_MLP_RATIO ||
      a.shift < 0 || a.shift >= WS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<Op, __nv_bfloat16>(a, s) : dispatch<Op, float>(a, s));
}

const float* f32(const void* q) { return static_cast<const float*>(q); }
float* f32w(void* q) { return static_cast<float*>(q); }

}  // namespace

// x, y (B, H, W, C) fp32 or bf16; every parameter fp32 in nn.Linear's (out,
// in) layout: g1, b1 (C); wq (3C, C), bq (3C); bias (heads, 64, 64); mask
// (nW, 64, 64) or null; wp (C, C), bp, g2, b2 (C); w1 (hidden, C), c1
// (hidden); w2 (C, hidden), c2 (C).  All contiguous and 16-byte aligned.  C
// in {24, 48, 96}, C / heads in {4, 8, 16, 32}, hidden = C * {1..4}, H and W
// multiples of 8, 0 <= shift < 8; scale is hd^-0.5 rounded to the I/O dtype.
// Launches on `stream` and returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int dmh_swin_block_fwd(const void* x, void* y, const void* g1, const void* b1,
                                  const void* wq, const void* bq, const void* bias,
                                  const void* mask, const void* wp, const void* bp,
                                  const void* g2, const void* b2, const void* w1,
                                  const void* c1, const void* w2, const void* c2, int B, int H,
                                  int W, int C, int heads, int hidden, int shift, float scale,
                                  int is_bf16, void* stream) {
  const Args a{x, nullptr, y,
               {f32(g1), f32(b1), f32(wq), f32(bq), f32(bias), f32(mask), f32(wp), f32(bp),
                f32(g2), f32(b2), f32(w1), f32(c1), f32(w2), f32(c2)},
               {}, {}, B, H, W, C, heads, hidden, shift, scale, 0.0f, 0, 0};
  return checked_dispatch<Fwd>(a, is_bf16, stream);
}

// The backward's scratch for a launch with the plan per_block, split_tokens:
// off[0..10] the byte offsets of n1, qkv, ao, n2, gm (I/O dtype), dm1, dh
// (fp32), dao (I/O), each (B * nW * 64, width) in window order; ln (B * nW,
// 4C), wpart (splits, PartLayout), bpart (chunks, heads, 64, 64), fp32; and
// off[11] the bytes to allocate.  Returns 0, or cudaErrorInvalidValue for
// arguments the backward refuses.
extern "C" int dmh_swin_block_bwd_scratch_layout(int B, int H, int W, int C, int heads,
                                                 int hidden, int per_block, int split_tokens,
                                                 int is_bf16, long long* off) {
  if (B <= 0 || H <= 0 || W <= 0 || H % WS || W % WS || heads <= 0 || C % heads ||
      hidden <= 0 || per_block <= 0 || split_tokens <= 0 || split_tokens % N)
    return static_cast<int>(cudaErrorInvalidValue);
  scratch_layout(static_cast<long long>(B) * (H / WS) * (W / WS), C, heads, hidden, per_block,
                 split_tokens, is_bf16 != 0, off);
  return 0;
}

// The forward's arguments, plus dy (the gradient of y) and dx in the I/O
// dtype; the 13 fp32 parameter gradients in the parameters' order and
// layouts (written, not added to); one scratch allocation of scratch_bytes
// bytes, 256-byte aligned, at least dmh_swin_block_bwd_scratch_layout's
// size; scale_dq = hd^-0.5 in fp32; the plan: per_block windows per
// attention block and split_tokens tokens per weight-gradient split (a
// positive multiple of 64).  Five launches on `stream`; returns the first
// error, cudaErrorInvalidValue for a scratch too small.
extern "C" int dmh_swin_block_bwd(
    const void* x, const void* dy, void* dx, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* bias, const void* mask, const void* wp, const void* bp,
    const void* g2, const void* b2, const void* w1, const void* c1, const void* w2,
    const void* c2, void* dg1, void* db1, void* dwq, void* dbq, void* dbias, void* dwp, void* dbp,
    void* dg2, void* db2, void* dw1, void* dc1, void* dw2, void* dc2, void* scratch,
    long long scratch_bytes, int B, int H, int W, int C, int heads, int hidden, int shift,
    float scale, float scale_dq, int per_block, int split_tokens, int is_bf16, void* stream) {
  long long off[SCRATCH_BUFFERS + 1];
  if (dmh_swin_block_bwd_scratch_layout(B, H, W, C, heads, hidden, per_block, split_tokens,
                                        is_bf16, off) != 0 ||
      scratch_bytes < off[SCRATCH_BUFFERS] || reinterpret_cast<uintptr_t>(scratch) % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  char* sc = static_cast<char*>(scratch);
  const Args a{x, dy, dx,
               {f32(g1), f32(b1), f32(wq), f32(bq), f32(bias), f32(mask), f32(wp), f32(bp),
                f32(g2), f32(b2), f32(w1), f32(c1), f32(w2), f32(c2)},
               {f32w(dg1), f32w(db1), f32w(dwq), f32w(dbq), f32w(dbias), f32w(dwp), f32w(dbp),
                f32w(dg2), f32w(db2), f32w(dw1), f32w(dc1), f32w(dw2), f32w(dc2)},
               {sc + off[0], sc + off[1], sc + off[2], sc + off[3], sc + off[4],
                f32w(sc + off[5]), f32w(sc + off[6]), sc + off[7], f32w(sc + off[8]),
                f32w(sc + off[9]), f32w(sc + off[10])},
               B, H, W, C, heads, hidden, shift, scale, scale_dq, per_block, split_tokens};
  return checked_dispatch<Bwd>(a, is_bf16, stream);
}

// Bytes of dynamic shared memory a forward launch at width C and MLP width
// hidden asks for, fp32 or bf16 I/O (the hidden axis streams through the
// window buffers, so its width does not change them).
extern "C" int dmh_swin_block_smem_bytes(int C, int hidden, int is_bf16) {
  (void)hidden;
  return static_cast<int>(is_bf16 ? fwd_smem_bytes<__nv_bfloat16>(C) : fwd_smem_bytes<float>(C));
}

// Blocks of the forward kernel an SM of the current device holds at width
// C with `heads` heads, fp32 or bf16 I/O (shared memory, registers and
// threads together), into *out; returns the CUDA error.
extern "C" int dmh_swin_block_fwd_blocks_per_sm(int C, int heads, int is_bf16, int* out) {
  Args a{};
  a.B = 1;
  a.H = a.W = WS;
  a.C = C;
  a.heads = heads;
  a.hidden = 3 * C;
  a.out = out;
  return checked_dispatch<FwdOccupancy>(a, is_bf16, nullptr);
}

// Bytes of dynamic shared memory of backward kernel `part` (0 recompute, 1
// attention, 2 input, 3 weights; 4 the reduction: none) at width C and head
// dim hd, for fp32 or bf16 I/O.
extern "C" int dmh_swin_block_bwd_smem_bytes(int C, int hd, int part, int is_bf16) {
  const size_t floats = part == 0   ? (is_bf16 ? recompute_smem_floats<__nv_bfloat16>(C)
                                               : recompute_smem_floats<float>(C))
                        : part == 1 ? attention_smem_floats(hd)
                        : part == 2 ? (is_bf16 ? input_smem_floats<__nv_bfloat16>(C)
                                               : input_smem_floats<float>(C))
                        : part == 3 ? weights_smem_floats(C)
                                    : 0;
  return static_cast<int>(floats * sizeof(float));
}
