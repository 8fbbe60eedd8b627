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
// 3.35 TB/s of HBM.  Both are operations bound; only the weights (10*C^2
// fp32, 369 KB at C = 96) are read many times, from L2.
//
// What this simple design does about it: one block of 256 threads owns one
// window and keeps its 64 tokens in shared memory, so device memory sees x
// once and y once (the backward reads x three times and dy once, and writes
// dx once).  Forward buffers: x, then h; one C-wide buffer for n1, the
// attention output, n2 and y; one buffer of max(3C, hidden) columns for qkv
// and then the GELU output; and one C x C block of a weight matrix (row =
// output column), which every projection streams in turn from L2 (Wq in 3
// blocks, Wp in 1, W1 and W2 in hidden/C each).  The projections are
// register-tiled fp32 SGEMMs on CUDA cores: each thread owns TR rows x TC
// columns of a 64 x C output tile and reads float4s of both operands along
// the reduction axis; row strides of 4 (mod 8) floats keep those reads free
// of bank conflicts.  The attention gives each thread one query row of one
// head (four heads in flight), its q and output row in registers, the 64 keys
// and values broadcast from shared memory, the bias and mask rows from L2.
// LayerNorm takes four threads per token.  At C = 96 the buffers take 164
// KB: one block per SM.
//
// The backward holds four C-wide buffers, one 3C-wide and the weight block
// (212 KB at C = 96), planned by liveness: the MLP goes one C-column block of
// the hidden layer at a time (m1, gm and dm1 of the block in the 3C buffer,
// dn2 summed in registers), since the qkv it would share that buffer with is
// recomputed after it; dq overwrites dao, dk and dv overwrite k and v row by
// row.  The attention's backward takes window_attention.cu's two passes
// (query rows, then key rows recomputing their logits column).  Every weight
// gradient is a C x C tile reduced over the window's 64 tokens in registers
// and added to the zeroed fp32 output with one global atomicAdd per element
// per window, as dbias (one per element of dsim) and the vector gradients
// are.  Tensor cores, TMA, double-buffered weight blocks and summing
// gradients over several windows before the atomics are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WS = 8;                 // window side
constexpr int N = WS * WS;            // tokens per window
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / N;   // heads in flight in the attention step
constexpr int LN_THREADS = 4;         // threads per token in a LayerNorm
constexpr int MAX_MLP_RATIO = 4;
constexpr float CLIP = 60.0f;
constexpr float LN_EPS = 1e-5f;

// Row stride (floats) of a shared buffer `width` floats wide: 4 (mod 8), so
// float4 reads of 8 consecutive rows land in 8 distinct groups of 4 banks.
__host__ __device__ constexpr int pad(int width) { return width + 4; }

__host__ __device__ constexpr int hidden_cols(int C, int hidden) {
  return hidden > 3 * C ? hidden : 3 * C;
}

// Floats of shared memory: x/h, the C-wide buffer, the weight block, qkv/hidden.
constexpr size_t smem_floats(int C, int hidden) {
  return static_cast<size_t>(2 * N * pad(C) + C * pad(C) + N * pad(hidden_cols(C, hidden)));
}

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

// dst = round(LN(src)) for the window's 64 tokens, C channels each; rows
// padded to pad(C).  Four threads per token, combined with shuffles.
template <typename T, int C>
__device__ __forceinline__ void layer_norm(const float* src, float* dst,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b, int tid) {
  constexpr int LD = pad(C);
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

// ws[n][k] = round(w[(n0 + n) * ldw + k0 + k]) for n, k < C: one C x C block
// of an (out, in) weight, row n holding output column n0 + n.
template <typename T, int C>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int ldw, int n0,
                                              int k0, float* ws, int tid) {
  constexpr int LD = pad(C);
  constexpr int Q = C / 4;
  for (int e = tid; e < C * Q; e += THREADS) {
    const int n = e / Q, k = 4 * (e % Q);
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        w + static_cast<size_t>(n0 + n) * ldw + k0 + k));
    st4(ws + n * LD + k, make_float4(IO<T>::round(v.x), IO<T>::round(v.y),
                                     IO<T>::round(v.z), IO<T>::round(v.w)));
  }
}

template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(IO<T>::round(v.x), IO<T>::round(v.y), IO<T>::round(v.z), IO<T>::round(v.w));
}

// acc[i][j] += sum_k R(a[(rg + RG*i) * lda + k0 + k]) * ws[(cg + CG*j) * pad(C) + k], with
// R the rounding to R's dtype (none for float)
template <int C, typename R = float>
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
    for (int i = 0; i < Tl::TR; ++i) av[i] = round4<R>(ld4(arow + Tl::RG * i * lda + k));
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

template <int HD>
__device__ __forceinline__ float dot_row(const float* a, const float* b_s) {
  float dot = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 bb = ld4(b_s + d);
    dot = fmaf(a[d], bb.x, dot);
    dot = fmaf(a[d + 1], bb.y, dot);
    dot = fmaf(a[d + 2], bb.z, dot);
    dot = fmaf(a[d + 3], bb.w, dot);
  }
  return dot;
}

template <int HD>
__device__ __forceinline__ void axpy_row(float a, const float* x_s, float* acc) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 xx = ld4(x_s + d);
    acc[d] = fmaf(a, xx.x, acc[d]);
    acc[d + 1] = fmaf(a, xx.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, xx.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, xx.w, acc[d + 3]);
  }
}

// qkv = round(n1 . Wq + bq) for the window, three C-column blocks of Wq;
// qkv rows are ldq floats apart.  Ends with a barrier.
template <typename T, int C>
__device__ __forceinline__ void project_qkv(const float* n1, float* qkv, int ldq, const Params& p,
                                            float* ws, int tid) {
  using Tl = Tiling<C>;
  constexpr int LD = pad(C);
  const int rg = tid / Tl::CG, cg = tid % Tl::CG;
  float acc[Tl::TR][Tl::TC];
  for (int blk = 0; blk < 3; ++blk) {
    stage_weights<T, C>(p.wq, C, blk * C, 0, ws, tid);
    __syncthreads();
    zero<C>(acc);
    mma_block<C>(n1, LD, 0, ws, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) {
        const int r = rg + Tl::RG * i, n = blk * C + cg + Tl::CG * j;
        qkv[r * ldq + n] = IO<T>::round(acc[i][j] + __ldg(p.bq + n));
      }
    __syncthreads();
  }
}

// out = the window attention of qkv (rows ldq floats apart), C wide: thread i
// owns query row i of head g, four heads in flight.  No barrier at the end.
template <typename T, int C, int HD>
__device__ __forceinline__ void attention(const float* qkv, int ldq, float* out, const Params& p,
                                          int w, float scale, int tid) {
  constexpr int LD = pad(C);
  constexpr int HEADS = C / HD;
  const int grp = tid / N, i = tid % N;
  const float* mrow = p.mask ? p.mask + (static_cast<size_t>(w) * N + i) * N : nullptr;
  for (int g = grp; g < HEADS; g += GROUPS) {
    float q[HD], o[HD];
    const float* qrow = qkv + i * ldq + g * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 v = ld4(qrow + d);
      q[d] = IO<T>::round(v.x * scale);
      q[d + 1] = IO<T>::round(v.y * scale);
      q[d + 2] = IO<T>::round(v.z * scale);
      q[d + 3] = IO<T>::round(v.w * scale);
      o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.0f;
    }
    const float* brow = p.bias + (static_cast<size_t>(g) * N + i) * N;
    const float* kcol = qkv + C + g * HD;
    const float* vcol = qkv + 2 * C + g * HD;
    float s = 0.0f;
    for (int j0 = 0; j0 < N; j0 += 4) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(brow + j0));
      const float4 m4 = mrow ? __ldg(reinterpret_cast<const float4*>(mrow + j0))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
      const float mj[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        float sim = dot_row<HD>(q, kcol + j * ldq) + bj[u];
        if (mrow) sim += mj[u];
        const float e = IO<T>::round(expf(fminf(fmaxf(sim, -CLIP), CLIP)));
        s += e;
        axpy_row<HD>(e, vcol + j * ldq, o);
      }
    }
    float* orow = out + i * LD + g * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      st4(orow + d, make_float4(IO<T>::round(o[d] / s), IO<T>::round(o[d + 1] / s),
                                IO<T>::round(o[d + 2] / s), IO<T>::round(o[d + 3] / s)));
  }
}

// xs = round(xs + round(att . Wp + bp)), the residual in place of x.  Ends
// with a barrier.
template <typename T, int C>
__device__ __forceinline__ void project_residual(const float* att, float* xs, const Params& p,
                                                 float* ws, int tid) {
  using Tl = Tiling<C>;
  constexpr int LD = pad(C);
  const int rg = tid / Tl::CG, cg = tid % Tl::CG;
  float acc[Tl::TR][Tl::TC];
  stage_weights<T, C>(p.wp, C, 0, 0, ws, tid);
  __syncthreads();
  zero<C>(acc);
  mma_block<C>(att, LD, 0, ws, acc, rg, cg);
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j) {
      const int r = rg + Tl::RG * i, n = cg + Tl::CG * j;
      const float pv = IO<T>::round(acc[i][j] + __ldg(p.bp + n));
      xs[r * LD + n] = IO<T>::round(xs[r * LD + n] + pv);
    }
  __syncthreads();
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
    const int gh = (h0 + t / WS) % H;
    const int gw = (w0 + t % WS) % W;
    return ((static_cast<size_t>(b) * H + gh) * W + gw) * C;
  }
};

// dst (N x pad(C) floats) = the window's C-channel tokens of src.
template <typename T, int C>
__device__ __forceinline__ void load_window(const T* __restrict__ src, const WindowTokens& token,
                                            float* dst, int tid) {
  constexpr int LD = pad(C);
  constexpr int Q = C / 4;
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    float v[4];
    IO<T>::load4(src + token(t) + c, v);
    st4(dst + t * LD + c, make_float4(v[0], v[1], v[2], v[3]));
  }
}

// grid: one block per window, b * nW + w with w the window within its image
// (row-major over the shifted frame).
template <typename T, int C, int HD>
__global__ void __launch_bounds__(THREADS)
swin_block_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p, int H,
                      int W, int hidden, int shift, float scale) {
  using Tl = Tiling<C>;
  constexpr int LD = pad(C);
  const int ldh = pad(hidden_cols(C, hidden));
  const int mlp_blocks = hidden / C;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x, then h
  float* cs = xs + N * LD;                      // N x LD: n1, att, n2, y
  float* ws = cs + N * LD;                      // C x LD: one weight block
  float* hs = ws + C * LD;                      // N x ldh: qkv, then gelu output

  const WindowTokens token(blockIdx.x, H, W, C, shift);
  const int w = blockIdx.x % ((H / WS) * (W / WS));
  const int tid = threadIdx.x;
  const int rg = tid / Tl::CG, cg = tid % Tl::CG;
  constexpr int Q = C / 4;

  load_window<T, C>(x, token, xs, tid);
  __syncthreads();
  layer_norm<T, C>(xs, cs, p.g1, p.b1, tid);
  project_qkv<T, C>(cs, hs, ldh, p, ws, tid);
  attention<T, C, HD>(hs, ldh, cs, p, w, scale, tid);
  project_residual<T, C>(cs, xs, p, ws, tid);
  layer_norm<T, C>(xs, cs, p.g2, p.b2, tid);

  float acc[Tl::TR][Tl::TC];

  // gm = round(gelu(n2 . W1 + c1)), hidden/C column blocks
  for (int blk = 0; blk < mlp_blocks; ++blk) {
    stage_weights<T, C>(p.w1, C, blk * C, 0, ws, tid);
    __syncthreads();
    zero<C>(acc);
    mma_block<C>(cs, LD, 0, ws, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) {
        const int r = rg + Tl::RG * i, n = blk * C + cg + Tl::CG * j;
        const float m = acc[i][j] + __ldg(p.c1 + n);
        const float cdf = 0.5f * (1.0f + erff(m * 0.70710678118654752f));
        hs[r * ldh + n] = IO<T>::round(m * cdf);
      }
    __syncthreads();
  }

  // y = round(h + round(gm . W2 + c2)), summed over hidden/C row blocks of W2^T
  zero<C>(acc);
  for (int blk = 0; blk < mlp_blocks; ++blk) {
    stage_weights<T, C>(p.w2, hidden, 0, blk * C, ws, tid);
    __syncthreads();
    mma_block<C>(hs, ldh, blk * C, ws, acc, rg, cg);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j) {
      const int r = rg + Tl::RG * i, n = cg + Tl::CG * j;
      const float m2 = IO<T>::round(acc[i][j] + __ldg(p.c2 + n));
      cs[r * LD + n] = IO<T>::round(xs[r * LD + n] + m2);
    }
  __syncthreads();
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    IO<T>::store4(y + token(t) + c, cs + t * LD + c);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct Grads {  // fp32, zeroed by the caller; the kernel adds every window's part
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

// Floats of the backward's shared memory: four C-wide buffers, one 3C-wide,
// the weight block, LayerNorm statistics and the ds column of each head in
// flight.
constexpr size_t bwd_smem_floats(int C) {
  return static_cast<size_t>(4 * N * pad(C) + N * pad(3 * C) + C * pad(C) + 2 * N + GROUPS * N);
}

// ws[c][k] = round(w[(r0 + k) * ldw + c0 + c]) for c, k < C: one C x C block
// of a weight read along its rows, for a product that reduces over the
// weight's output axis (an input gradient).
template <typename T, int C>
__device__ __forceinline__ void stage_weights_t(const float* __restrict__ w, int ldw, int r0,
                                                int c0, float* ws, int tid) {
  constexpr int LD = pad(C);
  for (int e = tid; e < C * C; e += THREADS) {
    const int k = e / C, c = e % C;
    ws[c * LD + k] = IO<T>::round(__ldg(w + static_cast<size_t>(r0 + k) * ldw + c0 + c));
  }
}

// A C x C weight-gradient tile on 256 threads: CG column groups (columns
// cg + CG*j) by RG row groups (rows rg + RG*i; rows past C idle).
template <int C>
struct WTiling {
  static constexpr int CG = C % 16 == 0 ? 16 : 8;
  static constexpr int TC = C / CG;
  static constexpr int RG = THREADS / CG;
  static constexpr int TR = (C + RG - 1) / RG;
};

// dst[n * ldd + k] += sum over the window's tokens t of a[t * lda + n] *
// b[t * ldb + k] for n, k < C: one global atomicAdd per element.
template <int C>
__device__ __forceinline__ void weight_grad(const float* a, int lda, const float* b, int ldb,
                                            float* dst, int ldd, int tid) {
  using Wt = WTiling<C>;
  const int rg = tid / Wt::CG, cg = tid % Wt::CG;
  float acc[Wt::TR][Wt::TC];
#pragma unroll
  for (int i = 0; i < Wt::TR; ++i)
#pragma unroll
    for (int j = 0; j < Wt::TC; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int t = 0; t < N; ++t) {
    float av[Wt::TR], bv[Wt::TC];
#pragma unroll
    for (int i = 0; i < Wt::TR; ++i) {
      const int n = rg + Wt::RG * i;
      av[i] = n < C ? a[t * lda + n] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < Wt::TC; ++j) bv[j] = b[t * ldb + cg + Wt::CG * j];
#pragma unroll
    for (int i = 0; i < Wt::TR; ++i)
#pragma unroll
      for (int j = 0; j < Wt::TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < Wt::TR; ++i) {
    const int n = rg + Wt::RG * i;
    if (n < C) {
#pragma unroll
      for (int j = 0; j < Wt::TC; ++j) atomicAdd(dst + n * ldd + cg + Wt::CG * j, acc[i][j]);
    }
  }
}

// dst[c] += sum over the window's tokens of a[t * lda + c], for c < n.
__device__ __forceinline__ void column_sums(const float* a, int lda, int n, float* dst, int tid) {
  for (int c = tid; c < n; c += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < N; ++t) s += a[t * lda + c];
    atomicAdd(dst + c, s);
  }
}

// LayerNorm backward over the window, in fp32: with xhat and rstd of src (C
// channels; statistics as layer_norm computes them) and dxh = dn * g,
//   dres += rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))   (in place)
//   dg += sum_t dn * xhat,  db += sum_t dn.
// Ends with a barrier.
template <int C>
__device__ __forceinline__ void layer_norm_bwd(const float* src, const float* dn, int ldn,
                                               float* dres, const float* __restrict__ g,
                                               float* dg, float* db, float* st, int tid) {
  constexpr int LD = pad(C);
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
    atomicAdd(dg + c, sg);
    atomicAdd(db + c, sb);
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

// The window attention's backward for the window's heads, four in flight.
// qkv (rows LDQ apart) holds round(n1 . Wq + bq); dq_io (C wide) holds
// dao = the attention output's gradient.  Per head g, pass A gives thread i
// query row i (recompute e_i, s_i and ctx_i; then gg_i, ds_i and dq_i) and
// pass B thread j key row j (column j of the logits from the q and gg rows
// pass A left in shared memory: dk_j, dv_j, column j of dsim).  On return
// dq_io holds round(dq) over dao, qkv's k and v columns round(dk) and
// round(dv), its q columns q scaled; gg_s the round(gg) rows.  dbias gets
// one global atomicAdd per element of dsim.
template <typename T, int C, int HD>
__device__ __forceinline__ void attention_bwd(float* qkv, float* dq_io, float* gg_s, float* ds_all,
                                              const Params& p, float* dbias, int w, float scale_io,
                                              float scale, int tid) {
  constexpr int LD = pad(C);
  constexpr int LDQ = pad(3 * C);
  constexpr int HEADS = C / HD;
  const int grp = tid / N, i = tid % N;
  float* ds_s = ds_all + grp * N;
  const float* mask_w = p.mask ? p.mask + static_cast<size_t>(w) * N * N : nullptr;
  for (int g0 = 0; g0 < HEADS; g0 += GROUPS) {
    const int g = g0 + grp;
    const bool active = g < HEADS;
    const float* bias_g = p.bias + static_cast<size_t>(g) * N * N;
    float* qcol = qkv + g * HD;
    float* kcol = qkv + C + g * HD;
    float* vcol = qkv + 2 * C + g * HD;
    if (active) {  // pass A: query row i
      float q[HD], acc[HD], gg[HD];
      float* qrow = qcol + i * LDQ;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        q[d] = IO<T>::round(qrow[d] * scale_io);
        acc[d] = 0.0f;
      }
      const float* brow = bias_g + i * N;
      const float* mrow = mask_w ? mask_w + i * N : nullptr;
      float s = 0.0f;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        float sim = dot_row<HD>(q, kcol + j * LDQ) + __ldg(brow + j);
        if (mrow) sim += __ldg(mrow + j);
        const float e = IO<T>::round(expf(fminf(fmaxf(sim, -CLIP), CLIP)));
        s += e;
        axpy_row<HD>(e, vcol + j * LDQ, acc);
      }
      float* drow = dq_io + i * LD + g * HD;
      float ds = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        gg[d] = drow[d] / s;
        ds = fmaf(gg[d], acc[d], ds);
      }
      ds = -ds / s;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        gg[d] = IO<T>::round(gg[d]);
        gg_s[i * LD + g * HD + d] = gg[d];
        qrow[d] = q[d];  // only this thread reads its q row before the barrier
        acc[d] = 0.0f;
      }
      ds_s[i] = ds;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        float sim = dot_row<HD>(q, kcol + j * LDQ) + __ldg(brow + j);
        if (mrow) sim += __ldg(mrow + j);
        const float e32 = expf(fminf(fmaxf(sim, -CLIP), CLIP));
        const float de = dot_row<HD>(gg, vcol + j * LDQ) + ds;
        const float dsim = fabsf(sim) < CLIP ? IO<T>::round(e32 * de) : 0.0f;
        axpy_row<HD>(dsim, kcol + j * LDQ, acc);
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) drow[d] = IO<T>::round(acc[d] * scale);
    }
    __syncthreads();
    if (active) {  // pass B: key row j = i
      float kj[HD], vj[HD], dk[HD], dv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        kj[d] = kcol[i * LDQ + d];
        vj[d] = vcol[i * LDQ + d];
        dk[d] = 0.0f;
        dv[d] = 0.0f;
      }
      float* dcol = dbias + static_cast<size_t>(g) * N * N + i;
#pragma unroll 2
      for (int r = 0; r < N; ++r) {
        float sim = dot_row<HD>(kj, qcol + r * LDQ) + __ldg(bias_g + r * N + i);
        if (mask_w) sim += __ldg(mask_w + r * N + i);
        const float e32 = expf(fminf(fmaxf(sim, -CLIP), CLIP));
        const float de = dot_row<HD>(vj, gg_s + r * LD + g * HD) + ds_s[r];
        const float dsim = fabsf(sim) < CLIP ? IO<T>::round(e32 * de) : 0.0f;
        axpy_row<HD>(dsim, qcol + r * LDQ, dk);
        axpy_row<HD>(IO<T>::round(e32), gg_s + r * LD + g * HD, dv);
        atomicAdd(dcol + r * N, dsim);
      }
      // row j of k and v is read by this thread only
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        kcol[i * LDQ + d] = IO<T>::round(dk[d]);
        vcol[i * LDQ + d] = IO<T>::round(dv[d]);
      }
    }
    __syncthreads();
  }
}

// grid: one block per window, as the forward.  dx is written once per
// element; every parameter gradient is added to with global atomics.
template <typename T, int C, int HD>
__global__ void __launch_bounds__(THREADS)
swin_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                      const Params p, const Grads gr, int H, int W, int hidden, int shift,
                      float scale_io, float scale) {
  using Tl = Tiling<C>;
  constexpr int LD = pad(C);
  constexpr int LDQ = pad(3 * C);
  constexpr int Q = C / 4;
  const int mlp_blocks = hidden / C;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x, h, then dao and dq
  float* as = xs + N * LD;                      // n1, n2, n1 again, then dn1
  float* os = as + N * LD;                      // att, x, round(gg), then x
  float* es = os + N * LD;                      // dy, then dh (fp32), then dx
  float* qs = es + N * LD;                      // N x LDQ: qkv; gm | dm1 blocks; dn2; qkv, dk, dv
  float* ws = qs + N * LDQ;                     // C x LD: one weight block
  float* st = ws + C * LD;                      // N x 2: LayerNorm statistics
  float* dss = st + 2 * N;                      // GROUPS x N: ds of the heads in flight

  const WindowTokens token(blockIdx.x, H, W, C, shift);
  const int w = blockIdx.x % ((H / WS) * (W / WS));
  const int tid = threadIdx.x;
  const int rg = tid / Tl::CG, cg = tid % Tl::CG;
  float acc[Tl::TR][Tl::TC];

  // ---- the forward, recomputed: h in xs, att in os, n2 in as ----
  load_window<T, C>(x, token, xs, tid);
  __syncthreads();
  layer_norm<T, C>(xs, as, p.g1, p.b1, tid);
  project_qkv<T, C>(as, qs, LDQ, p, ws, tid);
  attention<T, C, HD>(qs, LDQ, os, p, w, scale_io, tid);
  project_residual<T, C>(os, xs, p, ws, tid);
  layer_norm<T, C>(xs, as, p.g2, p.b2, tid);
  load_window<T, C>(dy, token, es, tid);
  __syncthreads();
  column_sums(es, LD, C, gr.c2, tid);

  // ---- MLP, one hidden block of C columns at a time; dn2 in registers ----
  float dn2[Tl::TR][Tl::TC];
  zero<C>(dn2);
  float* gm_s = qs;      // round(gelu(m1)) of the block
  float* dm_s = qs + C;  // gelu'(m1), then dm1 (fp32)
  for (int blk = 0; blk < mlp_blocks; ++blk) {
    stage_weights<T, C>(p.w1, C, blk * C, 0, ws, tid);
    __syncthreads();
    zero<C>(acc);
    mma_block<C>(as, LD, 0, ws, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) {
        const int r = rg + Tl::RG * i, n = cg + Tl::CG * j;
        const float m = acc[i][j] + __ldg(p.c1 + blk * C + n);
        const float cdf = 0.5f * (1.0f + erff(m * 0.70710678118654752f));
        gm_s[r * LDQ + n] = IO<T>::round(m * cdf);
        dm_s[r * LDQ + n] = cdf + m * 0.3989422804014327f * expf(-0.5f * m * m);
      }
    __syncthreads();
    // dW2[:, block] += dy^T gm
    weight_grad<C>(es, LD, gm_s, LDQ, gr.w2 + blk * C, hidden, tid);
    // dm1 = (dy . round(W2[:, block])) * gelu'(m1)
    stage_weights_t<T, C>(p.w2, hidden, 0, blk * C, ws, tid);
    __syncthreads();
    zero<C>(acc);
    mma_block<C>(es, LD, 0, ws, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) {
        const int r = rg + Tl::RG * i, n = cg + Tl::CG * j;
        dm_s[r * LDQ + n] *= acc[i][j];
      }
    __syncthreads();
    // dW1[block] += dm1^T n2, dc1[block] += sum dm1, dn2 += round(dm1) . round(W1[block])
    weight_grad<C>(dm_s, LDQ, as, LD, gr.w1 + blk * C * C, C, tid);
    column_sums(dm_s, LDQ, C, gr.c1 + blk * C, tid);
    stage_weights_t<T, C>(p.w1, C, blk * C, 0, ws, tid);
    __syncthreads();
    mma_block<C, T>(dm_s, LDQ, 0, ws, dn2, rg, cg);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j) qs[(rg + Tl::RG * i) * LDQ + cg + Tl::CG * j] = dn2[i][j];
  __syncthreads();
  // dh = dy + LN2'(dn2), in place of dy
  layer_norm_bwd<C>(xs, qs, LDQ, es, p.g2, gr.g2, gr.b2, st, tid);

  // ---- the projection: dWp += dh^T att, dbp += sum dh, dao = round(round(dh) . round(Wp)) ----
  weight_grad<C>(es, LD, os, LD, gr.wp, C, tid);
  column_sums(es, LD, C, gr.bp, tid);
  stage_weights_t<T, C>(p.wp, C, 0, 0, ws, tid);
  __syncthreads();
  zero<C>(acc);
  mma_block<C, T>(es, LD, 0, ws, acc, rg, cg);
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j)
      xs[(rg + Tl::RG * i) * LD + cg + Tl::CG * j] = IO<T>::round(acc[i][j]);
  __syncthreads();

  // ---- the attention: n1 and qkv again, then dq over dao, dk and dv over k and v ----
  load_window<T, C>(x, token, os, tid);
  __syncthreads();
  layer_norm<T, C>(os, as, p.g1, p.b1, tid);
  project_qkv<T, C>(as, qs, LDQ, p, ws, tid);
  attention_bwd<T, C, HD>(qs, xs, os, dss, p, gr.bias, w, scale_io, scale, tid);

  // ---- qkv: dWq += dqkv^T n1, dbq += sum dqkv, dn1 = dqkv . round(Wq) ----
  const float* dqkv[3] = {xs, qs + C, qs + 2 * C};
  const int ldd[3] = {LD, LDQ, LDQ};
  zero<C>(acc);
#pragma unroll
  for (int blk = 0; blk < 3; ++blk) {
    weight_grad<C>(dqkv[blk], ldd[blk], as, LD, gr.wq + blk * C * C, C, tid);
    column_sums(dqkv[blk], ldd[blk], C, gr.bq + blk * C, tid);
    stage_weights_t<T, C>(p.wq, C, blk * C, 0, ws, tid);
    __syncthreads();
    mma_block<C>(dqkv[blk], ldd[blk], 0, ws, acc, rg, cg);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j) as[(rg + Tl::RG * i) * LD + cg + Tl::CG * j] = acc[i][j];
  load_window<T, C>(x, token, os, tid);
  __syncthreads();
  // dx = round(dh + LN1'(dn1))
  layer_norm_bwd<C>(os, as, LD, es, p.g1, gr.g1, gr.b1, st, tid);
  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    IO<T>::store4(dx + token(t) + c, es + t * LD + c);
  }
}

// One launch's arguments, as the C entry points take them.
struct Args {
  const void* x;
  const void* dy;  // backward only
  void* out;       // forward: y; backward: dx
  Params p;
  Grads gr;        // backward only
  int B, H, W, C, heads, hidden, shift;
  float scale_io;  // hd^-0.5 rounded to the I/O dtype: scales q
  float scale;     // hd^-0.5 in fp32: scales dq (backward only)
};

struct Fwd {
  template <typename T, int C, int HD>
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const size_t smem = smem_floats(C, a.hidden) * sizeof(float);
    auto kernel = swin_block_fwd_kernel<T, C, HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const long long blocks = static_cast<long long>(a.B) * (a.H / WS) * (a.W / WS);
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), static_cast<T*>(a.out), a.p, a.H, a.W, a.hidden, a.shift,
        a.scale_io);
    return cudaGetLastError();
  }
};

struct Bwd {
  template <typename T, int C, int HD>
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const size_t smem = bwd_smem_floats(C) * sizeof(float);
    auto kernel = swin_block_bwd_kernel<T, C, HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const long long blocks = static_cast<long long>(a.B) * (a.H / WS) * (a.W / WS);
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<T*>(a.out), a.p,
        a.gr, a.H, a.W, a.hidden, a.shift, a.scale_io, a.scale);
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
               {}, B, H, W, C, heads, hidden, shift, scale, 0.0f};
  return checked_dispatch<Fwd>(a, is_bf16, stream);
}

// The forward's arguments, plus dy (the gradient of y) and dx in the I/O
// dtype, the 13 fp32 parameter gradients in the parameters' order and
// layouts, zeroed by the caller (the kernel adds to them), and scale_dq =
// hd^-0.5 in fp32.
extern "C" int dmh_swin_block_bwd(
    const void* x, const void* dy, void* dx, const void* g1, const void* b1, const void* wq,
    const void* bq, const void* bias, const void* mask, const void* wp, const void* bp,
    const void* g2, const void* b2, const void* w1, const void* c1, const void* w2,
    const void* c2, void* dg1, void* db1, void* dwq, void* dbq, void* dbias, void* dwp, void* dbp,
    void* dg2, void* db2, void* dw1, void* dc1, void* dw2, void* dc2, int B, int H, int W, int C,
    int heads, int hidden, int shift, float scale, float scale_dq, int is_bf16, void* stream) {
  const auto g = [](void* q) { return static_cast<float*>(q); };
  const Args a{x, dy, dx,
               {f32(g1), f32(b1), f32(wq), f32(bq), f32(bias), f32(mask), f32(wp), f32(bp),
                f32(g2), f32(b2), f32(w1), f32(c1), f32(w2), f32(c2)},
               {g(dg1), g(db1), g(dwq), g(dbq), g(dbias), g(dwp), g(dbp), g(dg2), g(db2),
                g(dw1), g(dc1), g(dw2), g(dc2)},
               B, H, W, C, heads, hidden, shift, scale, scale_dq};
  return checked_dispatch<Bwd>(a, is_bf16, stream);
}

// Bytes of dynamic shared memory a forward launch at width C and MLP width
// hidden asks for.
extern "C" int dmh_swin_block_smem_bytes(int C, int hidden) {
  return static_cast<int>(smem_floats(C, hidden) * sizeof(float));
}

// Bytes of dynamic shared memory a backward launch at width C asks for.
extern "C" int dmh_swin_block_bwd_smem_bytes(int C) {
  return static_cast<int>(bwd_smem_floats(C) * sizeof(float));
}
