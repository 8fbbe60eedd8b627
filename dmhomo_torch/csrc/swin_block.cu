// Whole Swin block forward for Hopper, sm_90a.
//
// Replaces: dmhomo_tpu/ops/swin_block.py::_fwd_kernel (the Pallas TPU kernel
// behind fused_swin_block).  One launch computes, on (B, H, W, C) tokens in
// 8x8 windows, with round() the rounding to the I/O dtype:
//   n1  = round(LN1(x))                  fp32 two-pass statistics, eps 1e-5
//   qkv = round(n1 . round(Wq) + bq)     fp32 accumulation
//   att = the max-free window attention of window_attention.cu per head:
//         q scaled by hd^-0.5 in the I/O dtype, e = round(exp(clip(q k^T +
//         bias[g] (+ mask[w]), +-60))), att = round((e v) / sum(e))
//   h   = round(x + round(att . round(Wp) + bp))
//   n2  = round(LN2(h))
//   gm  = round(gelu(n2 . round(W1) + c1))   exact erf, fp32 argument
//   y   = round(h + round(gm . round(W2) + c2))
// A shifted block reads and writes each window's tokens at coordinates
// shifted by `shift` mod (H, W): the cyclic roll and its inverse without the
// two copies.  The mask row w of a window is its index within its image.
// Weights come in nn.Linear's (out, in) layout, fp32, rounded to the I/O
// dtype as they are staged.
//
// What bounds it on an H100.  At the shipped HEM widths (C = 24, 48, 96, MLP
// 3C) a window reads and writes 64*C values and does 2*64*(10*C^2) flops of
// projections plus 4*64*64*C of attention: 2,300 to 8,800 flops per fp32
// byte, far above the 20 where the card's 67 TFLOP/s of fp32 CUDA cores take
// over from its 3.35 TB/s of HBM.  It is operations bound; only the weights
// (10*C^2 fp32, 369 KB at C = 96) are read many times, from L2.
//
// What this simple design does about it: one block of 256 threads owns one
// window and keeps its 64 tokens in shared memory through the whole block,
// so device memory sees x once and y once.  The shared buffers: x, then h;
// one C-wide buffer for n1, the attention output, n2 and y; one buffer of
// max(3C, hidden) columns for qkv and then the GELU output; and one C x C
// block of a weight matrix (row = output column), which every projection
// streams in turn from L2 (Wq in 3 blocks, Wp in 1, W1 and W2 in hidden/C
// each).  The projections are register-tiled fp32 SGEMMs on CUDA cores: each
// thread owns TR rows x TC columns of a 64 x C output tile and reads float4s
// of both operands along the reduction axis; row strides of 4 (mod 8) floats
// keep those reads free of bank conflicts.  The attention gives each thread
// one query row of one head (four heads in flight), its q and output row in
// registers, the 64 keys and values broadcast from shared memory, the bias
// and mask rows from L2.  LayerNorm takes four threads per token.  At
// C = 96 the buffers take 164 KB: one block per SM.  Tensor cores, TMA and
// double-buffered weight blocks are later work.

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

// grid: one block per window, b * nW + w with w the window within its image
// (row-major over the shifted frame).
template <typename T, int C, int HD>
__global__ void __launch_bounds__(THREADS)
swin_block_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p, int H,
                      int W, int hidden, int shift, float scale) {
  using Tl = Tiling<C>;
  constexpr int LD = pad(C);
  constexpr int HEADS = C / HD;
  const int ldh = pad(hidden_cols(C, hidden));
  const int mlp_blocks = hidden / C;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x, then h
  float* cs = xs + N * LD;                      // N x LD: n1, att, n2, y
  float* ws = cs + N * LD;                      // C x LD: one weight block
  float* hs = ws + C * LD;                      // N x ldh: qkv, then gelu output

  const int nwc = W / WS;
  const int nW = (H / WS) * nwc;
  const int b = blockIdx.x / nW;
  const int w = blockIdx.x % nW;
  const int h0 = (w / nwc) * WS + shift;
  const int w0 = (w % nwc) * WS + shift;
  const int tid = threadIdx.x;
  const int rg = tid / Tl::CG, cg = tid % Tl::CG;
  constexpr int Q = C / 4;

  auto token = [&](int t) -> size_t {  // element offset of window token t
    const int gh = (h0 + t / WS) % H;
    const int gw = (w0 + t % WS) % W;
    return ((static_cast<size_t>(b) * H + gh) * W + gw) * C;
  };

  for (int e = tid; e < N * Q; e += THREADS) {
    const int t = e / Q, c = 4 * (e % Q);
    float v[4];
    IO<T>::load4(x + token(t) + c, v);
    st4(xs + t * LD + c, make_float4(v[0], v[1], v[2], v[3]));
  }
  __syncthreads();
  layer_norm<T, C>(xs, cs, p.g1, p.b1, tid);

  float acc[Tl::TR][Tl::TC];

  // qkv = round(n1 . Wq + bq), three C-column blocks
  for (int blk = 0; blk < 3; ++blk) {
    stage_weights<T, C>(p.wq, C, blk * C, 0, ws, tid);
    __syncthreads();
    zero<C>(acc);
    mma_block<C>(cs, LD, 0, ws, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TC; ++j) {
        const int r = rg + Tl::RG * i, n = blk * C + cg + Tl::CG * j;
        hs[r * ldh + n] = IO<T>::round(acc[i][j] + __ldg(p.bq + n));
      }
    __syncthreads();
  }

  // window attention: thread i owns query row i of head g
  {
    const int grp = tid / N, i = tid % N;
    const float* mrow = p.mask ? p.mask + (static_cast<size_t>(w) * N + i) * N : nullptr;
    for (int g = grp; g < HEADS; g += GROUPS) {
      float q[HD], o[HD];
      const float* qrow = hs + i * ldh + g * HD;
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
      const float* kcol = hs + C + g * HD;
      const float* vcol = hs + 2 * C + g * HD;
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
          float sim = dot_row<HD>(q, kcol + j * ldh) + bj[u];
          if (mrow) sim += mj[u];
          const float e = IO<T>::round(expf(fminf(fmaxf(sim, -CLIP), CLIP)));
          s += e;
          axpy_row<HD>(e, vcol + j * ldh, o);
        }
      }
      float* orow = cs + i * LD + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4)
        st4(orow + d, make_float4(IO<T>::round(o[d] / s), IO<T>::round(o[d + 1] / s),
                                  IO<T>::round(o[d + 2] / s), IO<T>::round(o[d + 3] / s)));
    }
  }

  // h = round(x + round(att . Wp + bp)), in place of x
  stage_weights<T, C>(p.wp, C, 0, 0, ws, tid);
  __syncthreads();
  zero<C>(acc);
  mma_block<C>(cs, LD, 0, ws, acc, rg, cg);
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TC; ++j) {
      const int r = rg + Tl::RG * i, n = cg + Tl::CG * j;
      const float pv = IO<T>::round(acc[i][j] + __ldg(p.bp + n));
      xs[r * LD + n] = IO<T>::round(xs[r * LD + n] + pv);
    }
  __syncthreads();
  layer_norm<T, C>(xs, cs, p.g2, p.b2, tid);

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

struct Args {
  const void* x;
  void* y;
  Params p;
  int B, H, W, C, heads, hidden, shift;
  float scale;
};

template <typename T, int C, int HD>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(C, a.hidden) * sizeof(float);
  auto kernel = swin_block_fwd_kernel<T, C, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(a.B) * (a.H / WS) * (a.W / WS);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), a.p, a.H, a.W, a.hidden, a.shift,
      a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const int hd = a.C / a.heads;
  switch (a.C) {
    case 24:
      if (hd == 4) return run<T, 24, 4>(a, s);
      if (hd == 8) return run<T, 24, 8>(a, s);
      break;
    case 48:
      if (hd == 4) return run<T, 48, 4>(a, s);
      if (hd == 8) return run<T, 48, 8>(a, s);
      if (hd == 16) return run<T, 48, 16>(a, s);
      break;
    case 96:
      if (hd == 4) return run<T, 96, 4>(a, s);
      if (hd == 8) return run<T, 96, 8>(a, s);
      if (hd == 16) return run<T, 96, 16>(a, s);
      if (hd == 32) return run<T, 96, 32>(a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

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
  if (B <= 0 || H <= 0 || W <= 0 || H % WS || W % WS || heads <= 0 || C % heads ||
      hidden <= 0 || hidden % C || hidden / C > MAX_MLP_RATIO || shift < 0 || shift >= WS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const Args a{x, y, {f(g1), f(b1), f(wq), f(bq), f(bias), f(mask), f(wp), f(bp), f(g2),
                      f(b2), f(w1), f(c1), f(w2), f(c2)},
               B, H, W, C, heads, hidden, shift, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s));
}

// Bytes of dynamic shared memory a launch at width C and MLP width hidden asks for.
extern "C" int dmh_swin_block_smem_bytes(int C, int hidden) {
  return static_cast<int>(smem_floats(C, hidden) * sizeof(float));
}
