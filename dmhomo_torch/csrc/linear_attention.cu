// Linear attention (the DGM UNet's per-stage attention) for Hopper, sm_90a:
// two kernels, pass 1 (the k side) and pass 2 (the q side).
//
// Replaces: dmhomo_tpu/ops/linear_attention.py::_pass1_kernel and
// ::_pass2_kernel (the Pallas TPU kernels of pallas_linear_attention).  They
// compute what the JAX production function blockdiag_linear_attention
// computes (max-free: a static +-60 clip before exp, no data max), with
// heads = 4 and dim_head = 32, so the hidden width is HD = 128.  For x
// (B, N, C) in the I/O dtype dt (fp32 or bf16) and w_qkv (C, 3*HD) fp32:
//
//   projection (fp32 accumulation), q | k | v = columns 0 | 128 | 256 of:
//     no prenorm:  qkv = round(x . round(W))
//     prenorm g:   qkv = round((x . round(diag(g) W) - mean * (g W)) * rstd)
//                  with mean, rstd of each token over C in fp32 (LayerNorm,
//                  eps 1e-5, folded into the projection: the normalized x
//                  never exists)
//   pass 1:  ek = round(exp(clip(k, +-60)));  s = sum_n ek (fp32);
//            E_h = ek_h^T v_h (fp32), only the four 32x32 diagonal blocks
//   pass 2:  context_h = round(E_h * 32^-0.5 / (s_h * N))  (per row d)
//            eq = round(exp(clip(q, +-60)))
//            out = round(round(eq_h . context_h) / round(sum_d eq_h))
// where round() is rounding to dt (the identity for fp32).
//
// What bounds them on an H100.  The projection is the bulk of the work:
// per token 2*256*C flops in pass 1 and 2*128*C in pass 2, beside 2*4096
// flops each for E and for eq . context.  At C = 64..512 that is 24-190
// flops per byte of bf16 x read, so on fp32 CUDA cores (67 TFLOP/s, 20
// flops per byte at 3.35 TB/s) both passes are operations bound; on bf16
// tensor cores they would be bytes bound at every site.
//
// What this simple design does about it: x is read from HBM twice in all
// (once per pass, plus L2 rereads of the same tile for the LayerNorm
// statistics), the output written once, and nothing of size N besides the
// statistics (8 bytes per token) reaches device memory between the passes.
// A block of 256 threads projects 64-token tiles as a register-tiled SGEMM:
// x and W are staged 32 channels at a time in shared memory (W is streamed,
// so C = 512 fits: Wk|Wv of C = 512 would need 512 KB), and each thread
// owns 8 tokens x 8 columns (pass 1) or 8 x 4 (pass 2).  Pass 1 keeps the
// tile's ek and v in shared memory, accumulates its share of the diagonal
// blocks of E in registers over several tiles, and adds them (and s) to a
// zeroed fp32 buffer with one global atomicAdd per element per block; the
// number of tiles per block is chosen so that the grid fills the card
// without every tile paying the atomics.  The sum order of E and s changes
// from run to run.  Pass 2 needs no reduction: one tile per block, context
// rebuilt in each block's prologue from the 16.5 KB of (E, s); the output
// tile goes through shared memory so that its stores are coalesced in
// either layout.  (Walking
// several tiles per block to pay that prologue once measured slower on the
// H100: 8.38 against 7.64 ms at the 256x256 site, chip_smoke.py.)  Arithmetic
// is fp32 on CUDA cores; tensor cores come later.
//
// x and out are addressed through element strides, so the UNet's NCHW
// activations (token stride 1) are read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;                  // dim_head
constexpr int HD = HEADS * DH;          // 128
constexpr int WCOLS = 3 * HD;           // row length of w_qkv
constexpr int CTX = HEADS * DH * DH;    // diagonal blocks of E / context
constexpr int SUMS = CTX + HD;          // per batch: E blocks, then s
constexpr int TILE = 64;                // tokens per tile
constexpr int KC = 32;                  // channels staged per step
constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 132 * 2 * 4;  // pass 1: four waves of two blocks per SM
constexpr float CLIP = 60.0f;
constexpr float SCALE = 0.17677669529663687f;  // dim_head^-0.5

// shared floats of a pass-1 block: x and W chunks, ek and v of a tile,
// g.W, the tile's statistics and a reduction scratch
constexpr int P1_FLOATS = KC * TILE + KC * 2 * HD + 2 * TILE * HD + 2 * HD + 2 * TILE + 4 * TILE;
// of a pass-2 block: x and Wq chunks, context, eq of a tile (then its
// output, rows padded to OS_LD), g.Wq, statistics
constexpr int OS_LD = HD + 1;
constexpr int P2_FLOATS = KC * TILE + KC * HD + CTX + TILE * OS_LD + HD + 2 * TILE;

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

struct Strides {
  long long b, n, c;
};

__device__ __forceinline__ float clipped_exp(float v) {
  return expf(fminf(fmaxf(v, -CLIP), CLIP));
}

// u[col] = sum_c g[c] W[c][wcol0 + col] (fp32, unrounded W), for NCOL columns
template <int NCOL>
__device__ void gain_times_w(const float* __restrict__ w, const float* __restrict__ g,
                             int C, int wcol0, float* us) {
  for (int col = threadIdx.x; col < NCOL; col += THREADS) {
    float u = 0.0f;
    for (int c = 0; c < C; ++c) u = fmaf(g[c], w[(long long)c * WCOLS + wcol0 + col], u);
    us[col] = u;
  }
}

// LayerNorm statistics of the tile's tokens over C, two-pass in fp32 as
// jnp.var: four threads per token walk the channels, token index fastest
// (coalesced for the UNet's token-stride-1 layout).
template <typename T>
__device__ void tile_stats(const T* __restrict__ xb, Strides sx, int t0, int N, int C,
                           float* red, float* mean_s, float* rstd_s) {
  const int t = threadIdx.x % TILE, part = threadIdx.x / TILE;
  const int tok = t0 + t;
  float sum = 0.0f;
  if (tok < N)
    for (int c = part; c < C; c += 4) sum += IO<T>::load(xb + tok * sx.n + c * sx.c);
  red[part * TILE + t] = sum;
  __syncthreads();
  if (part == 0)
    mean_s[t] = (red[t] + red[TILE + t] + red[2 * TILE + t] + red[3 * TILE + t]) / (float)C;
  __syncthreads();
  const float m = mean_s[t];
  float sq = 0.0f;
  if (tok < N)
    for (int c = part; c < C; c += 4) {
      const float d = IO<T>::load(xb + tok * sx.n + c * sx.c) - m;
      sq = fmaf(d, d, sq);
    }
  red[part * TILE + t] = sq;
  __syncthreads();
  if (part == 0) {
    const float var = (red[t] + red[TILE + t] + red[2 * TILE + t] + red[3 * TILE + t]) / (float)C;
    rstd_s[t] = 1.0f / sqrtf(var + 1e-5f);
  }
  __syncthreads();
}

// Register-tiled projection of one 64-token tile: thread (i = tid / 32,
// j = tid % 32) accumulates tokens 8i..8i+7 x, for each group gi < NG,
// columns gi*128 + 4j .. +3 of the NG*128 columns starting at wcol0.
template <typename T, int NG, bool PRENORM>
__device__ void project_tile(const T* __restrict__ xb, Strides sx, int t0, int N, int C,
                             const float* __restrict__ w, const float* __restrict__ g,
                             int wcol0, float* xs, float* ws, float (&acc)[8][NG * 4]) {
  constexpr int NCOL = NG * HD;
  const int tid = threadIdx.x, i = tid / 32, j = tid % 32;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < NG * 4; ++q) acc[r][q] = 0.0f;
  for (int c0 = 0; c0 < C; c0 += KC) {
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int cc = c0 + e / TILE, tok = t0 + e % TILE;
      xs[e] = (cc < C && tok < N) ? IO<T>::load(xb + tok * sx.n + cc * sx.c) : 0.0f;
    }
    for (int e = tid; e < KC * NCOL; e += THREADS) {
      const int cc = c0 + e / NCOL;
      float v = 0.0f;
      if (cc < C) {
        v = w[(long long)cc * WCOLS + wcol0 + e % NCOL];
        if (PRENORM) v *= g[cc];
        v = IO<T>::round(v);
      }
      ws[e] = v;
    }
    __syncthreads();
    const int kmax = min(KC, C - c0);
    for (int c = 0; c < kmax; ++c) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + c * TILE + 8 * i);
      const float4 xb4 = *reinterpret_cast<const float4*>(xs + c * TILE + 8 * i + 4);
      const float a[8] = {xa.x, xa.y, xa.z, xa.w, xb4.x, xb4.y, xb4.z, xb4.w};
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + c * NCOL + gi * HD + 4 * j);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][gi * 4 + 0] = fmaf(a[r], wv.x, acc[r][gi * 4 + 0]);
          acc[r][gi * 4 + 1] = fmaf(a[r], wv.y, acc[r][gi * 4 + 1]);
          acc[r][gi * 4 + 2] = fmaf(a[r], wv.z, acc[r][gi * 4 + 2]);
          acc[r][gi * 4 + 3] = fmaf(a[r], wv.w, acc[r][gi * 4 + 3]);
        }
      }
    }
    __syncthreads();
  }
}

// The projection's epilogue: prenorm correction, then rounding to dt.
template <typename T, bool PRENORM>
__device__ __forceinline__ float finish(float a, float u, float mean, float rstd) {
  if (PRENORM) a = (a - mean * u) * rstd;
  return IO<T>::round(a);
}

// Statistics of the tile: computed (and written out for pass 2) or read.
template <typename T, bool PRENORM, bool COMPUTE_STATS>
__device__ void tile_prenorm(const T* xb, Strides sx, int b, int t0, int N, int C,
                             float* mean, float* rstd, float* red, float* mean_s, float* rstd_s) {
  if (!PRENORM) return;
  const int tok = t0 + threadIdx.x;
  if (COMPUTE_STATS) {
    tile_stats<T>(xb, sx, t0, N, C, red, mean_s, rstd_s);
    if (threadIdx.x < TILE && tok < N) {
      mean[(long long)b * N + tok] = mean_s[threadIdx.x];
      rstd[(long long)b * N + tok] = rstd_s[threadIdx.x];
    }
  } else if (threadIdx.x < TILE) {
    mean_s[threadIdx.x] = tok < N ? mean[(long long)b * N + tok] : 0.0f;
    rstd_s[threadIdx.x] = tok < N ? rstd[(long long)b * N + tok] : 0.0f;
  }
}

template <typename T, bool PRENORM, bool COMPUTE_STATS>
__global__ void __launch_bounds__(THREADS, 2)
linear_attention_pass1_kernel(const T* __restrict__ x, Strides sx, const float* __restrict__ w,
                              const float* __restrict__ g, float* mean, float* rstd,
                              float* __restrict__ sums, int N, int C, int tiles_per_block,
                              int blocks_per_batch) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + KC * TILE;
  float* eks = ws + KC * 2 * HD;
  float* vs = eks + TILE * HD;
  float* us = vs + TILE * HD;
  float* mean_s = us + 2 * HD;
  float* rstd_s = mean_s + TILE;
  float* red = rstd_s + TILE;

  const int tid = threadIdx.x, i = tid / 32, j = tid % 32;
  const int b = blockIdx.x / blocks_per_batch;
  const int n_tiles = (N + TILE - 1) / TILE;
  const int tile0 = (blockIdx.x % blocks_per_batch) * tiles_per_block;
  const int tile1 = min(n_tiles, tile0 + tiles_per_block);
  const T* xb = x + b * sx.b;
  if (PRENORM) gain_times_w<2 * HD>(w, g, C, HD, us);  // k and v columns

  // E accumulators: head h, rows dg*4..+3, columns eg*4..+3 of its block
  const int h = tid / 64, dg = (tid % 64) / 8, eg = tid % 8;
  float e_acc[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) e_acc[q] = 0.0f;
  float s_acc = 0.0f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int t0 = tile * TILE;
    tile_prenorm<T, PRENORM, COMPUTE_STATS>(xb, sx, b, t0, N, C, mean, rstd, red, mean_s, rstd_s);
    float acc[8][8];
    project_tile<T, 2, PRENORM>(xb, sx, t0, N, C, w, g, HD, xs, ws, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = 8 * i + r;
      const bool valid = t0 + t < N;
      const float m = PRENORM ? mean_s[t] : 0.0f, rs = PRENORM ? rstd_s[t] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 4 * j + q;
        const float k = finish<T, PRENORM>(acc[r][q], PRENORM ? us[col] : 0.0f, m, rs);
        const float v = finish<T, PRENORM>(acc[r][4 + q], PRENORM ? us[HD + col] : 0.0f, m, rs);
        eks[t * HD + col] = valid ? IO<T>::round(clipped_exp(k)) : 0.0f;
        vs[t * HD + col] = valid ? v : 0.0f;
      }
    }
    __syncthreads();
    const int n_valid = min(TILE, N - t0);
    for (int t = 0; t < n_valid; ++t) {
      const float4 kk = *reinterpret_cast<const float4*>(eks + t * HD + h * DH + dg * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vs + t * HD + h * DH + eg * 4);
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) e_acc[a * 4 + c] = fmaf(ka[a], va[c], e_acc[a * 4 + c]);
    }
    if (tid < HD)
      for (int t = 0; t < n_valid; ++t) s_acc += eks[t * HD + tid];
    __syncthreads();
  }
  float* out = sums + (long long)b * SUMS;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      atomicAdd(out + h * DH * DH + (dg * 4 + a) * DH + eg * 4 + c, e_acc[a * 4 + c]);
  if (tid < HD) atomicAdd(out + CTX + tid, s_acc);
}

template <typename T, bool PRENORM>
__global__ void __launch_bounds__(THREADS)
linear_attention_pass2_kernel(const T* __restrict__ x, Strides sx, const float* __restrict__ w,
                              const float* __restrict__ g, float* mean, float* rstd,
                              const float* __restrict__ sums, T* __restrict__ out, Strides so,
                              int N, int C) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + KC * TILE;
  float* ctx = ws + KC * HD;
  float* eqs = ctx + CTX;
  float* us = eqs + TILE * OS_LD;
  float* mean_s = us + HD;
  float* rstd_s = mean_s + TILE;

  const int tid = threadIdx.x, i = tid / 32, j = tid % 32;
  const int n_tiles = (N + TILE - 1) / TILE;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * TILE;
  const T* xb = x + b * sx.b;

  // context = round(E * scale / (s * N)), row d of head h normalized by s[h*32 + d]
  const float* sb = sums + (long long)b * SUMS;
  for (int e = tid; e < CTX; e += THREADS) {
    const int row = (e / (DH * DH)) * DH + (e / DH) % DH;
    ctx[e] = IO<T>::round((sb[e] * SCALE) / (sb[CTX + row] * (float)N));
  }
  if (PRENORM) gain_times_w<HD>(w, g, C, 0, us);  // q columns
  tile_prenorm<T, PRENORM, false>(xb, sx, b, t0, N, C, mean, rstd, nullptr, mean_s, rstd_s);

  float acc[8][4];
  project_tile<T, 1, PRENORM>(xb, sx, t0, N, C, w, g, 0, xs, ws, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = 8 * i + r;
    const float m = PRENORM ? mean_s[t] : 0.0f, rs = PRENORM ? rstd_s[t] : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * j + q;
      const float qv = finish<T, PRENORM>(acc[r][q], PRENORM ? us[col] : 0.0f, m, rs);
      eqs[t * HD + col] = IO<T>::round(clipped_exp(qv));
    }
  }
  __syncthreads();

  // thread (i, j): tokens 8i..8i+7, columns 4j..4j+3 of head h = j / 8
  const int h = j / 8, e0 = (j % 8) * 4;
  float num[8][4], den[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    den[r] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) num[r][q] = 0.0f;
  }
  for (int d = 0; d < DH; ++d) {
    const float4 cc = *reinterpret_cast<const float4*>(ctx + h * DH * DH + d * DH + e0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float a = eqs[(8 * i + r) * HD + h * DH + d];
      num[r][0] = fmaf(a, cc.x, num[r][0]);
      num[r][1] = fmaf(a, cc.y, num[r][1]);
      num[r][2] = fmaf(a, cc.z, num[r][2]);
      num[r][3] = fmaf(a, cc.w, num[r][3]);
      den[r] += a;
    }
  }
  // stage the tile's output in shared memory (over eq, rows padded), then
  // store it with neighbouring threads on neighbouring addresses
  __syncthreads();
  float* os = eqs;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float dn = IO<T>::round(den[r]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      os[(8 * i + r) * OS_LD + 4 * j + q] = IO<T>::round(num[r][q]) / dn;
  }
  __syncthreads();
  T* ob = out + b * so.b;
  const bool token_fastest = so.n == 1;
  for (int e = tid; e < TILE * HD; e += THREADS) {
    const int t = token_fastest ? e % TILE : e / HD;
    const int col = token_fastest ? e / TILE : e % HD;
    if (t0 + t < N) IO<T>::store(ob + (t0 + t) * so.n + col * so.c, os[t * OS_LD + col]);
  }
}

template <typename T, bool PRENORM, bool COMPUTE_STATS>
int pass1(const void* x, Strides sx, const float* w, const float* g, float* mean, float* rstd,
          float* sums, int B, int N, int C, cudaStream_t stream) {
  const int n_tiles = (N + TILE - 1) / TILE;
  const long long total = (long long)B * n_tiles;
  const int per = (int)((total + TARGET_BLOCKS - 1) / TARGET_BLOCKS);
  const int tiles_per_block = per < 1 ? 1 : per;
  const int blocks_per_batch = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const size_t smem = P1_FLOATS * sizeof(float);
  auto kernel = linear_attention_pass1_kernel<T, PRENORM, COMPUTE_STATS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * blocks_per_batch, THREADS, smem, stream>>>(
      static_cast<const T*>(x), sx, w, g, mean, rstd, sums, N, C, tiles_per_block,
      blocks_per_batch);
  return (int)cudaGetLastError();
}

template <typename T, bool PRENORM>
int pass2(const void* x, Strides sx, const float* w, const float* g, float* mean, float* rstd,
          const float* sums, void* out, Strides so, int B, int N, int C, cudaStream_t stream) {
  const int n_tiles = (N + TILE - 1) / TILE;
  const size_t smem = P2_FLOATS * sizeof(float);
  auto kernel = linear_attention_pass2_kernel<T, PRENORM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * n_tiles, THREADS, smem, stream>>>(static_cast<const T*>(x), sx, w, g, mean, rstd,
                                                  sums, static_cast<T*>(out), so, N, C);
  return (int)cudaGetLastError();
}

template <typename T>
int pass1_dispatch(const void* x, Strides sx, const float* w, const float* g, float* mean,
                   float* rstd, int compute_stats, float* sums, int B, int N, int C,
                   cudaStream_t s) {
  if (g == nullptr) return pass1<T, false, false>(x, sx, w, g, mean, rstd, sums, B, N, C, s);
  if (compute_stats) return pass1<T, true, true>(x, sx, w, g, mean, rstd, sums, B, N, C, s);
  return pass1<T, true, false>(x, sx, w, g, mean, rstd, sums, B, N, C, s);
}

}  // namespace

extern "C" {

// Pass 1: adds (E blocks, s) of every batch into sums (B, 4096 + 128), which
// the caller zeroes.  g == NULL: no prenorm.  Otherwise mean and rstd
// (B, N) fp32 are computed and written (compute_stats = 1) or read.
int dmh_linear_attention_pass1(const void* x, long long sxb, long long sxn, long long sxc,
                               const float* w_qkv, const float* g, float* mean, float* rstd,
                               int compute_stats, float* sums, int B, int N, int C, int bf16,
                               void* stream) {
  const Strides sx{sxb, sxn, sxc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pass1_dispatch<__nv_bfloat16>(x, sx, w_qkv, g, mean, rstd, compute_stats, sums, B, N,
                                         C, s);
  return pass1_dispatch<float>(x, sx, w_qkv, g, mean, rstd, compute_stats, sums, B, N, C, s);
}

// Pass 2: out (B, N, 128) through its element strides.  With g, mean and
// rstd (B, N) are read.
int dmh_linear_attention_pass2(const void* x, long long sxb, long long sxn, long long sxc,
                               const float* w_qkv, const float* g, float* mean, float* rstd,
                               const float* sums, void* out, long long sob, long long son,
                               long long soc, int B, int N, int C, int bf16, void* stream) {
  const Strides sx{sxb, sxn, sxc}, so{sob, son, soc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (g) return pass2<__nv_bfloat16, true>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, s);
    return pass2<__nv_bfloat16, false>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, s);
  }
  if (g) return pass2<float, true>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, s);
  return pass2<float, false>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, s);
}

// Dynamic shared memory of one block of pass 1 or pass 2.
int dmh_linear_attention_smem_bytes(int pass) {
  return (pass == 1 ? P1_FLOATS : P2_FLOATS) * (int)sizeof(float);
}

}  // extern "C"
