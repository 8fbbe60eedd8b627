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
// flops each for E and for eq . context.  On bf16 tensor cores pass 1 sits
// at the ridge (about 260-320 flops per byte of x read at C = 64..512) and
// pass 2 is bytes bound at every site; on fp32 CUDA cores (67 TFLOP/s)
// both are operations bound.
//
// bf16 (the UNet's generation path): the tensor-core kernels of namespace
// tc below, mma.sync m16n8k16 fed by ldmatrix from shared memory, x staged
// through a ring of 16-byte cp.async copies, persistent blocks, x read from
// device memory once per pass; their notes are there.
//
// fp32 (kept for the fp32 UNet and the tests; its 1e-5 tolerance rules out
// bf16 tensor cores, and TF32 stays off): a block of 256 threads projects
// 64-token tiles as a register-tiled SGEMM on CUDA cores: x and W are
// staged 32 channels at a time in shared memory (W is streamed, so C = 512
// fits), and each thread owns 8 tokens x 8 columns (pass 1) or 8 x 4 (pass
// 2).  The LayerNorm statistics are read from L2 in two extra passes over
// the tile.  Pass 1 keeps the tile's ek and v in shared memory, accumulates
// its share of the diagonal blocks of E in registers over several tiles,
// and writes them (and s) to the block's own slot of a partials buffer.  Pass 2 needs no reduction: one tile per block,
// context rebuilt in each block's prologue from the 16.5 KB of (E, s); the
// output tile goes through shared memory so that its stores are coalesced
// in either layout.
//
// In both dtypes pass 1 uses no atomics: every block (bf16: every warp, for
// each batch row its tiles meet) writes its partial (E, s) to a slot of its
// own, and a second launch (linear_attention_reduce_kernel*) sums each batch
// row's slots in a fixed order, so reruns give the same bits.  The slots
// are the caller's scratch, sized by dmh_linear_attention_pass1_partials.
// x and out are addressed through element strides, so the UNet's NCHW
// activations (token stride 1) are read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;                  // dim_head
constexpr int HD = HEADS * DH;          // 128
constexpr int WCOLS = 3 * HD;           // row length of w_qkv
constexpr int CTX = HEADS * DH * DH;    // diagonal blocks of E / context
constexpr int SUMS = CTX + HD;          // per batch: E blocks, then s
constexpr int HSLOT = DH * DH + DH;     // one head's partial: its E block, then its s
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
                              float* __restrict__ partials, int N, int C, int tiles_per_block,
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
  // the block's slot: every element written by one thread
  float* out = partials + (long long)blockIdx.x * SUMS;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[h * DH * DH + (dg * 4 + a) * DH + eg * 4 + c] = e_acc[a * 4 + c];
  if (tid < HD) out[CTX + tid] = s_acc;
}

// sums[b] = the blocks_per_batch slots of batch row b, summed in block order
__global__ void __launch_bounds__(THREADS)
linear_attention_reduce_kernel(const float* __restrict__ partials, float* __restrict__ sums,
                               int B, int blocks_per_batch) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * SUMS) return;
  const long long b = i / SUMS;
  const float* p = partials + b * blocks_per_batch * SUMS + i % SUMS;
  float s = 0.0f;
  for (int j = 0; j < blocks_per_batch; ++j) s += p[(long long)j * SUMS];
  sums[i] = s;
}

int reduce_blocks(int B) { return (int)(((long long)B * SUMS + THREADS - 1) / THREADS); }

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

// The fp32 pass 1's tiles per block and blocks per batch row.
void fp32_grid(int B, int N, int* tiles_per_block, int* blocks_per_batch) {
  const int n_tiles = (N + TILE - 1) / TILE;
  const long long total = (long long)B * n_tiles;
  const int per = (int)((total + TARGET_BLOCKS - 1) / TARGET_BLOCKS);
  *tiles_per_block = per < 1 ? 1 : per;
  *blocks_per_batch = (n_tiles + *tiles_per_block - 1) / *tiles_per_block;
}

long long fp32_partials(int B, int N) {
  int tiles_per_block = 0, blocks_per_batch = 0;
  fp32_grid(B, N, &tiles_per_block, &blocks_per_batch);
  return (long long)B * blocks_per_batch * SUMS;
}

template <typename T, bool PRENORM, bool COMPUTE_STATS>
int pass1(const void* x, Strides sx, const float* w, const float* g, float* mean, float* rstd,
          float* sums, float* partials, int B, int N, int C, cudaStream_t stream) {
  int tiles_per_block = 0, blocks_per_batch = 0;
  fp32_grid(B, N, &tiles_per_block, &blocks_per_batch);
  const size_t smem = P1_FLOATS * sizeof(float);
  auto kernel = linear_attention_pass1_kernel<T, PRENORM, COMPUTE_STATS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * blocks_per_batch, THREADS, smem, stream>>>(
      static_cast<const T*>(x), sx, w, g, mean, rstd, partials, N, C, tiles_per_block,
      blocks_per_batch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_attention_reduce_kernel<<<reduce_blocks(B), THREADS, 0, stream>>>(partials, sums, B,
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
                   float* rstd, int compute_stats, float* sums, float* partials, int B, int N,
                   int C, cudaStream_t s) {
  if (g == nullptr)
    return pass1<T, false, false>(x, sx, w, g, mean, rstd, sums, partials, B, N, C, s);
  if (compute_stats)
    return pass1<T, true, true>(x, sx, w, g, mean, rstd, sums, partials, B, N, C, s);
  return pass1<T, true, false>(x, sx, w, g, mean, rstd, sums, partials, B, N, C, s);
}


// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------
//
// A block walks a contiguous range of the flat (batch row, tile) sequence of
// 64-token tiles.  In its prologue it makes its rows of wt = round(diag(g)
// W)^T in shared memory (bf16, channels zero-padded to Cp, a multiple of 16)
// and u = g . W (fp32) from w_qkv and g, once per block, as
// blockdiag_linear_attention makes them once outside its kernels.  Pass 1's
// rows are, per head, its 32 k columns and then its 32 v columns; pass 2's
// the 128 q columns.  Each tile is staged in a ring of 2-3 slots, kc
// channels x 64 tokens (a tile of C > kc channels takes several slots),
// filled by 16-byte cp.async copies (the aligned loader: token stride 1,
// 16-byte aligned channel rows) or by element loads (any strides), channel
// rows padded to 144 bytes so ldmatrix reads them without bank conflicts.
// Where a block's resident weights do not fit (C above about 800) they are
// made again for each chunk of each tile instead ("streamed").  Blocks keep
// to 128 registers a thread, so that two fit on an SM where shared memory
// allows (C <= 128): one block's epilogue (fp32 arithmetic) then overlaps
// the other's tensor-core and shared-memory work.  Measured on the H100,
// pass 1 is bound by that epilogue (256 values a token to correct, round,
// exponentiate and pack), pass 2 by it and by bytes (PERF.md).
//
// Pass 1 projects transposed, qkv^T = wt . x^T: each warp holds the k and v
// rows of one head over 16 tokens at a time, so the accumulators are, after
// the epilogue, the A operand (ek^T: rows d, k = tokens) and the B operand
// (v: k = tokens, columns e) of E_h += ek_h^T v_h, without a pass through
// shared memory.  Pass 2 projects q = x . wt^T with tokens as rows, so eq_h
// is the A operand of num_h = eq_h . context_h, whose B operand (the
// block's context, rebuilt in shared memory once per batch row) comes by
// ldmatrix.  Both read x from device memory once; pass 1 takes the
// LayerNorm statistics from the staged tile.
//
// mma.sync rather than wgmma: wgmma's B operand must sit in shared memory,
// so pass 1 would write ek or v back to shared memory on every tile; with
// mma.sync's per-warp fragments both operands of ek^T v, and the A operand
// of eq . context, pass from the projection's accumulators in registers.

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;            // tokens per tile
constexpr int XLD = T + 8;       // staged channel row, bf16 elements (144 bytes)
constexpr int OLD = T + 8;       // staged output row (one feature), bf16
constexpr int CLD = DH + 8;      // context row, bf16 (80 bytes)
constexpr int NTHREADS = 256;    // 8 warps
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int slot_bytes(int kc) { return kc * XLD * 2 + 2 * T * 4; }

// Channels of the block's weight rows: all of them, or one chunk (streamed).
__host__ __device__ constexpr int weight_cols(int Cp, int kc, int stream) {
  return stream ? kc : Cp;
}

// Dynamic shared memory of a block: pass 1 with hg heads, or pass 2.
__host__ __device__ constexpr int smem_bytes(int pass, int Cp, int hg, int kc, int stages,
                                             int stream) {
  return pass == 1 ? 64 * hg * (weight_cols(Cp, kc, stream) + 8) * 2 + stages * slot_bytes(kc) +
                         64 * hg * 4 + 4 * T * 4
                   : HD * (weight_cols(Cp, kc, stream) + 8) * 2 + stages * slot_bytes(kc) +
                         HD * OLD * 2 + HEADS * DH * CLD * 2 + HD * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until the oldest slot of a ring of `stages` has landed
__device__ __forceinline__ void cp_async_wait_oldest(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b, m16n8k16, bf16 inputs, fp32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// exp(clip(v, +-60)) for a value that is rounded to bf16 next: ex2.approx of
// v * log2(e), within 2 + 1.2 |v| fp32 ulps of exp (CUDA's bound), far
// below a bf16 step (65536 ulps), so the rounding after it differs from
// expf's only for values that close to a rounding boundary, by one bf16
// step; five instructions fewer than expf
__device__ __forceinline__ float clipped_exp_fast(float v) {
  return __expf(fminf(fmaxf(v, -CLIP), CLIP));
}

// the two values of a packed bf16 pair, as fp32
__device__ __forceinline__ float lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// a / b rounded to nearest, from rb = 1 / b rounded to nearest (one
// correction step; exact for the normal, finite operands here)
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

// The block's weights for channels c0 .. c1-1 (c1 - c0 even): row r of ws
// (rows ld apart) holds round(g[c] W[c][col(r)]) (W alone without prenorm),
// zeros from C on; with u_s, u_s[r] = sum_c g[c] W[c][col(r)] (fp32), the
// threads' shares of a row added in the order of their parts.  ws == NULL:
// u alone.  Threads split the rows and, with fewer rows than threads, the
// channels; a warp reads neighbouring columns.  Every thread of the block
// calls it (with u_s it synchronizes).
template <bool PRENORM, typename Col>
__device__ void stage_weights(bf16* ws, int ld, float* u_s, const float* __restrict__ w,
                              const float* __restrict__ g, int rows, int c0, int c1, int C,
                              Col col) {
  const int r = threadIdx.x % rows, parts = NTHREADS / rows, part = threadIdx.x / rows;
  const float* wc = w + col(r);
  float u = 0.0f;
#pragma unroll 4
  for (int c = c0 + 2 * part; c < c1; c += 2 * parts) {
    const float w0 = c < C ? wc[(long long)c * WCOLS] : 0.0f;
    const float w1 = c + 1 < C ? wc[(long long)(c + 1) * WCOLS] : 0.0f;
    const float g0 = PRENORM && c < C ? g[c] : 1.0f, g1 = PRENORM && c + 1 < C ? g[c + 1] : 1.0f;
    u = fmaf(g0, w0, u);
    u = fmaf(g1, w1, u);
    if (ws) *reinterpret_cast<uint32_t*>(ws + r * ld + c - c0) = pack(w0 * g0, w1 * g1);
  }
  if (PRENORM && u_s)
    for (int p = 0; p < parts; ++p) {
      if (part == p) u_s[r] = p == 0 ? u : u_s[r] + u;
      __syncthreads();
    }
}

// Stage channels c0 .. c0+kc-1 of tokens t0 .. t0+63 of batch row b as rows
// of XLD bf16, zeros past C and N; with `stats`, also mean and rstd of the
// tokens (fp32, after the rows).  ALIGNED: 16-byte cp.async copies (token
// stride 1, N and the row strides multiples of 8, 16-byte aligned base);
// otherwise element loads through the strides.
template <bool ALIGNED>
__device__ void load_unit(unsigned char* slot, const bf16* __restrict__ x, Strides sx,
                          const float* mean, const float* rstd, bool stats, int b, int t0,
                          int c0, int kc, int N, int C) {
  bf16* xs = reinterpret_cast<bf16*>(slot);
  float* st = reinterpret_cast<float*>(slot + kc * XLD * 2);
  const bf16* xb = x + b * sx.b;
  const int tid = threadIdx.x;
  if (ALIGNED) {
    for (int e = tid; e < kc * (T / 8); e += NTHREADS) {
      const int row = e >> 3, j = e & 7, c = c0 + row, tok = t0 + 8 * j;
      const bool valid = c < C && tok < N;
      cp_async16(smem_u32(xs + row * XLD + 8 * j), valid ? xb + c * sx.c + tok : x,
                 valid ? 16 : 0);
    }
    if (stats && tid < 2 * (T / 4)) {
      const int which = tid / (T / 4), j = tid % (T / 4), tok = t0 + 4 * j;
      const float* src = which ? rstd : mean;
      const bool valid = tok < N;
      cp_async16(smem_u32(st + which * T + 4 * j), valid ? src + (long long)b * N + tok : src,
                 valid ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kc * T; e += NTHREADS) {
      const int row = e / T, t = e % T, c = c0 + row, tok = t0 + t;
      xs[row * XLD + t] = (c < C && tok < N) ? xb[tok * sx.n + c * sx.c] : __float2bfloat16(0.0f);
    }
    if (stats && tid < 2 * T) {
      const int which = tid / T, t = tid % T, tok = t0 + t;
      st[which * T + t] = tok < N ? (which ? rstd : mean)[(long long)b * N + tok] : 0.0f;
    }
  }
}

// LayerNorm statistics of the staged tile, channel chunk ch: four threads
// per token, two-pass in fp32 within the chunk, chunks merged as Chan et al.
// (for one chunk: exactly the two-pass mean and biased variance).  The last
// chunk leaves mean and rstd of each token in mean_s, rstd_s.
__device__ void chunk_stats(const bf16* xs, int ch, int nch, int kc, int C, float* run_m,
                            float* run_q, float* mean_s, float* rstd_s) {
  const int tk = threadIdx.x / 4, p = threadIdx.x % 4;
  const int cv = max(0, min(kc, C - ch * kc));
  float s = 0.0f;
  for (int c = p; c < cv; c += 4) s += __bfloat162float(xs[c * XLD + tk]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float m = cv > 0 ? s / (float)cv : 0.0f;
  float q = 0.0f;
  for (int c = p; c < cv; c += 4) {
    const float d = __bfloat162float(xs[c * XLD + tk]) - m;
    q = fmaf(d, d, q);
  }
  q += __shfl_xor_sync(0xffffffffu, q, 1);
  q += __shfl_xor_sync(0xffffffffu, q, 2);
  if (p != 0) return;
  float rm = m, rq = q;
  if (ch > 0) {
    const float na = (float)(ch * kc), nb = (float)cv, n = na + nb;
    const float delta = m - run_m[tk];
    rm = run_m[tk] + delta * (nb / n);
    rq = run_q[tk] + q + delta * delta * (na * nb / n);
  }
  run_m[tk] = rm;
  run_q[tk] = rq;
  if (ch == nch - 1) {
    mean_s[tk] = rm;
    rstd_s[tk] = 1.0f / sqrtf(rq / (float)C + 1e-5f);
  }
}

// Pass 1.  HG heads per block (4, or 2 where the resident weights of four do
// not fit; then a tile may take several channel chunks): blockIdx.y picks
// the head group.  Warp w holds head w / (8/HG) over tokens (w % (8/HG)) *
// TW .. +TW of each tile, 16 at a time.  STATS: compute the LayerNorm
// statistics (and write them, head group 0); otherwise, with PRENORM, read
// them.
template <bool PRENORM, bool STATS, bool ALIGNED, int HG>
__global__ void __launch_bounds__(NTHREADS, 2)
linear_attention_pass1_kernel_tc(const bf16* __restrict__ x, Strides sx,
                                 const float* __restrict__ w, const float* __restrict__ g,
                                 float* mean, float* rstd, float* __restrict__ partials,
                                 int B, int N, int C, int Cp, int kc, int nch, int stages,
                                 int stream) {
  constexpr int WPH = 8 / HG;   // warps per head
  constexpr int TW = T / WPH;   // tokens per warp
  constexpr int NH = TW / 16;   // 16-token steps per warp (NH > 1 only with one chunk)
  constexpr int R = 64 * HG;    // resident rows of wt
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  const int wld = weight_cols(Cp, kc, stream) + 8;  // weight row, bf16
  unsigned char* ring = smem + R * wld * 2;
  const int sbytes = slot_bytes(kc);
  float* u_s = reinterpret_cast<float*>(ring + stages * sbytes);
  float* mean_s = u_s + R;
  float* rstd_s = mean_s + T;
  float* run_m = rstd_s + T;
  float* run_q = run_m + T;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hl = warp / WPH, tp = warp % WPH, hg = blockIdx.y;
  const int n_tiles = (N + T - 1) / T;
  const long long total = (long long)B * n_tiles;
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;
  const long long n_units = (last - first) * nch;
  constexpr bool STATS_IN_RING = PRENORM && !STATS;

  auto fetch = [&](long long unit) {
    if (unit < n_units) {
      const long long flat = first + unit / nch;
      const int ch = (int)(unit % nch);
      load_unit<ALIGNED>(ring + (int)(unit % stages) * sbytes, x, sx, mean, rstd,
                         STATS_IN_RING && ch == nch - 1, (int)(flat / n_tiles),
                         (int)(flat % n_tiles) * T, ch * kc, kc, N, C);
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);  // x flies while the weights are made
  auto col = [&](int r) {
    const int h = hg * HG + r / 64;  // row r: head h, k (r % 64 < 32) or v, d = r % 32
    return HD + ((r % 64) / DH) * HD + h * DH + r % DH;
  };
  if (!stream || PRENORM)  // streamed weights come chunk by chunk in the loop
    stage_weights<PRENORM>(stream ? nullptr : ws, wld, u_s, w, g, R, 0, Cp, C, col);

  float acc[4][2][4];  // rows hl*64 + 16i .., tokens 8j .. of the warp's 16
  float e_acc[2][4][4];
  float s_acc[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    s_acc[mi][0] = s_acc[mi][1] = 0.0f;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) e_acc[mi][ni][q] = 0.0f;
  }
  const uint32_t ws_addr = smem_u32(ws);

  for (long long un = 0; un < n_units; ++un) {
    cp_async_wait_oldest(stages);
    __syncthreads();
    fetch(un + stages - 1);
    unsigned char* slot = ring + (int)(un % stages) * sbytes;
    const bf16* xs = reinterpret_cast<const bf16*>(slot);
    const long long flat = first + un / nch;
    const int ch = (int)(un % nch);
    const bool last_chunk = ch == nch - 1;
    const int b = (int)(flat / n_tiles), t0 = (int)(flat % n_tiles) * T;
    const int kv = min(kc, Cp - ch * kc), wc0 = stream ? 0 : ch * kc;
    if (stream) stage_weights<PRENORM>(ws, wld, nullptr, w, g, R, ch * kc, ch * kc + kv, C, col);
    if (PRENORM && STATS) chunk_stats(xs, ch, nch, kc, C, run_m, run_q, mean_s, rstd_s);
    if (stream || (PRENORM && STATS && last_chunk)) __syncthreads();  // weights; statistics
    const float* st = reinterpret_cast<const float*>(slot + kc * XLD * 2);
    const float* m_src = STATS ? mean_s : st;
    const float* r_src = STATS ? rstd_s : st + T;
    const uint32_t xs_addr = smem_u32(xs);

#pragma unroll 1
    for (int hs = 0; hs < NH; ++hs) {
      const int tw0 = tp * TW + 16 * hs;  // the warp's 16 tokens in the tile
      if (NH > 1 || ch == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
      }
      // projection: acc[i][j] += wt rows (hl*64 + 16i ..) . x^T (tokens tw0 + 8j ..)
      for (int kk = 0; kk < kv; kk += 16) {
        uint32_t r[4];
        ldsm_x4_trans(r, xs_addr + ((kk + (lane & 15)) * XLD + tw0 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[4];
          ldsm_x4(a, ws_addr + ((hl * 64 + 16 * i + (lane & 15)) * wld + wc0 + kk +
                                (lane >> 4) * 8) * 2);
          mma(acc[i][0], a, r[0], r[1]);
          mma(acc[i][1], a, r[2], r[3]);
        }
      }
      if (!last_chunk) continue;

      // epilogue: prenorm correction; k rounded, ek = round(exp(clip(k))) and
      // v rounded as packed bf16 pairs of neighbouring tokens, which are the
      // mma operands as they stand; both zero past N
      uint32_t pk[4][2][2];  // rows 16i (+8 qr), tokens 8j + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = tw0 + 8 * j + 2 * (lane & 3);
        const bool ok0 = t0 + t < N, ok1 = t0 + t + 1 < N;
        const float m0 = PRENORM ? m_src[t] : 0.0f, m1 = PRENORM ? m_src[t + 1] : 0.0f;
        const float r0 = PRENORM ? r_src[t] : 0.0f, r1 = PRENORM ? r_src[t + 1] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int qr = 0; qr < 2; ++qr) {
            float a0 = acc[i][j][2 * qr], a1 = acc[i][j][2 * qr + 1];
            if (PRENORM) {
              const float uu = u_s[hl * 64 + 16 * i + (lane >> 2) + 8 * qr];
              a0 = (a0 - m0 * uu) * r0;
              a1 = (a1 - m1 * uu) * r1;
            }
            if (i < 2) {
              const uint32_t k = pack(a0, a1);
              a0 = clipped_exp_fast(lo(k));
              a1 = clipped_exp_fast(hi(k));
            }
            pk[i][j][qr] = pack(ok0 ? a0 : 0.0f, ok1 ? a1 : 0.0f);
          }
      }
      // s and E_h += ek_h^T v_h: A = ek^T (rows d, k = tokens), B = v (k =
      // tokens, columns e)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int qr = 0; qr < 2; ++qr)
#pragma unroll
          for (int j = 0; j < 2; ++j) s_acc[mi][qr] += lo(pk[mi][j][qr]) + hi(pk[mi][j][qr]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int i = 2 + ni / 2, hq = ni % 2;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint32_t af[4] = {pk[mi][0][0], pk[mi][0][1], pk[mi][1][0], pk[mi][1][1]};
          mma(e_acc[mi][ni], af, pk[i][0][hq], pk[i][1][hq]);
        }
      }
    }
    if (!last_chunk) continue;
    if (STATS && hg == 0 && tid < T && t0 + tid < N) {
      mean[(long long)b * N + t0 + tid] = mean_s[tid];
      rstd[(long long)b * N + t0 + tid] = rstd_s[tid];
    }
    // the block's share of batch row b is complete: each warp writes its
    // (E_h, s_h) to its own slot, (head group, block + b, warp); every
    // element of the slot by one lane
    if (flat + 1 == last || (flat + 1) % n_tiles == 0) {
      float* out = partials +
                   ((long long)(hg * (gridDim.x + B - 1) + blockIdx.x + b) * 8 + warp) * HSLOT;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int d = 16 * mi + (lane >> 2) + 8 * (q >> 1), e = 8 * ni + 2 * (lane & 3) + (q & 1);
            out[d * DH + e] = e_acc[mi][ni][q];
            e_acc[mi][ni][q] = 0.0f;
          }
#pragma unroll
        for (int qr = 0; qr < 2; ++qr) {
          float v = s_acc[mi][qr];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if ((lane & 3) == 0) out[DH * DH + 16 * mi + (lane >> 2) + 8 * qr] = v;
          s_acc[mi][qr] = 0.0f;
        }
      }
    }
  }
  cp_async_wait_oldest(2);  // no copy outlives the block
}

// sums[b] from pass 1's slots: for batch row b, the blocks k whose tile
// ranges meet it (k_lo .. k_hi of each head group's G blocks) and the
// head's warps, summed in that order.  The block holding flat tile f is
// ceil((f + 1) G / total) - 1, as pass 1 splits the total tiles.
__global__ void __launch_bounds__(NTHREADS)
linear_attention_reduce_kernel_tc(const float* __restrict__ partials, float* __restrict__ sums,
                                  int B, int n_tiles, int G, int hg) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= (long long)B * SUMS) return;
  const int b = (int)(i / SUMS), e = (int)(i % SUMS);
  const int h = e < CTX ? e / (DH * DH) : (e - CTX) / DH;
  const int off = e < CTX ? e % (DH * DH) : DH * DH + (e - CTX) % DH;
  const int wph = 8 / hg, group = h / hg, hl = h % hg;
  const long long total = (long long)B * n_tiles;
  const long long f0 = (long long)b * n_tiles, f1 = f0 + n_tiles - 1;
  const long long k_lo = ((f0 + 1) * G + total - 1) / total - 1;
  const long long k_hi = ((f1 + 1) * G + total - 1) / total - 1;
  const float* p = partials + off;
  float s = 0.0f;
  for (long long k = k_lo; k <= k_hi; ++k) {
    const long long slot = ((long long)group * (G + B - 1) + k + b) * 8 + hl * wph;
    for (int t = 0; t < wph; ++t) s += p[(slot + t) * HSLOT];
  }
  sums[i] = s;
}

// Pass 2.  Warp w holds tokens 16 (w % 4) .. +16 of each tile and heads
// 2 (w / 4), +1 (q columns 64 (w / 4) .. +64).
template <bool PRENORM, bool ALIGNED>
__global__ void __launch_bounds__(NTHREADS, 2)
linear_attention_pass2_kernel_tc(const bf16* __restrict__ x, Strides sx,
                                 const float* __restrict__ w, const float* __restrict__ g,
                                 const float* mean, const float* rstd,
                                 const float* __restrict__ sums, bf16* __restrict__ out,
                                 Strides so, int aligned_out, int B, int N, int C, int Cp,
                                 int kc, int nch, int stages, int stream) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  const int wld = weight_cols(Cp, kc, stream) + 8;  // weight row, bf16
  unsigned char* ring = smem + HD * wld * 2;
  const int sbytes = slot_bytes(kc);
  bf16* os = reinterpret_cast<bf16*>(ring + stages * sbytes);  // output tile, rows = features
  bf16* cs = os + HD * OLD;                                      // context, rows (h, d)
  float* u_s = reinterpret_cast<float*>(cs + HEADS * DH * CLD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp % 4, hp = warp / 4;
  const int n_tiles = (N + T - 1) / T;
  const long long total = (long long)B * n_tiles;
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;
  const long long n_units = (last - first) * nch;

  auto fetch = [&](long long unit) {
    if (unit < n_units) {
      const long long flat = first + unit / nch;
      const int ch = (int)(unit % nch);
      load_unit<ALIGNED>(ring + (int)(unit % stages) * sbytes, x, sx, mean, rstd,
                         PRENORM && ch == nch - 1, (int)(flat / n_tiles),
                         (int)(flat % n_tiles) * T, ch * kc, kc, N, C);
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);
  auto col = [](int r) { return r; };
  if (!stream || PRENORM)
    stage_weights<PRENORM>(stream ? nullptr : ws, wld, u_s, w, g, HD, 0, Cp, C, col);

  float acc[8][4];
  int cur_b = -1;
  const uint32_t ws_addr = smem_u32(ws), cs_addr = smem_u32(cs);

  for (long long un = 0; un < n_units; ++un) {
    cp_async_wait_oldest(stages);
    __syncthreads();
    fetch(un + stages - 1);
    unsigned char* slot = ring + (int)(un % stages) * sbytes;
    const long long flat = first + un / nch;
    const int ch = (int)(un % nch);
    const int b = (int)(flat / n_tiles), t0 = (int)(flat % n_tiles) * T;
    if (ch == 0) {
      if (b != cur_b) {
        // context_h = round(E_h * 32^-0.5 / (s_h * N)), rows (h, d), once per batch row
        const float* sb = sums + (long long)b * SUMS;
        for (int e = tid; e < CTX; e += NTHREADS) {
          const int row = e / DH;  // h * 32 + d
          cs[row * CLD + e % DH] = __float2bfloat16_rn((sb[e] * SCALE) / (sb[CTX + row] * (float)N));
        }
        __syncthreads();
        cur_b = b;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
    }

    const int kv = min(kc, Cp - ch * kc), wc0 = stream ? 0 : ch * kc;
    if (stream) {
      stage_weights<PRENORM>(ws, wld, nullptr, w, g, HD, ch * kc, ch * kc + kv, C, col);
      __syncthreads();
    }
    // projection: acc[j] += x (tokens 16 mt ..) . wt^T (columns 64 hp + 8j ..)
    const uint32_t xs_addr = smem_u32(slot);
    for (int kk = 0; kk < kv; kk += 16) {
      uint32_t a[4];
      ldsm_x4_trans(a, xs_addr + ((kk + (lane & 7) + ((lane >> 4) << 3)) * XLD + 16 * mt +
                                  ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t r[4];
        ldsm_x4(r, ws_addr + ((64 * hp + 16 * nb + (lane & 7) + ((lane >> 4) << 3)) * wld +
                              wc0 + kk + ((lane >> 3) & 1) * 8) * 2);
        mma(acc[2 * nb], a, r[0], r[1]);
        mma(acc[2 * nb + 1], a, r[2], r[3]);
      }
    }
    if (ch != nch - 1) continue;

    // epilogue: eq = round(exp(clip(q))); den_h fp32 sums of eq, rounded;
    // num_h = eq_h . context_h; out = round(round(num) / den)
    const float* st = reinterpret_cast<const float*>(slot + kc * XLD * 2);
    float m[2], rs[2];
#pragma unroll
    for (int qr = 0; qr < 2; ++qr) {
      const int t = 16 * mt + (lane >> 2) + 8 * qr;
      m[qr] = PRENORM ? st[t] : 0.0f;
      rs[qr] = PRENORM ? st[T + t] : 0.0f;
    }
    // eq as packed bf16 pairs of neighbouring columns: the A operand as it stands
    uint32_t pq[8][2];  // columns 64 hp + 8j + 2 (lane % 4) + {0, 1}, rows (lane / 4) + 8 qr
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = 64 * hp + 8 * j + 2 * (lane & 3);
      const float u0 = PRENORM ? u_s[f] : 0.0f, u1 = PRENORM ? u_s[f + 1] : 0.0f;
#pragma unroll
      for (int qr = 0; qr < 2; ++qr) {
        float a0 = acc[j][2 * qr], a1 = acc[j][2 * qr + 1];
        if (PRENORM) {
          a0 = (a0 - m[qr] * u0) * rs[qr];
          a1 = (a1 - m[qr] * u1) * rs[qr];
        }
        const uint32_t q = pack(a0, a1);
        pq[j][qr] = pack(clipped_exp_fast(lo(q)), clipped_exp_fast(hi(q)));
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float den[2], rden[2];
#pragma unroll
      for (int qr = 0; qr < 2; ++qr) {
        float d = 0.0f;
#pragma unroll
        for (int j = 4 * hh; j < 4 * hh + 4; ++j) d += lo(pq[j][qr]) + hi(pq[j][qr]);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        den[qr] = round_bf16(d);
        rden[qr] = 1.0f / den[qr];
      }
      float num[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) num[n][q] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = 4 * hh + 2 * kk;
        const uint32_t af[4] = {pq[j][0], pq[j][1], pq[j + 1][0], pq[j + 1][1]};
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {  // context rows d = 16kk .., columns e = 16nb ..
          uint32_t r[4];
          ldsm_x4_trans(r, cs_addr + (((2 * hp + hh) * DH + 16 * kk + (lane & 15)) * CLD +
                                      16 * nb + (lane >> 4) * 8) * 2);
          mma(num[2 * nb], af, r[0], r[1]);
          mma(num[2 * nb + 1], af, r[2], r[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int qr = 0; qr < 2; ++qr) {
          const int f = 64 * hp + 32 * hh + 8 * n + 2 * (lane & 3);
          const int t = 16 * mt + (lane >> 2) + 8 * qr;
          const uint32_t nr = pack(num[n][2 * qr], num[n][2 * qr + 1]);
          const __nv_bfloat162 o = __floats2bfloat162_rn(div_rn(lo(nr), den[qr], rden[qr]),
                                                         div_rn(hi(nr), den[qr], rden[qr]));
          os[f * OLD + t] = o.x;
          os[(f + 1) * OLD + t] = o.y;
        }
    }
    __syncthreads();
    // store the tile in the caller's layout
    bf16* ob = out + b * so.b;
    if (aligned_out) {
      for (int e = tid; e < HD * (T / 8); e += NTHREADS) {
        const int f = e / (T / 8), j = e % (T / 8), tok = t0 + 8 * j;
        if (tok < N)
          *reinterpret_cast<uint4*>(ob + f * so.c + tok) =
              *reinterpret_cast<const uint4*>(os + f * OLD + 8 * j);
      }
    } else {
      const bool token_fastest = so.n <= so.c;
      for (int e = tid; e < HD * T; e += NTHREADS) {
        const int t = token_fastest ? e % T : e / HD, f = token_fastest ? e / T : e % HD;
        if (t0 + t < N) ob[(t0 + t) * so.n + f * so.c] = os[f * OLD + t];
      }
    }
  }
  cp_async_wait_oldest(2);
}

// The blocks the card holds at once: blocks per SM times SMs.
template <typename K>
int resident_blocks(K kernel, int smem, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return 0;
}

// A plan the kernels take: four heads per pass-1 block only with one chunk.
bool plan_ok(int pass, int C, int Cp, int hg, int kc, int stages, int stream) {
  return Cp % 16 == 0 && Cp >= C && kc % 16 == 0 && kc > 0 && kc <= Cp &&
         (stages == 2 || stages == 3) && (stream == 0 || stream == 1) &&
         (pass == 2 || hg == 2 || (hg == 4 && kc == Cp)) &&
         smem_bytes(pass, Cp, hg, kc, stages, stream) <= SMEM_LIMIT;
}

// One bf16 pass-1 call: its arguments, the partials' capacity, and where
// the launch goes (the grid and the partials it needs are computed first).
struct Pass1Call {
  const void* x;
  Strides sx;
  const float* w;
  const float* g;
  float* mean;
  float* rstd;
  float* sums;
  float* partials;
  long long n_partials;
  int B, N, C, Cp, kc, stages, wstream;
  cudaStream_t stream;
  long long* needed;  // non-null: report the partials' floats, launch nothing
};

// Blocks per head group of pass 1: the card's resident blocks over the
// groups, at most one per tile.
template <typename K>
int pass1_grid(K kernel, int smem, int B, int N, int groups, int* per_group) {
  int blocks = 0;
  const int err = resident_blocks(kernel, smem, &blocks);
  if (err) return err;
  const long long tiles = (long long)B * ((N + T - 1) / T);
  *per_group = (int)std::max(1LL, std::min(tiles, (long long)(blocks / groups)));
  return 0;
}

template <bool PRENORM, bool STATS, bool ALIGNED, int HG>
int pass1(const Pass1Call& a) {
  auto kernel = linear_attention_pass1_kernel_tc<PRENORM, STATS, ALIGNED, HG>;
  const int smem = smem_bytes(1, a.Cp, HG, a.kc, a.stages, a.wstream);
  const int groups = 4 / HG;
  int per_group = 0;
  const int err = pass1_grid(kernel, smem, a.B, a.N, groups, &per_group);
  if (err) return err;
  // a slot per warp, per (head group, block + batch row)
  const long long needed = (long long)groups * (per_group + a.B - 1) * 8 * HSLOT;
  if (a.needed) {
    *a.needed = needed;
    return 0;
  }
  if (a.n_partials < needed) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(per_group, groups), NTHREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.x), a.sx, a.w, a.g, a.mean, a.rstd, a.partials, a.B, a.N, a.C,
      a.Cp, a.kc, (a.Cp + a.kc - 1) / a.kc, a.stages, a.wstream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  linear_attention_reduce_kernel_tc<<<(unsigned)(((long long)a.B * SUMS + NTHREADS - 1) / NTHREADS),
                                      NTHREADS, 0, a.stream>>>(a.partials, a.sums, a.B,
                                                               (a.N + T - 1) / T, per_group, HG);
  return (int)cudaGetLastError();
}

template <bool PRENORM, bool STATS>
int pass1_pick(int aligned, int hg, const Pass1Call& a) {
  if (aligned) return hg == 4 ? pass1<PRENORM, STATS, true, 4>(a) : pass1<PRENORM, STATS, true, 2>(a);
  return hg == 4 ? pass1<PRENORM, STATS, false, 4>(a) : pass1<PRENORM, STATS, false, 2>(a);
}

int pass1_variant(int prenorm, int compute_stats, int aligned, int hg, const Pass1Call& a) {
  if (!prenorm) return pass1_pick<false, false>(aligned, hg, a);
  if (compute_stats) return pass1_pick<true, true>(aligned, hg, a);
  return pass1_pick<true, false>(aligned, hg, a);
}

template <bool PRENORM, bool ALIGNED>
int pass2(const void* x, Strides sx, const float* w, const float* g, const float* mean,
          const float* rstd, const float* sums, void* out, Strides so, int aligned_out, int B,
          int N, int C, int Cp, int kc, int stages, int wstream, cudaStream_t stream) {
  auto kernel = linear_attention_pass2_kernel_tc<PRENORM, ALIGNED>;
  const int smem = smem_bytes(2, Cp, 4, kc, stages, wstream);
  int blocks = 0;
  const int err = resident_blocks(kernel, smem, &blocks);
  if (err) return err;
  const long long tiles = (long long)B * ((N + T - 1) / T);
  kernel<<<(int)std::max(1LL, std::min(tiles, (long long)blocks)), NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), sx, w, g, mean, rstd, sums, static_cast<bf16*>(out), so,
      aligned_out, B, N, C, Cp, kc, (Cp + kc - 1) / kc, stages, wstream);
  return (int)cudaGetLastError();
}

// Blocks per SM the card gives a bf16 pass under a plan.
template <typename K>
int blocks_per_sm(K kernel, int smem) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem) !=
          cudaSuccess)
    return -1;
  return per_sm;
}

}  // namespace tc

}  // namespace

extern "C" {

// Pass 1: writes (E blocks, s) of every batch into sums (B, 4096 + 128):
// the blocks write their partials into `partials` (n_partials floats, at
// least dmh_linear_attention_pass1_partials' count), a second launch sums
// them in a fixed order.  g == NULL: no prenorm.  Otherwise mean and rstd
// (B, N) fp32 are computed and written (compute_stats = 1) or read.
int dmh_linear_attention_pass1(const void* x, long long sxb, long long sxn, long long sxc,
                               const float* w_qkv, const float* g, float* mean, float* rstd,
                               int compute_stats, float* sums, float* partials,
                               long long n_partials, int B, int N, int C, void* stream) {
  if (n_partials < fp32_partials(B, N)) return (int)cudaErrorInvalidValue;
  const Strides sx{sxb, sxn, sxc};
  return pass1_dispatch<float>(x, sx, w_qkv, g, mean, rstd, compute_stats, sums, partials, B, N,
                               C, static_cast<cudaStream_t>(stream));
}

// Pass 2: out (B, N, 128) through its element strides.  With g, mean and
// rstd (B, N) are read.
int dmh_linear_attention_pass2(const void* x, long long sxb, long long sxn, long long sxc,
                               const float* w_qkv, const float* g, float* mean, float* rstd,
                               const float* sums, void* out, long long sob, long long son,
                               long long soc, int B, int N, int C, void* stream) {
  const Strides sx{sxb, sxn, sxc}, so{sob, son, soc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g) return pass2<float, true>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, s);
  return pass2<float, false>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, s);
}

// Dynamic shared memory of one block of the fp32 pass 1 or pass 2.
int dmh_linear_attention_smem_bytes(int pass) {
  return (pass == 1 ? P1_FLOATS : P2_FLOATS) * (int)sizeof(float);
}

// bf16 pass 1 on tensor cores: x (B, N, C) bf16 through its strides, w_qkv
// and g as the fp32 pass takes them (g == NULL: no prenorm).  The plan: hg
// heads per block (4 or 2), kc channels per ring slot (Cp, C padded to a
// multiple of 16, with 4 heads), 2 or 3 slots, stream = weights made chunk
// by chunk (else resident), aligned = the cp.async loader.  Writes (E
// blocks, s) into sums through partials as the fp32 pass 1 does.
int dmh_linear_attention_pass1_bf16(const void* x, long long sxb, long long sxn, long long sxc,
                                    const float* w_qkv, const float* g, float* mean, float* rstd,
                                    int compute_stats, float* sums, float* partials,
                                    long long n_partials, int B, int N, int C, int Cp, int hg,
                                    int kc, int stages, int stream, int aligned, void* stream_) {
  if (!tc::plan_ok(1, C, Cp, hg, kc, stages, stream)) return (int)cudaErrorInvalidValue;
  const tc::Pass1Call a{x, Strides{sxb, sxn, sxc}, w_qkv, g, mean, rstd, sums, partials,
                        n_partials, B, N, C, Cp, kc, stages, stream,
                        static_cast<cudaStream_t>(stream_), nullptr};
  return tc::pass1_variant(g != nullptr, compute_stats, aligned, hg, a);
}

// Floats of the partials pass 1 needs for one call into *out: the fp32 pass
// (bf16 = 0; the plan's arguments unused) or the bf16 pass of that plan and
// variant (its grid follows the card's resident blocks).
int dmh_linear_attention_pass1_partials(int bf16, int prenorm, int compute_stats, int B, int N,
                                        int C, int Cp, int hg, int kc, int stages, int stream,
                                        int aligned, long long* out) {
  if (!bf16) {
    *out = fp32_partials(B, N);
    return 0;
  }
  if (!tc::plan_ok(1, C, Cp, hg, kc, stages, stream)) return (int)cudaErrorInvalidValue;
  const tc::Pass1Call a{nullptr, Strides{0, 0, 0}, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, 0, B, N, C, Cp, kc, stages, stream, nullptr, out};
  return tc::pass1_variant(prenorm, compute_stats, aligned, hg, a);
}

// bf16 pass 2 on tensor cores: out (B, N, 128) bf16 through its strides,
// aligned_out = 16-byte stores (token stride 1).
int dmh_linear_attention_pass2_bf16(const void* x, long long sxb, long long sxn, long long sxc,
                                    const float* w_qkv, const float* g, const float* mean,
                                    const float* rstd, const float* sums, void* out,
                                    long long sob, long long son, long long soc, int B, int N,
                                    int C, int Cp, int kc, int stages, int stream, int aligned,
                                    int aligned_out, void* stream_) {
  if (!tc::plan_ok(2, C, Cp, 4, kc, stages, stream)) return (int)cudaErrorInvalidValue;
  const Strides sx{sxb, sxn, sxc}, so{sob, son, soc};
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  if (g == nullptr) {
    if (aligned)
      return tc::pass2<false, true>(x, sx, w_qkv, g, mean, rstd, sums, out, so, aligned_out, B,
                                    N, C, Cp, kc, stages, stream, s);
    return tc::pass2<false, false>(x, sx, w_qkv, g, mean, rstd, sums, out, so, aligned_out, B, N,
                                   C, Cp, kc, stages, stream, s);
  }
  if (aligned)
    return tc::pass2<true, true>(x, sx, w_qkv, g, mean, rstd, sums, out, so, aligned_out, B, N, C,
                                 Cp, kc, stages, stream, s);
  return tc::pass2<true, false>(x, sx, w_qkv, g, mean, rstd, sums, out, so, aligned_out, B, N, C,
                                Cp, kc, stages, stream, s);
}

// Dynamic shared memory of one block of a bf16 pass under a plan.
int dmh_linear_attention_bf16_smem_bytes(int pass, int Cp, int hg, int kc, int stages,
                                         int stream) {
  return tc::smem_bytes(pass, Cp, hg, kc, stages, stream);
}

// Blocks per SM of the UNet's bf16 variant of a pass (prenorm, statistics
// computed, aligned loader) under a plan; -1 on error.
int dmh_linear_attention_bf16_blocks_per_sm(int pass, int Cp, int hg, int kc, int stages,
                                            int stream) {
  const int smem = tc::smem_bytes(pass, Cp, hg, kc, stages, stream);
  if (pass == 2) return tc::blocks_per_sm(tc::linear_attention_pass2_kernel_tc<true, true>, smem);
  if (hg == 4)
    return tc::blocks_per_sm(tc::linear_attention_pass1_kernel_tc<true, true, true, 4>, smem);
  return tc::blocks_per_sm(tc::linear_attention_pass1_kernel_tc<true, true, true, 2>, smem);
}

}  // extern "C"
