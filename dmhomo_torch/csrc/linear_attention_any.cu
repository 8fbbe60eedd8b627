// Linear attention at any heads and dim_head (the generic variant) for
// Hopper, sm_90a: pass 1 (the k side), its fixed-order reduction, and pass 2
// (the q side).
//
// Replaces: dmhomo_tpu/ops/linear_attention.py::_pass1_kernel and
// ::_pass2_kernel (the Pallas TPU kernels of pallas_linear_attention, which
// take any heads and dim_head) wherever the tuned library
// (linear_attention.cu, heads = 4 and dim_head = 32 at compile time) does
// not.  They compute what the JAX production function
// blockdiag_linear_attention computes, max-free (a static +-60 clip before
// exp), with heads H and dim_head D runtime arguments; for x (B, N, C) in
// the I/O dtype dt (fp32 or bf16), w_qkv (C, 3*H*D) fp32 and round() the
// rounding to dt:
//
//   projection (fp32 accumulation), q | k | v = columns 0 | HD | 2 HD:
//     no prenorm:  qkv = round(x . round(W))
//     prenorm g:   qkv = round((x . round(diag(g) W) - mean * (g W)) * rstd)
//                  with mean, rstd of each token over C in fp32 (two-pass,
//                  eps 1e-5), computed here or given
//   pass 1:  ek = round(exp(clip(k, +-60)));  s_h = sum_n ek_h (fp32);
//            E_h = ek_h^T v_h (fp32), the D x D diagonal block of head h
//   pass 2:  context_h = round(E_h * D^-0.5 / (s_h * N))  (row d by s_h[d])
//            eq = round(exp(clip(q, +-60)))
//            out_h = round(round(eq_h . context_h) / round(sum_d eq_h))
//
// Pass 1: a grid of (token chunk, head, batch).  Each block walks its
// chunk's tiles of T tokens: it stages KC channels of x and of the head's
// k and v weight columns at a time in shared memory and projects the tile
// on CUDA cores (each thread a 4-token x 4-column register tile), keeps
// the tile's ek and v in shared memory, and adds the tile's ek^T v into the
// block's fp32 E_h in shared memory (each thread owns its 4x4 groups of E)
// and its column sums into s_h (a thread per d).  It writes E_h and s_h to
// its chunk's slot of a scratch buffer; a second launch sums the slots in
// chunk order into the sums buffer (per batch: the H blocks of D x D,
// head-major, then s, H*D).  No atomics: reruns give the same bits.  With
// the statistics computed, the head-0 blocks alone write mean and rstd.
//
// Pass 2: a grid of (token tile, head, batch).  Each block rebuilds
// context_h in shared memory from the sums (D <= 128 keeps it within 64 KB
// fp32), projects q_h for its tile as pass 1 projects k and v, and writes
// out's columns h*D .. h*D + D - 1 through out's strides, staged in shared
// memory so that the stores are coalesced in either layout.
//
// fp32 products on CUDA cores in both dtypes (fp32 accumulation, the bf16
// roundings at the points above; TF32 is never used).  x and out are
// addressed through element strides, so the UNet's NCHW activations (token
// stride 1) are read and written in place.
//
// Everything but the C entry points has internal linkage (an unnamed
// namespace), so the two linear-attention libraries share no symbol.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 16;              // channels staged per step
constexpr int MAX_HEADS = 16;
constexpr int MAX_DH = 128;
constexpr int MAX_HIDDEN = 1024;    // heads * dim_head
constexpr int MAX_C = 1024;
constexpr int MAX_B = 65535;        // grid z
constexpr int TARGET_BLOCKS = 132 * 4;  // pass 1: about four blocks per SM in all
constexpr float CLIP = 60.0f;

struct Strides {
  long long b, n, c;
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float clipped_exp(float v) {
  return expf(fminf(fmaxf(v, -CLIP), CLIP));
}

// The launch geometry of one pass, from the shapes alone (the Python side's
// generic_launch_plan computes the same).
struct Plan {
  int dhp;          // dim_head padded to a multiple of 4
  int cols;         // projected columns per block, padded: 2 dhp (pass 1) or dhp
  int groups_c;     // 4-column groups
  int groups_t;     // 4-token groups
  int tile;         // T = 4 groups_t tokens
  int n_tiles;
  int chunks;       // pass 1: token chunks per (batch, head); pass 2: n_tiles
  int tiles_per_chunk;
  int smem;         // dynamic shared memory bytes
  long long scratch;  // pass 1: floats of the per-chunk partials
};

inline Plan make_plan(int pass, int B, int N, int C, int heads, int dh) {
  (void)C;
  Plan p{};
  p.dhp = (dh + 3) / 4 * 4;
  p.cols = pass == 1 ? 2 * p.dhp : p.dhp;
  p.groups_c = p.cols / 4;
  p.groups_t = THREADS / p.groups_c;
  if (p.groups_t > 64) p.groups_t = 64;
  p.tile = 4 * p.groups_t;
  p.n_tiles = (N + p.tile - 1) / p.tile;
  const int stats = 2 * p.tile + THREADS;  // mean, rstd, a reduction scratch
  if (pass == 1) {
    long long want = (TARGET_BLOCKS + (long long)B * heads - 1) / ((long long)B * heads);
    if (want < 1) want = 1;
    if (want > p.n_tiles) want = p.n_tiles;
    p.tiles_per_chunk = (int)((p.n_tiles + want - 1) / want);
    p.chunks = (p.n_tiles + p.tiles_per_chunk - 1) / p.tiles_per_chunk;
    p.scratch = (long long)B * heads * p.chunks * ((long long)dh * dh + dh);
    // x and weight stages, the tile's ek and v, E_h, g.W, statistics
    p.smem = 4 * (KC * p.tile + KC * p.cols + 2 * p.tile * p.dhp + p.dhp * p.dhp + p.cols +
                  stats);
  } else {
    p.tiles_per_chunk = 1;
    p.chunks = p.n_tiles;
    p.scratch = 0;
    // x and weight stages, context, eq (then the output, rows dhp + 1), g.Wq, statistics
    p.smem = 4 * (KC * p.tile + KC * p.cols + p.dhp * p.dhp + p.tile * (p.dhp + 1) + p.cols +
                  stats);
  }
  return p;
}

// u[j] = sum_c g[c] W[c][col(j)] (fp32, unrounded W) for the block's
// projected columns; col(j) < 0 marks a padding column.
__device__ void gain_times_w(const float* __restrict__ w, const float* __restrict__ g, int C,
                             int wcols, const int* colmap, int ncols, float* us) {
  for (int j = threadIdx.x; j < ncols; j += THREADS) {
    const int col = colmap[j];
    float u = 0.0f;
    if (col >= 0)
      for (int c = 0; c < C; ++c) u = fmaf(g[c], w[(long long)c * wcols + col], u);
    us[j] = u;
  }
}

// LayerNorm statistics of the tile's tokens over C, two-pass in fp32:
// P threads per token walk the channels, the token index fastest.
template <typename T>
__device__ void tile_stats(const T* __restrict__ xb, Strides sx, int t0, int tile, int N, int C,
                           float* red, float* mean_s, float* rstd_s) {
  const int P = THREADS / tile;
  const int t = threadIdx.x % tile, part = threadIdx.x / tile;
  const bool active = part < P;
  const int tok = t0 + t;
  float sum = 0.0f;
  if (active && tok < N)
    for (int c = part; c < C; c += P) sum += to_f(xb[tok * sx.n + c * sx.c]);
  if (active) red[part * tile + t] = sum;
  __syncthreads();
  if (threadIdx.x < tile) {
    float total = 0.0f;
    for (int q = 0; q < P; ++q) total += red[q * tile + threadIdx.x];
    mean_s[threadIdx.x] = total / (float)C;
  }
  __syncthreads();
  float sq = 0.0f;
  if (active && tok < N) {
    const float m = mean_s[t];
    for (int c = part; c < C; c += P) {
      const float d = to_f(xb[tok * sx.n + c * sx.c]) - m;
      sq = fmaf(d, d, sq);
    }
  }
  if (active) red[part * tile + t] = sq;
  __syncthreads();
  if (threadIdx.x < tile) {
    float total = 0.0f;
    for (int q = 0; q < P; ++q) total += red[q * tile + threadIdx.x];
    rstd_s[threadIdx.x] = 1.0f / sqrtf(total / (float)C + 1e-5f);
  }
  __syncthreads();
}

// The tile's statistics: computed (the head-0 block writes them out) or
// read; zeros past N.
template <typename T, bool PRENORM, bool COMPUTE_STATS>
__device__ void tile_prenorm(const T* xb, Strides sx, int b, int t0, int tile, int N, int C,
                             bool writer, float* mean, float* rstd, float* red, float* mean_s,
                             float* rstd_s) {
  if (!PRENORM) return;
  const int t = threadIdx.x, tok = t0 + t;
  if (COMPUTE_STATS) {
    tile_stats<T>(xb, sx, t0, tile, N, C, red, mean_s, rstd_s);
    if (writer && t < tile && tok < N) {
      mean[(long long)b * N + tok] = mean_s[t];
      rstd[(long long)b * N + tok] = rstd_s[t];
    }
  } else {
    if (t < tile) {
      mean_s[t] = tok < N ? mean[(long long)b * N + tok] : 0.0f;
      rstd_s[t] = tok < N ? rstd[(long long)b * N + tok] : 0.0f;
    }
    __syncthreads();
  }
}

// Projection of one tile of T tokens onto the block's `cols` columns
// (colmap: the column of w_qkv of each, -1 for padding): thread (tg =
// tid / groups_c, cg = tid % groups_c) accumulates tokens 4tg..4tg+3 x
// columns 4cg..4cg+3 in fp32.  Threads past groups_t * groups_c only load.
template <typename T, bool PRENORM>
__device__ void project_tile(const T* __restrict__ xb, Strides sx, int t0, int N, int C,
                             const float* __restrict__ w, const float* __restrict__ g, int wcols,
                             const int* colmap, const Plan& p, float* xs, float* ws,
                             float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tg = tid / p.groups_c, cg = tid % p.groups_c;
  const bool computes = tg < p.groups_t;
  const int tile = p.tile, cols = p.cols;
  const bool token_fastest = sx.n <= sx.c;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  for (int c0 = 0; c0 < C; c0 += KC) {
    for (int e = tid; e < KC * tile; e += THREADS) {
      const int cc = token_fastest ? e / tile : e % KC;
      const int t = token_fastest ? e % tile : e / KC;
      const int ch = c0 + cc, tok = t0 + t;
      xs[cc * tile + t] = (ch < C && tok < N) ? to_f(xb[tok * sx.n + ch * sx.c]) : 0.0f;
    }
    for (int e = tid; e < KC * cols; e += THREADS) {
      const int ch = c0 + e / cols, j = e % cols;
      const int col = colmap[j];
      float v = 0.0f;
      if (ch < C && col >= 0) {
        v = w[(long long)ch * wcols + col];
        if (PRENORM) v *= g[ch];
        v = round_to<T>(v);
      }
      ws[e] = v;
    }
    __syncthreads();
    if (computes) {
      const int kmax = min(KC, C - c0);
      for (int c = 0; c < kmax; ++c) {
        const float4 xa = *reinterpret_cast<const float4*>(xs + c * tile + 4 * tg);
        const float4 wv = *reinterpret_cast<const float4*>(ws + c * cols + 4 * cg);
        const float a[4] = {xa.x, xa.y, xa.z, xa.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(a[r], wv.x, acc[r][0]);
          acc[r][1] = fmaf(a[r], wv.y, acc[r][1]);
          acc[r][2] = fmaf(a[r], wv.z, acc[r][2]);
          acc[r][3] = fmaf(a[r], wv.w, acc[r][3]);
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
  return round_to<T>(a);
}

template <typename T, bool PRENORM, bool COMPUTE_STATS>
__global__ void __launch_bounds__(THREADS)
linear_attention_any_pass1_kernel(const T* __restrict__ x, Strides sx,
                                  const float* __restrict__ w, const float* __restrict__ g,
                                  float* mean, float* rstd, float* __restrict__ partials, int N,
                                  int C, int heads, int dh, Plan p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + KC * p.tile;
  float* eks = ws + KC * p.cols;
  float* vs = eks + p.tile * p.dhp;
  float* es = vs + p.tile * p.dhp;
  float* us = es + p.dhp * p.dhp;
  float* mean_s = us + p.cols;
  float* rstd_s = mean_s + p.tile;
  float* red = rstd_s + p.tile;
  __shared__ int colmap[2 * MAX_DH];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * dh, wcols = 3 * hd;
  const int dhp = p.dhp;
  for (int j = tid; j < p.cols; j += THREADS) {
    const int jj = j % dhp;  // k columns, then v columns, each padded to dhp
    colmap[j] = jj < dh ? (j < dhp ? hd : 2 * hd) + h * dh + jj : -1;
  }
  for (int e = tid; e < dhp * dhp; e += THREADS) es[e] = 0.0f;
  __syncthreads();
  if (PRENORM) gain_times_w(w, g, C, wcols, colmap, p.cols, us);

  const T* xb = x + b * sx.b;
  const int tg = tid / p.groups_c, cg = tid % p.groups_c;
  const int dgroups = dhp / 4;
  float s_acc = 0.0f;
  const int tile0 = chunk * p.tiles_per_chunk;
  const int tile1 = min(p.n_tiles, tile0 + p.tiles_per_chunk);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int t0 = tile * p.tile;
    tile_prenorm<T, PRENORM, COMPUTE_STATS>(xb, sx, b, t0, p.tile, N, C, h == 0, mean, rstd, red,
                                            mean_s, rstd_s);
    float acc[4][4];
    project_tile<T, PRENORM>(xb, sx, t0, N, C, w, g, wcols, colmap, p, xs, ws, acc);
    if (tg < p.groups_t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * tg + r;
        const bool valid = t0 + t < N;
        const float m = PRENORM ? mean_s[t] : 0.0f, rs = PRENORM ? rstd_s[t] : 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * cg + q;
          const float val = finish<T, PRENORM>(acc[r][q], PRENORM ? us[j] : 0.0f, m, rs);
          const bool live = valid && colmap[j] >= 0;
          if (j < dhp)
            eks[t * dhp + j] = live ? round_to<T>(clipped_exp(val)) : 0.0f;
          else
            vs[t * dhp + j - dhp] = live ? val : 0.0f;
        }
      }
    }
    __syncthreads();
    // E_h += ek^T v over the tile: each thread its own 4x4 groups of E
    for (int m = tid; m < dgroups * dgroups; m += THREADS) {
      const int d0 = 4 * (m / dgroups), e0 = 4 * (m % dgroups);
      float part[4][4] = {};
      for (int t = 0; t < p.tile; ++t) {
        const float4 kk = *reinterpret_cast<const float4*>(eks + t * dhp + d0);
        const float4 vv = *reinterpret_cast<const float4*>(vs + t * dhp + e0);
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[a][c] = fmaf(ka[a], va[c], part[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) es[(d0 + a) * dhp + e0 + c] += part[a][c];
    }
    if (tid < dh)
      for (int t = 0; t < p.tile; ++t) s_acc += eks[t * dhp + tid];
    __syncthreads();
  }
  // this chunk's (E_h, s_h) into its slot
  const long long per = (long long)dh * dh + dh;
  float* slot = partials + (((long long)b * heads + h) * p.chunks + chunk) * per;
  for (int e = tid; e < dh * dh; e += THREADS) slot[e] = es[(e / dh) * dhp + e % dh];
  if (tid < dh) slot[dh * dh + tid] = s_acc;
}

// sums[b] = (E_0 .. E_{H-1}, s) from the chunks' slots, added in chunk order.
__global__ void __launch_bounds__(THREADS)
linear_attention_any_reduce_kernel(const float* __restrict__ partials, float* __restrict__ sums,
                                   int B, int heads, int dh, int chunks) {
  const long long per = (long long)dh * dh + dh;
  const long long total = (long long)B * heads * per;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long bh = idx / per, j = idx % per;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  const float* src = partials + bh * chunks * per + j;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += src[c * per];
  const long long width = (long long)heads * dh * (dh + 1);
  const long long dst = j < (long long)dh * dh ? (long long)h * dh * dh + j
                                               : (long long)heads * dh * dh + h * dh + (j - dh * dh);
  sums[(long long)b * width + dst] = acc;
}

template <typename T, bool PRENORM>
__global__ void __launch_bounds__(THREADS)
linear_attention_any_pass2_kernel(const T* __restrict__ x, Strides sx,
                                  const float* __restrict__ w, const float* __restrict__ g,
                                  const float* mean, const float* rstd,
                                  const float* __restrict__ sums, T* __restrict__ out, Strides so,
                                  int N, int C, int heads, int dh, float scale, Plan p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + KC * p.tile;
  float* ctx = ws + KC * p.cols;
  float* eqs = ctx + p.dhp * p.dhp;
  float* us = eqs + p.tile * (p.dhp + 1);
  float* mean_s = us + p.cols;
  float* rstd_s = mean_s + p.tile;
  __shared__ int colmap[MAX_DH];

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * p.tile;
  const int hd = heads * dh, wcols = 3 * hd;
  const int dhp = p.dhp, ld = dhp + 1;
  for (int j = tid; j < p.cols; j += THREADS) colmap[j] = j < dh ? h * dh + j : -1;
  // context_h = round(E_h * scale / (s_h * N)), zero in the padding
  const float* sb = sums + (long long)b * heads * dh * (dh + 1);
  const float* eb = sb + (long long)h * dh * dh;
  const float* s_h = sb + (long long)heads * dh * dh + h * dh;
  for (int e = tid; e < dhp * dhp; e += THREADS) {
    const int d = e / dhp, c = e % dhp;
    ctx[e] = (d < dh && c < dh) ? round_to<T>((eb[d * dh + c] * scale) / (s_h[d] * (float)N))
                                : 0.0f;
  }
  __syncthreads();
  if (PRENORM) gain_times_w(w, g, C, wcols, colmap, p.cols, us);
  const T* xb = x + b * sx.b;
  if (PRENORM && tid < p.tile) {
    const int tok = t0 + tid;
    mean_s[tid] = tok < N ? mean[(long long)b * N + tok] : 0.0f;
    rstd_s[tid] = tok < N ? rstd[(long long)b * N + tok] : 0.0f;
  }
  float acc[4][4];
  project_tile<T, PRENORM>(xb, sx, t0, N, C, w, g, wcols, colmap, p, xs, ws, acc);
  const int tg = tid / p.groups_c, cg = tid % p.groups_c;
  const bool computes = tg < p.groups_t;
  if (computes) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * tg + r;
      const float m = PRENORM ? mean_s[t] : 0.0f, rs = PRENORM ? rstd_s[t] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * cg + q;
        const float qv = finish<T, PRENORM>(acc[r][q], PRENORM ? us[j] : 0.0f, m, rs);
        eqs[t * ld + j] = j < dh ? round_to<T>(clipped_exp(qv)) : 0.0f;
      }
    }
  }
  __syncthreads();
  // num = eq_h . context_h, den = sum_d eq_h: tokens 4tg.., columns 4cg..
  float num[4][4] = {}, den[4] = {};
  if (computes) {
    for (int d = 0; d < dh; ++d) {
      const float4 cc = *reinterpret_cast<const float4*>(ctx + d * dhp + 4 * cg);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = eqs[(4 * tg + r) * ld + d];
        num[r][0] = fmaf(a, cc.x, num[r][0]);
        num[r][1] = fmaf(a, cc.y, num[r][1]);
        num[r][2] = fmaf(a, cc.z, num[r][2]);
        num[r][3] = fmaf(a, cc.w, num[r][3]);
        den[r] += a;
      }
    }
  }
  __syncthreads();
  float* os = eqs;  // the tile's output, rows of ld
  if (computes) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float dn = round_to<T>(den[r]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        os[(4 * tg + r) * ld + 4 * cg + q] = round_to<T>(round_to<T>(num[r][q]) / dn);
    }
  }
  __syncthreads();
  T* ob = out + b * so.b + (long long)h * dh * so.c;
  const bool token_fastest = so.n <= so.c;
  for (int e = tid; e < p.tile * dh; e += THREADS) {
    const int t = token_fastest ? e % p.tile : e / dh;
    const int col = token_fastest ? e / p.tile : e % dh;
    if (t0 + t < N) ob[(t0 + t) * so.n + col * so.c] = from_f<T>(os[t * ld + col]);
  }
}

bool valid(int B, int N, int C, int heads, int dh) {
  return B >= 1 && B <= MAX_B && N >= 1 && C >= 1 && C <= MAX_C && heads >= 1 &&
         heads <= MAX_HEADS && dh >= 1 && dh <= MAX_DH && heads * dh <= MAX_HIDDEN;
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, bool PRENORM, bool COMPUTE_STATS>
int pass1(const void* x, Strides sx, const float* w, const float* g, float* mean, float* rstd,
          float* sums, float* partials, int B, int N, int C, int heads, int dh, cudaStream_t s) {
  const Plan p = make_plan(1, B, N, C, heads, dh);
  auto kernel = linear_attention_any_pass1_kernel<T, PRENORM, COMPUTE_STATS>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.chunks, heads, B), THREADS, p.smem, s>>>(
      static_cast<const T*>(x), sx, w, g, mean, rstd, partials, N, C, heads, dh, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * heads * ((long long)dh * dh + dh);
  linear_attention_any_reduce_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                                       s>>>(partials, sums, B, heads, dh, p.chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int pass1_dispatch(const void* x, Strides sx, const float* w, const float* g, float* mean,
                   float* rstd, int compute_stats, float* sums, float* partials, int B, int N,
                   int C, int heads, int dh, cudaStream_t s) {
  if (g == nullptr)
    return pass1<T, false, false>(x, sx, w, g, mean, rstd, sums, partials, B, N, C, heads, dh, s);
  if (compute_stats)
    return pass1<T, true, true>(x, sx, w, g, mean, rstd, sums, partials, B, N, C, heads, dh, s);
  return pass1<T, true, false>(x, sx, w, g, mean, rstd, sums, partials, B, N, C, heads, dh, s);
}

template <typename T, bool PRENORM>
int pass2(const void* x, Strides sx, const float* w, const float* g, const float* mean,
          const float* rstd, const float* sums, void* out, Strides so, int B, int N, int C,
          int heads, int dh, float scale, cudaStream_t s) {
  const Plan p = make_plan(2, B, N, C, heads, dh);
  auto kernel = linear_attention_any_pass2_kernel<T, PRENORM>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.chunks, heads, B), THREADS, p.smem, s>>>(
      static_cast<const T*>(x), sx, w, g, mean, rstd, sums, static_cast<T*>(out), so, N, C,
      heads, dh, scale, p);
  return (int)cudaGetLastError();
}

template <typename T>
int pass2_dispatch(const void* x, Strides sx, const float* w, const float* g, const float* mean,
                   const float* rstd, const float* sums, void* out, Strides so, int B, int N,
                   int C, int heads, int dh, float scale, cudaStream_t s) {
  if (g == nullptr)
    return pass2<T, false>(x, sx, w, g, mean, rstd, sums, out, so, B, N, C, heads, dh, scale, s);
  return pass2<T, true>(x, sx, w, g, mean, rstd, sums, out, so, B, N, C, heads, dh, scale, s);
}

}  // namespace

extern "C" {

// Pass 1 and its reduction: x (B, N, C) fp32 or bf16 (is_bf16) through its
// element strides, w_qkv (C, 3*heads*dh) fp32, g (C,) fp32 or NULL (no
// prenorm); with g, mean and rstd (B, N) fp32 are computed and written
// (compute_stats) or read.  partials: scratch of at least the plan's
// `scratch` floats (n_partials), every slot written before it is read;
// sums (B, heads*dh*(dh+1)) fp32 is written, not added to.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int dmh_linear_attention_any_pass1(const void* x, long long sxb, long long sxn, long long sxc,
                                   const float* w_qkv, const float* g, float* mean, float* rstd,
                                   int compute_stats, float* sums, float* partials,
                                   long long n_partials, int B, int N, int C, int heads, int dh,
                                   int is_bf16, void* stream) {
  if (!valid(B, N, C, heads, dh)) return (int)cudaErrorInvalidValue;
  if (n_partials < make_plan(1, B, N, C, heads, dh).scratch) return (int)cudaErrorInvalidValue;
  const Strides sx{sxb, sxn, sxc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return pass1_dispatch<__nv_bfloat16>(x, sx, w_qkv, g, mean, rstd, compute_stats, sums,
                                         partials, B, N, C, heads, dh, s);
  return pass1_dispatch<float>(x, sx, w_qkv, g, mean, rstd, compute_stats, sums, partials, B, N,
                               C, heads, dh, s);
}

// Pass 2: out (B, N, heads*dh) in the dtype of x through its strides, from
// x, pass 1's sums and (with g) mean and rstd; scale = dh^-0.5 in fp32.
int dmh_linear_attention_any_pass2(const void* x, long long sxb, long long sxn, long long sxc,
                                   const float* w_qkv, const float* g, const float* mean,
                                   const float* rstd, const float* sums, void* out,
                                   long long sob, long long son, long long soc, int B, int N,
                                   int C, int heads, int dh, float scale, int is_bf16,
                                   void* stream) {
  if (!valid(B, N, C, heads, dh)) return (int)cudaErrorInvalidValue;
  const Strides sx{sxb, sxn, sxc}, so{sob, son, soc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return pass2_dispatch<__nv_bfloat16>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C,
                                         heads, dh, scale, s);
  return pass2_dispatch<float>(x, sx, w_qkv, g, mean, rstd, sums, out, so, B, N, C, heads, dh,
                               scale, s);
}

// The plan of pass 1 or 2 at these shapes, into out[9]: grid x (token
// chunks or tiles), grid y (heads), grid z (batch), threads, dynamic shared
// memory bytes, tokens per tile, tiles per chunk, the partials' floats (low
// 31 bits; pass 1), the padded dim_head.  Returns 0, or the error a launch
// would return.
int dmh_linear_attention_any_plan(int pass, int B, int N, int C, int heads, int dh, int* out) {
  if (!valid(B, N, C, heads, dh) || (pass != 1 && pass != 2)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(pass, B, N, C, heads, dh);
  const int vals[9] = {p.chunks, heads, B, THREADS, p.smem, p.tile, p.tiles_per_chunk,
                       (int)(p.scratch & 0x7fffffff), p.dhp};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
