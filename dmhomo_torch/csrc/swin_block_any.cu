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
//   1. LN1 fused into the qkv product: each block computes the LayerNorm
//      statistics of its 64 token rows, normalizes while it stages them, and
//      gathers each token at its shifted window coordinates (no roll copy);
//   2. the window attention (window_attention_any.cuh) over the window-order
//      qkv;
//   3. the projection with its bias and the residual x (gathered);
//   4. LN2 fused into fc1, with the exact-erf GELU;
//   5. fc2 with its bias and the residual h, each token scattered back to its
//      place in the image (the roll undone by the same map).
// The backward recomputes 1-4 (keeping n1, n2 and the fp32 m1), then runs the
// chain back: dm1 = (dy round(W2)) gelu'(m1); dn2 = round(dm1) round(W1); the
// LayerNorm-2 rows (dh = dy + LN2'(dn2)); dao = round(round(dh) round(Wp)); the
// attention's backward; dn1 = dqkv round(Wq); the LayerNorm-1 rows (dx =
// round(dh + LN1'(dn1)), scattered); the four weight products over the
// tokens, each with a ones column for its bias vector; and one reduction:
// thirteen launches.
//
// Every product is this file's own tiled kernel: 64 x 64 output tiles, 16-deep
// slices of both operands staged in shared memory as fp32 (the weights
// rounded to the I/O dtype as they are staged), 4 x 4 outputs a thread, fp32
// FMAs on CUDA cores (no tensor cores, no TF32, no library).  What bounds it on
// an H100: at the HEM's widths (K = C or 3C, 24 to 288) a token row is read
// and written once per product for some 2 K flops an output, a few flops per
// byte, so HBM's 3.35 TB/s; where K reaches 1536 the CUDA cores' 67 TFLOP/s.
//
// No atomics.  The weight gradients and bias vectors are summed over fixed
// ranges of tokens into per-split partials, the LayerNorm gains' and biases'
// over fixed ranges of rows into per-block partials, dbias per chunk of
// windows into slabs; one reduction launch adds every family in a fixed
// order.  The same bits every run.

#include "window_attention_any.cuh"

namespace {

using wa_any::from_f;
using wa_any::round_to;
using wa_any::to_f;
using wa_any::warp_sum;

constexpr int GT = 256;  // threads of every block but the attention's
constexpr int BM = 64, BN = 64, BK = 16;  // the products' output tile and depth
constexpr int MAX_WS = 12;
constexpr int MAX_C = 384;
constexpr int VPL = MAX_C / 32;  // a LayerNorm row's values per lane
constexpr int WEIGHT_BLOCKS_PER_SM = 4;  // the weight products' splits aim at
constexpr int LN_MAX_BLOCKS = wa_any::SMS * 8;
constexpr float LN_EPS = 1e-5f;

// The window map: token t of the window-order sequence (window w = t / N, image-
// major, token n = t % N row-major in the window) and the image token it
// reads, at its coordinates shifted by +shift mod (H, W).
struct Geo {
  int B, H, W, ws, shift;
};

__device__ __forceinline__ long long image_row(long long t, const Geo& g) {
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

enum Epilogue { EPI_ROUND, EPI_RESID, EPI_GELU, EPI_DGELU, EPI_F32 };

// out[M, Nout] = epilogue(A[M, K] . B[K, Nout]) with B(k, n) = round(w[n][k])
// (an nn.Linear weight, w_trans) or round(w[k][n]).
template <typename T>
struct GemmArgs {
  const void* a;
  int a_f32;  // A is fp32 (else T)
  int a_round;  // round fp32 A to T as it is staged
  int a_gather;  // A row t is image row image_row(t)
  const float* ln_g;  // LayerNorm of each A row first (with ln_b), if set
  const float* ln_b;
  T* a_store;  // the staged A rows, written in window order, if set
  const float* w;
  int w_trans;
  const float* bias;  // added to the product, if set
  int epi;
  const T* res;  // EPI_RESID: out = round(res + round(acc + bias))
  int res_gather;
  const float* aux;  // EPI_DGELU: out = acc * gelu'(aux)
  void* out;  // T for EPI_ROUND, EPI_RESID, EPI_GELU; fp32 otherwise
  int out_scatter;  // out row t is image row image_row(t)
  float* out2;  // EPI_GELU: acc + bias (fp32), if set
  long long M;
  int K, Nout;
  Geo geo;
};

template <typename T>
__device__ __forceinline__ float load_a(const GemmArgs<T>& p, long long row, int k) {
  const long long i = row * p.K + k;
  return p.a_f32 ? __ldg(static_cast<const float*>(p.a) + i) : to_f(static_cast<const T*>(p.a)[i]);
}

__device__ __forceinline__ float gelu_cdf(float m) {
  return 0.5f * (1.0f + erff(m * 0.70710678118654752f));
}

template <typename T>
__global__ void __launch_bounds__(GT) swin_block_any_gemm_kernel(const GemmArgs<T> p) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float mean_s[BM], rstd_s[BM];
  __shared__ long long src_s[BM];
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  if (tid < BM) {
    const long long t = m0 + tid;
    src_s[tid] = t < p.M ? (p.a_gather ? image_row(t, p.geo) : t) : -1;
  }
  __syncthreads();
  if (p.ln_g) {  // a warp per row: two-pass fp32 statistics
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += GT / 32) {
      const long long src = src_s[r];
      float mean = 0.0f, rstd = 0.0f;
      if (src >= 0) {
        float s = 0.0f;
        for (int k = lane; k < p.K; k += 32) s += load_a(p, src, k);
        mean = warp_sum(s) / p.K;
        float v = 0.0f;
        for (int k = lane; k < p.K; k += 32) {
          const float d = load_a(p, src, k) - mean;
          v = fmaf(d, d, v);
        }
        rstd = 1.0f / sqrtf(warp_sum(v) / p.K + LN_EPS);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
  }
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  const bool store = p.a_store && blockIdx.y == 0;
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += GT) {
      const int r = e / BK, kk = e - r * BK;
      const int k = k0 + kk;
      const long long src = src_s[r];
      float v = 0.0f;
      if (src >= 0 && k < p.K) {
        v = load_a(p, src, k);
        if (p.ln_g)
          v = round_to<T>(__fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v, mean_s[r]), rstd_s[r]), __ldg(p.ln_g + k)),
              __ldg(p.ln_b + k)));
        else if (p.a_round)
          v = round_to<T>(v);
        if (store) p.a_store[(m0 + r) * p.K + k] = from_f<T>(v);
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += GT) {
      int kk, c;
      if (p.w_trans) {  // neighbouring threads on neighbouring k of one row of w
        c = e / BK;
        kk = e - c * BK;
      } else {
        kk = e / BN;
        c = e - kk * BN;
      }
      const int k = k0 + kk, n = n0 + c;
      float v = 0.0f;
      if (k < p.K && n < p.Nout)
        v = round_to<T>(__ldg(p.w + (p.w_trans ? static_cast<long long>(n) * p.K + k
                                               : static_cast<long long>(k) * p.Nout + n)));
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = m0 + ty * 4 + i;
    if (t >= p.M) continue;
    const long long orow = p.out_scatter ? image_row(t, p.geo) : t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.Nout) continue;
      float v = acc[i][j];
      if (p.bias) v += __ldg(p.bias + n);
      const long long o = orow * p.Nout + n;
      switch (p.epi) {
        case EPI_ROUND:
          static_cast<T*>(p.out)[o] = from_f<T>(v);
          break;
        case EPI_RESID: {
          const long long rrow = p.res_gather ? image_row(t, p.geo) : t;
          const float r = to_f(p.res[rrow * p.Nout + n]);
          static_cast<T*>(p.out)[o] = from_f<T>(r + round_to<T>(v));
          break;
        }
        case EPI_GELU:
          if (p.out2) p.out2[t * p.Nout + n] = v;
          static_cast<T*>(p.out)[o] = from_f<T>(v * gelu_cdf(v));
          break;
        case EPI_DGELU: {  // in place over aux is safe: this thread reads, then writes
          const float m = p.aux[t * p.Nout + n];
          const float dg = gelu_cdf(m) + m * expf(-0.5f * m * m) / 2.50662827463100050f;
          static_cast<float*>(p.out)[o] = v * dg;
          break;
        }
        default:
          static_cast<float*>(p.out)[o] = v;
      }
    }
  }
}

// The LayerNorm backward of M rows of C: dln = rstd (dn g - mean(dn g) -
// xhat mean(dn g xhat)), out = res + dln, and per block the fixed-order sums
// of (dn xhat, dn) over its rows into part[block][C][2].
template <typename T>
struct LnArgs {
  const float* dn;
  const T* x;  // the LayerNorm's input
  int x_gather;
  const float* g;
  const void* res;
  int res_f32;
  void* out;  // fp32 (out_f32) or T
  int out_f32;
  int out_scatter;
  float* part;
  long long M;
  int C;
  long long rows_per_block;
  Geo geo;
};

template <typename T>
__global__ void __launch_bounds__(GT) swin_block_any_ln_bwd_kernel(const LnArgs<T> p) {
  __shared__ float red[GT / 32][2 * MAX_C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = p.C;
  float pg[VPL], pb[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) pg[i] = pb[i] = 0.0f;
  const long long r0 = blockIdx.x * p.rows_per_block;
  const long long r1 = r0 + p.rows_per_block < p.M ? r0 + p.rows_per_block : p.M;
  for (long long t = r0 + warp; t < r1; t += GT / 32) {
    const long long src = p.x_gather ? image_row(t, p.geo) : t;
    float xc[VPL], dn[VPL];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xc[i] = c < C ? to_f(p.x[src * C + c]) : 0.0f;
      dn[i] = c < C ? p.dn[t * C + c] : 0.0f;
      s += xc[i];
    }
    const float mean = warp_sum(s) / C;
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + 32 * i < C) {
        xc[i] -= mean;
        v = fmaf(xc[i], xc[i], v);
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) / C + LN_EPS);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float dxh = dn[i] * __ldg(p.g + c);
        s1 += dxh;
        s2 = fmaf(dxh, xc[i] * rstd, s2);
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    const long long orow = p.out_scatter ? image_row(t, p.geo) : t;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        const float xhat = xc[i] * rstd;
        const float dxh = dn[i] * __ldg(p.g + c);
        const float dln = rstd * ((dxh - m1) - xhat * m2);
        const float r = p.res_f32 ? static_cast<const float*>(p.res)[t * C + c]
                                  : to_f(static_cast<const T*>(p.res)[t * C + c]);
        if (p.out_f32)
          static_cast<float*>(p.out)[orow * C + c] = r + dln;
        else
          static_cast<T*>(p.out)[orow * C + c] = from_f<T>(r + dln);
        pg[i] = fmaf(dn[i], xhat, pg[i]);
        pb[i] += dn[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      red[warp][2 * c] = pg[i];
      red[warp][2 * c + 1] = pb[i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += GT) {
    float acc = 0.0f;
    for (int w = 0; w < GT / 32; ++w) acc += red[w][e];
    p.part[blockIdx.x * 2ll * C + e] = acc;
  }
}

// The weight products: part[split][a][b] = sum over the split's tokens of
// L[t][a] R[t][b], with R[t][k] = 1 (the bias vector's column).
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

template <typename T>
__global__ void __launch_bounds__(GT) swin_block_any_weights_kernel(const WeightArgs a) {
  const WeightJob& jb = a.job[blockIdx.z];
  if (static_cast<int>(blockIdx.x) >= jb.tiles) return;
  __shared__ float Ls[BK][BM + 4];
  __shared__ float Rs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tn = blockIdx.x / jb.tiles_k, tk = blockIdx.x - tn * jb.tiles_k;
  const int n0 = tn * BM, k0 = tk * BN;
  const long long t0 = blockIdx.y * a.tokens_per_split;
  const long long t1 = t0 + a.tokens_per_split < a.M ? t0 + a.tokens_per_split : a.M;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (long long tt = t0; tt < t1; tt += BK) {
    for (int e = tid; e < BK * BM; e += GT) {
      const int kk = e / BM, c = e - kk * BM;
      const long long t = tt + kk;
      const int n = n0 + c;
      float v = 0.0f;
      if (t < t1 && n < jb.n) {
        const long long i = t * jb.n + n;
        v = jb.l_f32 ? static_cast<const float*>(jb.l)[i] : to_f(static_cast<const T*>(jb.l)[i]);
      }
      Ls[kk][c] = v;
    }
    for (int e = tid; e < BK * BN; e += GT) {
      const int kk = e / BN, c = e - kk * BN;
      const long long t = tt + kk;
      const int k = k0 + c;
      float v = 0.0f;
      if (t < t1 && k <= jb.k)
        v = k < jb.k ? to_f(static_cast<const T*>(jb.r)[t * jb.k + k]) : 1.0f;
      Rs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float l[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        l[i] = Ls[kk][ty * 4 + i];
        r[i] = Rs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(l[i], r[j], acc[i][j]);
    }
    __syncthreads();
  }
  const long long width = jb.k + 1;
  float* part = jb.part + static_cast<long long>(blockIdx.y) * jb.n * width;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= jb.n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k <= jb.k) part[n * width + k] = acc[i][j];
    }
  }
}

// Everything a launch needs, from the shapes alone (ops/swin_block.py::
// generic_forward_plan and generic_backward_plan mirror it).
enum Scratch { S_N1, S_QKV, S_AO, S_H, S_N2, S_M1, S_GM, S_DY, S_DN, S_DH, S_DAO, S_DQKV,
               S_WPART, S_LNPART, S_BPART, S_COUNT };

struct BlockPlan {
  long long M;  // tokens
  int N, Bn, nW, hd;
  long long ln_rows;
  int ln_blocks;
  long long tokens_per_split;
  int splits;
  int wn[4], wk[4], wtiles_k[4], wtiles[4], wtiles_max;
  long long reduce_blocks;
  wa_any::Plan att_fwd, att_bwd;
  long long fwd_off[5];  // qkv, ao, h, gm; [4] = total bytes
  long long bwd_off[S_COUNT + 1];  // [S_COUNT] = total bytes
};

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

inline bool valid(int B, int H, int W, int C, int heads, int hidden, int ws, int shift) {
  return B >= 1 && ws >= 1 && ws <= MAX_WS && H % ws == 0 && W % ws == 0 && H > 0 && W > 0 &&
         heads >= 1 && C % heads == 0 && C / heads <= wa_any::MAX_HD && C <= MAX_C &&
         hidden >= 1 && hidden <= 4 * C && shift >= 0 && shift < ws;
}

inline BlockPlan make_plan(int B, int H, int W, int C, int heads, int hidden, int ws,
                           int itemsize) {
  BlockPlan p{};
  p.M = static_cast<long long>(B) * H * W;
  p.N = ws * ws;
  p.Bn = static_cast<int>(p.M / p.N);
  p.nW = (H / ws) * (W / ws);
  p.hd = C / heads;
  p.att_fwd = wa_any::make_plan(p.Bn, p.N, p.hd, heads, false);
  p.att_bwd = wa_any::make_plan(p.Bn, p.N, p.hd, heads, true);
  // the LayerNorm rows: at most LN_MAX_BLOCKS blocks, 64 rows or more each
  long long blocks = (p.M + 63) / 64;
  if (blocks > LN_MAX_BLOCKS) blocks = LN_MAX_BLOCKS;
  p.ln_rows = (p.M + blocks - 1) / blocks;
  p.ln_blocks = static_cast<int>((p.M + p.ln_rows - 1) / p.ln_rows);
  // the weight products: w2 (C x hidden), w1 (hidden x C), wp (C x C), wq (3C x C)
  const int wn[4] = {C, hidden, C, 3 * C}, wk[4] = {hidden, C, C, C};
  int tiles = 0;
  p.wtiles_max = 0;
  for (int j = 0; j < 4; ++j) {
    p.wn[j] = wn[j];
    p.wk[j] = wk[j];
    p.wtiles_k[j] = (wk[j] + 1 + BN - 1) / BN;
    p.wtiles[j] = (wn[j] + BM - 1) / BM * p.wtiles_k[j];
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
  const long long fwd[4] = {it * M * 3 * C, it * M * C, it * M * C, it * M * hidden};
  long long off = 0;
  for (int i = 0; i < 4; ++i) {
    p.fwd_off[i] = off;
    off += align256(fwd[i]);
  }
  p.fwd_off[4] = off;
  const long long bwd[S_COUNT] = {
      it * M * C, it * M * 3 * C, it * M * C, it * M * C, it * M * C,  // n1 qkv ao h n2
      4 * M * hidden, it * M * hidden, it * M * C,  // m1 (then dm1), gm, dy in window order
      4 * M * C, 4 * M * C, it * M * C, it * M * 3 * C,  // dn, dh, dao, dqkv
      4 * p.splits * part, 4 * 2 * 2ll * p.ln_blocks * C,  // weight and LayerNorm partials
      4ll * p.att_bwd.partials * heads * p.N * p.N};  // dbias slabs
  off = 0;
  for (int i = 0; i < S_COUNT; ++i) {
    p.bwd_off[i] = off;
    off += align256(bwd[i]);
  }
  p.bwd_off[S_COUNT] = off;
  return p;
}

template <typename T>
cudaError_t gemm(const GemmArgs<T>& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.M + BM - 1) / BM), (a.Nout + BN - 1) / BN);
  swin_block_any_gemm_kernel<T><<<grid, GT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
GemmArgs<T> gemm_args(const void* a, int K, const float* w, int Nout, int epi, void* out,
                      const BlockPlan& p, const Geo& geo) {
  GemmArgs<T> g{};
  g.a = a;
  g.K = K;
  g.w = w;
  g.Nout = Nout;
  g.epi = epi;
  g.out = out;
  g.M = p.M;
  g.geo = geo;
  return g;
}

enum Param { G1, B1, WQ, BQ, BIAS, WP, BP, G2, B2, W1, C1, W2, C2 };

// The forward's first four launches (recomputed by the backward): qkv, the
// attention, h and gm; n1, n2 and m1 kept where the pointers are set.
template <typename T>
cudaError_t forward_body(const T* x, const float* const* w, const float* mask, T* n1, T* qkv,
                         T* ao, T* h, T* n2, float* m1, T* gm, const BlockPlan& p,
                         const Geo& geo, int C, int heads, int hidden, float scale_io,
                         cudaStream_t s) {
  auto a = gemm_args<T>(x, C, w[WQ], 3 * C, EPI_ROUND, qkv, p, geo);
  a.a_gather = 1;
  a.ln_g = w[G1];
  a.ln_b = w[B1];
  a.a_store = n1;
  a.w_trans = 1;
  a.bias = w[BQ];
  cudaError_t err = gemm(a, s);
  if (err != cudaSuccess) return err;
  err = wa_any::forward<T>(qkv, w[BIAS], mask, ao, p.Bn, p.N, C, heads, p.nW, scale_io, s);
  if (err != cudaSuccess) return err;
  a = gemm_args<T>(ao, C, w[WP], C, EPI_RESID, h, p, geo);
  a.w_trans = 1;
  a.bias = w[BP];
  a.res = x;
  a.res_gather = 1;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  a = gemm_args<T>(h, C, w[W1], hidden, EPI_GELU, gm, p, geo);
  a.ln_g = w[G2];
  a.ln_b = w[B2];
  a.a_store = n2;
  a.w_trans = 1;
  a.bias = w[C1];
  a.out2 = m1;
  return gemm(a, s);
}

template <typename T>
cudaError_t block_forward(const T* x, T* y, const float* const* w, const float* mask, char* scratch,
                    const BlockPlan& p, const Geo& geo, int C, int heads, int hidden,
                    float scale_io, cudaStream_t s) {
  T* qkv = reinterpret_cast<T*>(scratch + p.fwd_off[0]);
  T* ao = reinterpret_cast<T*>(scratch + p.fwd_off[1]);
  T* h = reinterpret_cast<T*>(scratch + p.fwd_off[2]);
  T* gm = reinterpret_cast<T*>(scratch + p.fwd_off[3]);
  cudaError_t err = forward_body<T>(x, w, mask, nullptr, qkv, ao, h, nullptr, nullptr, gm, p,
                                    geo, C, heads, hidden, scale_io, s);
  if (err != cudaSuccess) return err;
  auto a = gemm_args<T>(gm, hidden, w[W2], C, EPI_RESID, y, p, geo);
  a.w_trans = 1;
  a.bias = w[C2];
  a.res = h;
  a.out_scatter = 1;
  return gemm(a, s);
}

template <typename T>
cudaError_t block_backward(const T* x, const T* dy, T* dx, const float* const* w, const float* mask,
                     float* const* grads, char* scratch, const BlockPlan& p, const Geo& geo,
                     int C, int heads, int hidden, float scale_io, float scale,
                     cudaStream_t s) {
  auto buf = [&](int i) { return scratch + p.bwd_off[i]; };
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
  cudaError_t err = forward_body<T>(x, w, mask, n1, qkv, ao, h, n2, m1, gm, p, geo, C, heads,
                                    hidden, scale_io, s);
  if (err != cudaSuccess) return err;
  // dm1 = (dy round(W2)) gelu'(m1), over m1 in place; dy kept in window order
  auto a = gemm_args<T>(dy, C, w[W2], hidden, EPI_DGELU, m1, p, geo);
  a.a_gather = 1;
  a.a_store = dyw;
  a.aux = m1;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  // dn2 = round(dm1) round(W1)
  a = gemm_args<T>(m1, hidden, w[W1], C, EPI_F32, dn, p, geo);
  a.a_f32 = 1;
  a.a_round = 1;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  LnArgs<T> ln{};
  ln.dn = dn;
  ln.x = h;
  ln.g = w[G2];
  ln.res = dyw;
  ln.out = dh;
  ln.out_f32 = 1;
  ln.part = lnpart;
  ln.M = p.M;
  ln.C = C;
  ln.rows_per_block = p.ln_rows;
  ln.geo = geo;
  swin_block_any_ln_bwd_kernel<T><<<p.ln_blocks, GT, 0, s>>>(ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dao = round(round(dh) round(Wp))
  a = gemm_args<T>(dh, C, w[WP], C, EPI_ROUND, dao, p, geo);
  a.a_f32 = 1;
  a.a_round = 1;
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  err = wa_any::backward<T>(qkv, w[BIAS], mask, dao, dqkv, bpart, p.Bn, p.N, C, heads, p.nW,
                            scale_io, scale, s);
  if (err != cudaSuccess) return err;
  // dn1 = dqkv round(Wq)
  a = gemm_args<T>(dqkv, 3 * C, w[WQ], C, EPI_F32, dn, p, geo);
  if ((err = gemm(a, s)) != cudaSuccess) return err;
  ln.x = x;
  ln.x_gather = 1;
  ln.g = w[G1];
  ln.res = dh;
  ln.res_f32 = 1;
  ln.out = dx;
  ln.out_f32 = 0;
  ln.out_scatter = 1;
  ln.part = lnpart + 2ll * p.ln_blocks * C;
  swin_block_any_ln_bwd_kernel<T><<<p.ln_blocks, GT, 0, s>>>(ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
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
  ss.s[4] = {lnpart, grads[G2], grads[B2], C, 2ll * C, 1, p.ln_blocks, 0};
  ss.s[5] = {lnpart + 2ll * p.ln_blocks * C, grads[G1], grads[B1], C, 2ll * C, 1, p.ln_blocks, 0};
  const long long nn = static_cast<long long>(heads) * p.N * p.N;
  ss.s[6] = {bpart, nullptr, grads[BIAS], nn, nn, 0, p.att_bwd.partials, 0};
  ss.count = 7;
  return wa_any::launch_reduce(ss, s);
}

constexpr int FWD_LAUNCHES = 5;
constexpr int BWD_LAUNCHES = 13;

// (grid x, y, z, threads, dynamic shared memory) of each launch, in order.
void launches(const BlockPlan& p, int C, int heads, int hidden, bool backward, int* out) {
  auto gemm_grid = [&](int nout, int* o) {
    const int v[5] = {static_cast<int>((p.M + BM - 1) / BM), (nout + BN - 1) / BN, 1, GT, 0};
    for (int i = 0; i < 5; ++i) o[i] = v[i];
  };
  auto set = [](int* o, int x, int y, int z, int t, int smem) {
    o[0] = x;
    o[1] = y;
    o[2] = z;
    o[3] = t;
    o[4] = smem;
  };
  int i = 0;
  gemm_grid(3 * C, out + 5 * i++);
  set(out + 5 * i++, p.att_fwd.grid_x, p.att_fwd.grid_y, 1, p.att_fwd.threads, p.att_fwd.smem);
  gemm_grid(C, out + 5 * i++);
  gemm_grid(hidden, out + 5 * i++);
  if (!backward) {
    gemm_grid(C, out + 5 * i++);  // fc2
    return;
  }
  gemm_grid(hidden, out + 5 * i++);  // dm1
  gemm_grid(C, out + 5 * i++);  // dn2
  set(out + 5 * i++, p.ln_blocks, 1, 1, GT, 0);
  gemm_grid(C, out + 5 * i++);  // dao
  set(out + 5 * i++, p.att_bwd.grid_x, p.att_bwd.grid_y, 1, p.att_bwd.threads, p.att_bwd.smem);
  gemm_grid(C, out + 5 * i++);  // dn1
  set(out + 5 * i++, p.ln_blocks, 1, 1, GT, 0);
  set(out + 5 * i++, p.wtiles_max, p.splits, 4, GT, 0);
  set(out + 5 * i++, static_cast<int>(p.reduce_blocks), 1, 1, wa_any::THREADS, 0);
}

}  // namespace

// x and y (B, H, W, C) fp32 or bf16, contiguous; params the 13 fp32 pointers in
// ops/swin_block.py's PARAM_NAMES order (the port's layout: Linear weights
// (out, in); bias (heads, N, N)); mask (nW, N, N) fp32 or null; scratch of
// dmh_swin_block_any_scratch_bytes(backward = 0) bytes.  Launches the five
// kernels on `stream` and returns the first error (0 = launched).
extern "C" int dmh_swin_block_any_fwd(const void* x, void* y, const float* const* params,
                                      const float* mask, void* scratch, long long nbytes, int B,
                                      int H, int W, int C, int heads, int hidden, int ws,
                                      int shift, float scale_io, int is_bf16, void* stream) {
  if (!valid(B, H, W, C, heads, hidden, ws, shift)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  if (nbytes < p.fwd_off[4] || !wa_any::plan_fits(p.att_fwd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo geo{B, H, W, ws, shift};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (is_bf16)
    return static_cast<int>(block_forward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), params, mask, sc,
        p, geo, C, heads, hidden, scale_io, s));
  return static_cast<int>(block_forward<float>(static_cast<const float*>(x), static_cast<float*>(y),
                                         params, mask, sc, p, geo, C, heads, hidden, scale_io,
                                         s));
}

// The forward's arguments, plus dy and dx (B, H, W, C) in the dtype of x, the
// 13 fp32 gradients (each written whole) in PARAM_NAMES order, scratch of
// dmh_swin_block_any_scratch_bytes(backward = 1) bytes, scale = hd^-0.5 in
// fp32.  Launches the thirteen kernels on `stream`.
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
  const Geo geo{B, H, W, ws, shift};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (is_bf16)
    return static_cast<int>(block_backward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), params, mask, grads, sc, p, geo, C, heads, hidden,
        scale_io, scale, s));
  return static_cast<int>(block_backward<float>(static_cast<const float*>(x),
                                          static_cast<const float*>(dy), static_cast<float*>(dx),
                                          params, mask, grads, sc, p, geo, C, heads, hidden,
                                          scale_io, scale, s));
}

// The scratch the forward (backward = 0: qkv, ao, h, gm and the total) or the
// backward (n1, qkv, ao, h, n2, m1, gm, dy, dn, dh, dao, dqkv, the weight,
// LayerNorm and dbias partials, and the total) carves: byte offsets into out.
extern "C" int dmh_swin_block_any_scratch_layout(int B, int H, int W, int C, int heads,
                                                 int hidden, int ws, int is_bf16, int backward,
                                                 long long* out) {
  if (!valid(B, H, W, C, heads, hidden, ws, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  if (backward)
    for (int i = 0; i <= S_COUNT; ++i) out[i] = p.bwd_off[i];
  else
    for (int i = 0; i <= 4; ++i) out[i] = p.fwd_off[i];
  return 0;
}

// Each launch of the forward (5) or the backward (13), in order, into out[5 *
// launches]: grid x, y, z, threads, dynamic shared memory bytes.
extern "C" int dmh_swin_block_any_plan(int B, int H, int W, int C, int heads, int hidden,
                                       int ws, int is_bf16, int backward, int* out) {
  if (!valid(B, H, W, C, heads, hidden, ws, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockPlan p = make_plan(B, H, W, C, heads, hidden, ws, is_bf16 ? 2 : 4);
  launches(p, C, heads, hidden, backward != 0, out);
  return 0;
}
