// Window attention (W-MSA / SW-MSA) at any window and head width, forward and
// backward, for Hopper, sm_90a: the generic variant of window_attention.cu.
//
// Replaces: dmhomo_tpu/ops/window_attention.py::_fwd_kernel and ::_bwd_kernel
// at the shapes the tuned library (window_attention.cu: N = 64 tokens, hd in
// 4, 8, 16, 32) does not take: any N = ws * ws up to 144 (ws <= 12) and any hd
// up to 64, fp32 or bf16 I/O, with or without an (nW, N, N) mask.  Included
// by window_attention_any.cu (the op's C entry points) and swin_block_any.cu
// (the attention step of the generic whole block).
//
// The same function as the tuned kernels, per window b and head g, with q
// scaled by hd^-0.5 in the I/O dtype and round() the rounding to it:
//   sim = q k^T (fp32) + bias[g] (+ mask[b % nW]),  e = round(exp(clip(sim, +-60))),
//   out = round((e v) / sum_j e)   (no row maximum: the clip bounds e);
// backward, e recomputed:
//   gg = gout / s,  ds = -(gg . e v) / s,  de = round(gg) v^T + ds,
//   dsim = round(exp(clip(sim)) * de * [|sim| < 60]),
//   dq = round((dsim k) hd^-0.5),  dk = round(dsim^T q),  dv = round(e^T round(gg)),
//   dbias[g] = sum over the windows of dsim (fp32).
//
// What bounds it on an H100.  A (window, head) pair reads 3 N hd values and
// writes N hd in the forward for 4 N^2 hd flops: at the HEM's window 4 (N =
// 16, hd 4-32) some 5 flops per fp32 byte, so HBM's 3.35 TB/s bounds it.
// The design is the simple one: a block owns one head and a chunk of windows
// and walks them G at a time (G = 1024 / N^2, 1 to 16, so that small windows
// still give every thread work); per round it stages the G windows' q
// (scaled), k and v in shared memory as fp32, writes the N x N tile of e (the
// backward: exp(clip(sim)) with its sign marking |sim| >= 60), and forms every
// output element as one thread's dot product over the tile.  No tensor cores,
// no registers per row: every loop runs over N and hd as runtime values.
// At N = 144, hd = 64 the backward's tile and four fp32 slices take 231,552
// bytes, the most a block may ask for being 232,448.
//
// dbias without atomics: each backward block adds its windows' dsim, in
// window order, into a slab of its own in device memory (a block owns its
// slab: one thread per element, reading and writing it in turn), and a second
// launch sums the slabs in a fixed order (reduce_kernel: a warp per element,
// lanes over the slabs, a fixed butterfly).  The same bits every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

// Everything here has internal linkage (an unnamed namespace): two libraries
// that include this header must not share a symbol, such as prepare()'s
// per-device flags, which the dynamic linker would otherwise unify across
// them and so skip the shared-memory limit of the second library's kernels.
namespace wa_any {
namespace {

constexpr int THREADS = 256;
constexpr int MAX_N = 144;  // 12 x 12 windows, the largest published Swin window
constexpr int MAX_HD = 64;
constexpr int MAX_ROUND = 16;  // windows a block stages per round at most
constexpr int ROUND_ELEMS = 1024;  // a round's logits the rule of G aims at
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM
constexpr int SMEM_PER_SM = 233472;
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int SMEM_RESERVED = 1024;  // bytes the card keeps per resident block
constexpr int FWD_WAVES = 2;  // forward blocks per SM slot the chunks aim at
constexpr float CLIP = 60.0f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Sum over the 32 lanes of a warp in a fixed butterfly: every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How a launch goes, from the shapes alone (ops/window_attention.py::
// generic_launch_plan mirrors it).
struct Plan {
  int grid_x, grid_y;  // (chunks of windows, heads)
  int threads;
  int smem;  // dynamic shared memory, bytes
  int windows_per_round;  // G
  int windows_per_block;
  int blocks_per_sm;  // by shared memory and threads
  int partials;  // the backward's dbias slabs (chunks); 0 for the forward
  int ld;  // row stride (floats) of a staged q, k, v or gout slice
};

inline int round_windows(int N) {
  const int g = ROUND_ELEMS / (N * N);
  return g < 1 ? 1 : (g > MAX_ROUND ? MAX_ROUND : g);
}

inline int slice_ld(int hd) { return hd < MAX_HD ? hd + 1 : hd; }

// Bn windows of N tokens, `heads` heads of hd; G windows a round.  Forward
// shared memory: G x (the e tile, q, k, v, the row sums); backward: G x (the
// tile, q, k, v, gout, s and ds).
inline Plan make_plan(int Bn, int N, int hd, int heads, bool backward) {
  Plan p{};
  const int G = round_windows(N);
  p.ld = slice_ld(hd);
  p.threads = THREADS;
  p.windows_per_round = G;
  const long long smem = backward ? 4ll * G * (N * N + 4 * N * p.ld + 2 * N)
                                  : 4ll * G * (N * N + 3 * N * p.ld + N);
  p.smem = static_cast<int>(smem);
  int per_sm = SMEM_PER_SM / (p.smem + SMEM_RESERVED);
  if (per_sm > 2048 / THREADS) per_sm = 2048 / THREADS;
  p.blocks_per_sm = per_sm;
  const long long rounds = (Bn + G - 1) / G;
  long long chunks = (static_cast<long long>(SMS) * per_sm * (backward ? 1 : FWD_WAVES)) / heads;
  if (chunks < 1) chunks = 1;
  if (chunks > rounds) chunks = rounds;
  long long per = (Bn + chunks - 1) / chunks;
  per = (per + G - 1) / G * G;
  chunks = (Bn + per - 1) / per;
  p.windows_per_block = static_cast<int>(per);
  p.grid_x = static_cast<int>(chunks);
  p.grid_y = heads;
  p.partials = backward ? p.grid_x : 0;
  return p;
}

inline bool plan_fits(const Plan& p) { return p.smem <= SMEM_PER_BLOCK && p.blocks_per_sm >= 1; }

// Stages windows w0 .. w0 + gn of head h: q scaled in the I/O dtype, k, v
// (and, for the backward, gout) as fp32 slices [g][n][ld].
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ qkv, const T* __restrict__ gout,
                                      float* qs, float* ks, float* vs, float* gs, long long w0,
                                      int gn, int N, int hd, int ld, int C, int h,
                                      float scale_io) {
  const int per = N * hd;
  const int C3 = 3 * C;
  for (int idx = threadIdx.x; idx < gn * per; idx += blockDim.x) {
    const int g = idx / per, r = idx - g * per;
    const int n = r / hd, d = r - n * hd;
    const long long tok = (w0 + g) * N + n;
    const T* row = qkv + tok * C3 + h * hd + d;
    const int s = (g * N + n) * ld + d;
    qs[s] = round_to<T>(to_f(row[0]) * scale_io);
    ks[s] = to_f(row[C]);
    vs[s] = to_f(row[2 * C]);
    if (gs) gs[s] = to_f(gout[tok * C + h * hd + d]);
  }
}

// sim of query i and key j of staged window g: fp32 q . k + bias (+ mask).
__device__ __forceinline__ float logit(const float* qs, const float* ks,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ mask, int g, int i, int j, int N,
                                      int hd, int ld, int h, long long w, int nW) {
  const float* q = qs + (g * N + i) * ld;
  const float* k = ks + (g * N + j) * ld;
  float dot = 0.0f;
  for (int d = 0; d < hd; ++d) dot = fmaf(q[d], k[d], dot);
  float sim = dot + __ldg(bias + (static_cast<long long>(h) * N + i) * N + j);
  if (mask) sim += __ldg(mask + ((w % nW) * N + i) * static_cast<long long>(N) + j);
  return sim;
}

// grid (chunks, heads); qkv (Bn, N, 3C), out (Bn, N, C) in T; bias (heads, N,
// N) and mask (nW, N, N) fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_any_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                const float* __restrict__ mask, T* __restrict__ out, int Bn,
                                int N, int C, int hd, int nW, int per_block, int G, int ld,
                                float scale_io) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int stride = N * ld;
  float* tile = smem;  // [G][N][N]
  float* qs = tile + G * N * N;
  float* ks = qs + G * stride;
  float* vs = ks + G * stride;
  float* rs = vs + G * stride;  // [G][N] row sums
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = begin + per_block < Bn ? begin + per_block : Bn;
  for (long long w0 = begin; w0 < end; w0 += G) {
    const int gn = end - w0 < G ? static_cast<int>(end - w0) : G;
    stage<T>(qkv, nullptr, qs, ks, vs, nullptr, w0, gn, N, hd, ld, C, h, scale_io);
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * N * N; idx += blockDim.x) {
      const int g = idx / (N * N), r = idx - g * N * N;
      const int i = r / N, j = r - i * N;
      const float sim = logit(qs, ks, bias, mask, g, i, j, N, hd, ld, h, w0 + g, nW);
      tile[idx] = round_to<T>(expf(fminf(fmaxf(sim, -CLIP), CLIP)));
    }
    __syncthreads();
    for (int r = threadIdx.x; r < gn * N; r += blockDim.x) {
      const float* e = tile + r * N;
      float s = 0.0f;
      for (int j = 0; j < N; ++j) s += e[j];
      rs[r] = s;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * N * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx - r * hd;  // r = g * N + i
      const int g = r / N;
      const float* e = tile + r * N;
      const float* v = vs + g * stride + d;
      float acc = 0.0f;
      for (int j = 0; j < N; ++j) acc = fmaf(e[j], v[j * ld], acc);
      out[((w0 * N) + r) * C + h * hd + d] = from_f<T>(acc / rs[r]);
    }
    __syncthreads();
  }
}

// grid (chunks, heads); gout (Bn, N, C) and dqkv (Bn, N, 3C) in T; slabs
// (chunks, heads, N, N) fp32: block (c, h) writes slab c, head h.
template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_any_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                const float* __restrict__ mask, const T* __restrict__ gout,
                                T* __restrict__ dqkv, float* __restrict__ slabs, int Bn, int N,
                                int C, int hd, int heads, int nW, int per_block, int G, int ld,
                                float scale_io, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int stride = N * ld;
  const int NN = N * N;
  float* tile = smem;  // [G][N][N]: e32 (negative where |sim| >= 60), then dsim
  float* qs = tile + G * NN;
  float* ks = qs + G * stride;
  float* vs = ks + G * stride;
  float* gs = vs + G * stride;  // gout, then round(gg)
  float* ss = gs + G * stride;  // [G][N] s
  float* dss = ss + G * N;  // [G][N] ds
  float* slab = slabs + (static_cast<long long>(blockIdx.x) * heads + h) * NN;
  const int C3 = 3 * C;
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = begin + per_block < Bn ? begin + per_block : Bn;
  for (long long w0 = begin; w0 < end; w0 += G) {
    const int gn = end - w0 < G ? static_cast<int>(end - w0) : G;
    stage<T>(qkv, gout, qs, ks, vs, gs, w0, gn, N, hd, ld, C, h, scale_io);
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * NN; idx += blockDim.x) {
      const int g = idx / NN, r = idx - g * NN;
      const int i = r / N, j = r - i * N;
      const float sim = logit(qs, ks, bias, mask, g, i, j, N, hd, ld, h, w0 + g, nW);
      const float e32 = expf(fminf(fmaxf(sim, -CLIP), CLIP));
      tile[idx] = fabsf(sim) < CLIP ? e32 : -e32;
    }
    __syncthreads();
    // per query row: s = sum round(e), ds = -(gg . (e v)) / s
    for (int r = threadIdx.x; r < gn * N; r += blockDim.x) {
      const int g = r / N;
      const float* e = tile + r * N;
      float s = 0.0f;
      for (int j = 0; j < N; ++j) s += round_to<T>(fabsf(e[j]));
      const float* v = vs + g * stride;
      const float* go = gs + r * ld;  // r = g * N + i: row i of window g
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) {
        float ctx = 0.0f;
        for (int j = 0; j < N; ++j) ctx = fmaf(round_to<T>(fabsf(e[j])), v[j * ld + d], ctx);
        dot = fmaf(go[d] / s, ctx, dot);
      }
      ss[r] = s;
      dss[r] = -dot / s;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * N * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx - r * hd;
      gs[r * ld + d] = round_to<T>(gs[r * ld + d] / ss[r]);
    }
    __syncthreads();
    // dv = round(e^T round(gg))
    for (int idx = threadIdx.x; idx < gn * N * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx - r * hd;  // r = g * N + j
      const int g = r / N, j = r - g * N;
      const float* e = tile + g * NN + j;
      const float* gg = gs + g * stride + d;
      float acc = 0.0f;
      for (int i = 0; i < N; ++i) acc = fmaf(round_to<T>(fabsf(e[i * N])), gg[i * ld], acc);
      dqkv[(w0 * N + r) * C3 + 2 * C + h * hd + d] = from_f<T>(acc);
    }
    __syncthreads();
    // dsim = round(e32 * (round(gg) v^T + ds) * [|sim| < 60])
    for (int idx = threadIdx.x; idx < gn * NN; idx += blockDim.x) {
      const int g = idx / NN, r = idx - g * NN;
      const int i = r / N, j = r - i * N;
      const float* gg = gs + (g * N + i) * ld;
      const float* v = vs + (g * N + j) * ld;
      float de = 0.0f;
      for (int d = 0; d < hd; ++d) de = fmaf(gg[d], v[d], de);
      de += dss[g * N + i];
      const float t = tile[idx];
      tile[idx] = t > 0.0f ? round_to<T>(t * de) : 0.0f;
    }
    __syncthreads();
    // dq = round((dsim k) hd^-0.5), dk = round(dsim^T q)
    for (int idx = threadIdx.x; idx < 2 * gn * N * hd; idx += blockDim.x) {
      const bool is_k = idx >= gn * N * hd;
      const int e_idx = is_k ? idx - gn * N * hd : idx;
      const int r = e_idx / hd, d = e_idx - r * hd;
      const int g = r / N, a = r - g * N;
      const float* ds = tile + g * NN;
      float acc = 0.0f;
      if (is_k) {
        const float* q = qs + g * stride + d;
        for (int i = 0; i < N; ++i) acc = fmaf(ds[i * N + a], q[i * ld], acc);
        dqkv[(w0 * N + r) * C3 + C + h * hd + d] = from_f<T>(acc);
      } else {
        const float* k = ks + g * stride + d;
        for (int j = 0; j < N; ++j) acc = fmaf(ds[a * N + j], k[j * ld], acc);
        dqkv[(w0 * N + r) * C3 + h * hd + d] = from_f<T>(acc * scale);
      }
    }
    // this block's slab: the round's windows added in order
    for (int idx = threadIdx.x; idx < NN; idx += blockDim.x) {
      float acc = w0 == begin ? 0.0f : slab[idx];
      for (int g = 0; g < gn; ++g) acc += tile[g * NN + idx];
      slab[idx] = acc;
    }
    __syncthreads();
  }
}

// One family of partials to sum: `parts` arrays of n * (k + 1) floats, `stride`
// floats apart from src.  Element (a, b) goes to dst0[a * k + b] for b < k and
// to dst1[a] for b == k (k = 0: everything to dst1).
struct Segment {
  const float* src;
  float* dst0;
  float* dst1;
  long long n;
  long long stride;
  int k;
  int parts;
  long long first_warp;  // of this segment in the launch
};

constexpr int MAX_SEGMENTS = 8;
struct Segments {
  Segment s[MAX_SEGMENTS];
  int count;
};

// A warp per element: lane l adds partials l, l + 32, ... in order, then a
// fixed butterfly adds the lanes.  Writing in place into partial 0 is safe:
// each element is read by its own warp before that warp writes it.
__global__ void __launch_bounds__(THREADS) window_attention_any_reduce_kernel(const Segments ss) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  int si = 0;
  while (si + 1 < ss.count && warp >= ss.s[si + 1].first_warp) ++si;
  const Segment& sg = ss.s[si];
  const long long e = warp - sg.first_warp;
  const long long width = sg.k + 1;
  if (e >= sg.n * width) return;  // the whole warp leaves together
  float acc = 0.0f;
  for (int p = lane; p < sg.parts; p += 32) acc += sg.src[p * sg.stride + e];
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long a = e / width, b = e - a * width;
    if (b < sg.k)
      sg.dst0[a * sg.k + b] = acc;
    else
      sg.dst1[a] = acc;
  }
}

// Lays out the segments' warps and launches the reduction (one launch).
inline cudaError_t launch_reduce(Segments ss, cudaStream_t stream) {
  long long warps = 0;
  for (int i = 0; i < ss.count; ++i) {
    ss.s[i].first_warp = warps;
    warps += ss.s[i].n * (ss.s[i].k + 1);
  }
  const long long blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  window_attention_any_reduce_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(ss);
  return cudaGetLastError();
}

inline long long reduce_blocks(const long long* elems, int count) {
  long long warps = 0;
  for (int i = 0; i < count; ++i) warps += elems[i];
  return (warps + THREADS / 32 - 1) / (THREADS / 32);
}

// Raises Kernel's dynamic shared-memory limit to the most a block may ask
// for, once per device.
template <auto Kernel>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_PER_BLOCK);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launches the forward: qkv (Bn, N, 3C) -> out (Bn, N, C).
template <typename T>
cudaError_t forward(const T* qkv, const float* bias, const float* mask, T* out, int Bn, int N,
                    int C, int heads, int nW, float scale_io, cudaStream_t stream) {
  const int hd = C / heads;
  const Plan p = make_plan(Bn, N, hd, heads, false);
  if (!plan_fits(p)) return cudaErrorInvalidValue;
  constexpr auto kernel = window_attention_any_fwd_kernel<T>;
  const cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      qkv, bias, mask, out, Bn, N, C, hd, mask ? nW : 1, p.windows_per_block,
      p.windows_per_round, p.ld, scale_io);
  return cudaGetLastError();
}

// Launches the backward's per-window kernel: dqkv (Bn, N, 3C) and the dbias
// slabs (plan.partials, heads, N, N); the caller sums the slabs.
template <typename T>
cudaError_t backward(const T* qkv, const float* bias, const float* mask, const T* gout, T* dqkv,
                     float* slabs, int Bn, int N, int C, int heads, int nW, float scale_io,
                     float scale, cudaStream_t stream) {
  const int hd = C / heads;
  const Plan p = make_plan(Bn, N, hd, heads, true);
  if (!plan_fits(p)) return cudaErrorInvalidValue;
  constexpr auto kernel = window_attention_any_bwd_kernel<T>;
  const cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      qkv, bias, mask, gout, dqkv, slabs, Bn, N, C, hd, heads, mask ? nW : 1,
      p.windows_per_block, p.windows_per_round, p.ld, scale_io, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wa_any
