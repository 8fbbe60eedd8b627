// Window attention (W-MSA / SW-MSA) forward and backward for Hopper, sm_90a.
//
// Replaces: dmhomo_tpu/ops/window_attention.py::_fwd_kernel and ::_bwd_kernel
// (the Pallas TPU kernels behind fused_window_attention and its custom_vjp).
//
// Forward, per window b and head g, with q scaled by hd^-0.5 in the I/O dtype:
//   sim = q k^T (fp32 accumulation) + bias[g] (+ mask[b % nW]),
//   e   = exp(clip(sim, +-60)) rounded to the I/O dtype,
//   s   = sum_j e (fp32, over the rounded e),
//   out = (e v) / s (fp32 accumulation), written to channels g*hd:(g+1)*hd.
// Backward, recomputing e from q and k (flash style), with gout the gradient
// of out:
//   gg   = gout / s;  ds = -(gg . ctx) / s  where ctx = e v (fp32),
//   de   = round(gg) v^T + ds,
//   dsim = round(exp(clip(sim)) * de * [|sim| < 60]),
//   dq   = round((dsim k) * hd^-0.5),  dk = round(dsim^T q),
//   dv   = round(e^T round(gg)),  dbias[g] = sum over all windows of dsim (fp32),
// where round() is rounding to the I/O dtype.  The logits never reach
// device memory in either direction.
//
// What bounds them on an H100.  At the HEM shapes (8x8 windows, C = 24, 48,
// 96, hd = 4..32) a forward (window, head) pair reads 64*3*hd values and
// writes 64*hd while doing 2*2*64*64*hd flops: 16 flops per byte with fp32
// I/O, under the 20 flops/byte where the card's fp32 CUDA cores
// (67 TFLOP/s) would take over from its 3.35 TB/s of HBM.  The backward
// reads 64*4*hd values, writes 64*3*hd and does 6*2*64*64*hd flops: 27
// flops per byte in fp32 (operations bound on CUDA cores), 55 in bf16
// (bytes bound against the tensor cores' 989 TFLOP/s).
//
// What this simple design does about it: every input byte is read from HBM
// once and every output byte written once.  A block owns one head g and one
// window-in-image w and walks the windows that share the same bias[g] and
// mask[w] tiles, which it stages once in shared memory (so they come from
// L2 once per block; a block takes fewer windows where the grid would
// otherwise not fill the card).  Four groups of 64 threads each take one window at a
// time.  Forward: thread i owns query row i; it keeps q_i and its output
// row in registers and streams the 64 keys/values of its window from shared
// memory.  Backward: pass A has thread i own query row i (recompute e_i, s_i
// and ctx_i, then gg_i, ds_i and dq_i); pass B has thread j own key row j
// and recompute column j of the logits from the q and gg rows pass A left in
// shared memory (dk_j, dv_j, column j of dsim).  Recomputing the column
// costs two more 64x64xhd products per (window, head) than storing the
// 64x64 e and dsim tiles, but keeps a window's shared memory at 4*64*hd
// floats, so four windows are in flight even at hd = 32.  dbias is summed
// over a block's windows in one shared-memory tile (shared atomics: thread j
// owns column j, the four groups meet only on the same element) and added
// to the zeroed fp32 output with one global atomicAdd per element per
// block.  Arithmetic is fp32 on CUDA cores, right for every head dim;
// tensor cores come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int N = 64;                      // tokens per 8x8 window
constexpr int LD = N + 1;                  // padded shared row: conflict-free column reads
constexpr int GROUPS = 4;                  // windows in flight per block
constexpr int THREADS = GROUPS * N;        // one thread per query (or key) row per window
constexpr int WINDOWS_PER_BLOCK = 16;      // forward: windows sharing one staged bias/mask tile
constexpr int BWD_WINDOWS_PER_BLOCK = 32;  // backward: also one dbias partial per block
constexpr int TARGET_BLOCKS = 264;         // two blocks per SM of an H100 (132 SMs)
constexpr float CLIP = 60.0f;

// Windows per block: up to `most`, fewer (a multiple of GROUPS) where the
// grid would otherwise leave SMs idle, as for a training microbatch.
inline int windows_per_block(int n_mask, int n_per, int heads, int most) {
  const int fill = (n_mask * n_per * heads / TARGET_BLOCKS) / GROUPS * GROUPS;
  return fill < GROUPS ? GROUPS : (fill > most ? most : fill);
}

// Dynamic shared memory of a forward block: the bias tile, the mask tile
// when there is one, and k, v of one head for each window in flight.
constexpr size_t smem_bytes(int hd, bool mask) {
  return ((mask ? 2 : 1) * N * LD + GROUPS * 2 * N * hd) * sizeof(float);
}

// Of a backward block: bias, mask and the dbias partial, and per window in
// flight q (scaled), k, v, round(gg) of one head and the ds column.
constexpr size_t bwd_group_floats(int hd) { return 4 * N * hd + N; }
constexpr size_t bwd_smem_bytes(int hd, bool mask) {
  return ((mask ? 3 : 2) * N * LD + GROUPS * bwd_group_floats(hd)) * sizeof(float);
}

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

template <int HD>
__device__ __forceinline__ float dot_row(const float* a, const float* b_s) {
  const float4* b4 = reinterpret_cast<const float4*>(b_s);
  float dot = 0.0f;
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) {
    const float4 bb = b4[d];
    dot = fmaf(a[4 * d], bb.x, dot);
    dot = fmaf(a[4 * d + 1], bb.y, dot);
    dot = fmaf(a[4 * d + 2], bb.z, dot);
    dot = fmaf(a[4 * d + 3], bb.w, dot);
  }
  return dot;
}

template <int HD>
__device__ __forceinline__ void axpy_row(float a, const float* x_s, float* acc) {
  const float4* x4 = reinterpret_cast<const float4*>(x_s);
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) {
    const float4 xx = x4[d];
    acc[4 * d] = fmaf(a, xx.x, acc[4 * d]);
    acc[4 * d + 1] = fmaf(a, xx.y, acc[4 * d + 1]);
    acc[4 * d + 2] = fmaf(a, xx.z, acc[4 * d + 2]);
    acc[4 * d + 3] = fmaf(a, xx.w, acc[4 * d + 3]);
  }
}

// grid: x = n_mask * chunks (window-in-image w, then chunk), y = head g.
// Window b = k * n_mask + w for k in [0, n_per): image-major flattening, so
// with a mask (n_mask = nW) every window of a block takes mask row w.
template <typename T, int HD, bool MASK>
__global__ void __launch_bounds__(THREADS)
window_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ out,
                            int C, int n_mask, int n_per, int wpb, float scale) {
  extern __shared__ float4 smem4[];
  float* bias_s = reinterpret_cast<float*>(smem4);  // N x LD
  float* mask_s = bias_s + N * LD;                  // N x LD, with a mask only
  float* kv_s = mask_s + (MASK ? N * LD : 0);       // GROUPS x (k, v) x N x HD

  const int g = blockIdx.y;
  const int chunks = (n_per + wpb - 1) / wpb;
  const int w = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * wpb;
  const int k1 = min(k0 + wpb, n_per);
  const int tid = threadIdx.x;
  const int grp = tid / N;
  const int i = tid % N;

  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e % N;
    bias_s[r * LD + c] = bias[static_cast<size_t>(g) * N * N + e];
    if (MASK) mask_s[r * LD + c] = mask[static_cast<size_t>(w) * N * N + e];
  }
  float* k_s = kv_s + grp * 2 * N * HD;
  float* v_s = k_s + N * HD;
  const int C3 = 3 * C;
  const float* brow = bias_s + i * LD;
  const float* mrow = mask_s + i * LD;
  __syncthreads();

  for (int kb = k0; kb < k1; kb += GROUPS) {
    const int k = kb + grp;
    const bool active = k < k1;
    const size_t row = (static_cast<size_t>(k) * n_mask + w) * N + i;
    float q[HD];
    if (active) {
      const T* src = qkv + row * C3 + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float x[4];
        IO<T>::load4(src + d, x);
#pragma unroll
        for (int t = 0; t < 4; ++t) q[d + t] = IO<T>::round(x[t] * scale);
        IO<T>::load4(src + C + d, x);
        *reinterpret_cast<float4*>(k_s + i * HD + d) = make_float4(x[0], x[1], x[2], x[3]);
        IO<T>::load4(src + 2 * C + d, x);
        *reinterpret_cast<float4*>(v_s + i * HD + d) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
    __syncthreads();
    if (active) {
      float acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
      float s = 0.0f;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        float sim = dot_row<HD>(q, k_s + j * HD) + brow[j];
        if (MASK) sim += mrow[j];
        const float e = IO<T>::round(expf(fminf(fmaxf(sim, -CLIP), CLIP)));
        s += e;
        axpy_row<HD>(e, v_s + j * HD, acc);
      }
      T* dst = out + row * C + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = acc[d + t] / s;
        IO<T>::store4(dst + d, x);
      }
    }
    __syncthreads();
  }
}

// Same grid and window order as the forward.  dbias must be zeroed by the
// caller; every other output element is written exactly once.
template <typename T, int HD, bool MASK>
__global__ void __launch_bounds__(THREADS)
window_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, const T* __restrict__ gout,
                            T* __restrict__ dqkv, float* __restrict__ dbias,
                            int C, int n_mask, int n_per, int wpb, float scale_io, float scale) {
  extern __shared__ float4 smem4[];
  float* bias_s = reinterpret_cast<float*>(smem4);  // N x LD
  float* mask_s = bias_s + N * LD;                  // N x LD, with a mask only
  float* acc_s = mask_s + (MASK ? N * LD : 0);      // N x LD dbias partial
  float* grp_s = acc_s + N * LD;                    // GROUPS x GROUP_FLOATS
  constexpr int GROUP_FLOATS = 4 * N * HD + N;      // bwd_group_floats(HD)

  const int g = blockIdx.y;
  const int chunks = (n_per + wpb - 1) / wpb;
  const int w = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * wpb;
  const int k1 = min(k0 + wpb, n_per);
  const int tid = threadIdx.x;
  const int grp = tid / N;
  const int i = tid % N;  // query row in pass A, key row in pass B

  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e % N;
    bias_s[r * LD + c] = bias[static_cast<size_t>(g) * N * N + e];
    if (MASK) mask_s[r * LD + c] = mask[static_cast<size_t>(w) * N * N + e];
    acc_s[r * LD + c] = 0.0f;
  }
  float* q_s = grp_s + grp * GROUP_FLOATS;          // scaled q rows
  float* k_s = q_s + N * HD;
  float* v_s = k_s + N * HD;
  float* g_s = v_s + N * HD;                        // round(gg) rows
  float* ds_s = g_s + N * HD;
  const int C3 = 3 * C;
  const float* brow = bias_s + i * LD;
  const float* mrow = mask_s + i * LD;
  __syncthreads();

  for (int kb = k0; kb < k1; kb += GROUPS) {
    const int k = kb + grp;
    const bool active = k < k1;
    const size_t row = (static_cast<size_t>(k) * n_mask + w) * N + i;
    float q[HD], gg[HD];
    if (active) {
      const T* src = qkv + row * C3 + g * HD;
      const T* gsrc = gout + row * C + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float x[4];
        IO<T>::load4(src + d, x);
#pragma unroll
        for (int t = 0; t < 4; ++t) q[d + t] = IO<T>::round(x[t] * scale_io);
        *reinterpret_cast<float4*>(q_s + i * HD + d) = make_float4(q[d], q[d + 1], q[d + 2], q[d + 3]);
        IO<T>::load4(src + C + d, x);
        *reinterpret_cast<float4*>(k_s + i * HD + d) = make_float4(x[0], x[1], x[2], x[3]);
        IO<T>::load4(src + 2 * C + d, x);
        *reinterpret_cast<float4*>(v_s + i * HD + d) = make_float4(x[0], x[1], x[2], x[3]);
        IO<T>::load4(gsrc + d, gg + d);
      }
    }
    __syncthreads();

    // pass A: query row i
    if (active) {
      float acc[HD];  // ctx_i, then dq_i
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
      float s = 0.0f;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        float sim = dot_row<HD>(q, k_s + j * HD) + brow[j];
        if (MASK) sim += mrow[j];
        const float e = IO<T>::round(expf(fminf(fmaxf(sim, -CLIP), CLIP)));
        s += e;
        axpy_row<HD>(e, v_s + j * HD, acc);
      }
      float ds = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        gg[d] = gg[d] / s;
        ds = fmaf(gg[d], acc[d], ds);
      }
      ds = -ds / s;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        gg[d] = IO<T>::round(gg[d]);
        acc[d] = 0.0f;
      }
#pragma unroll
      for (int d = 0; d < HD; d += 4)
        *reinterpret_cast<float4*>(g_s + i * HD + d) = make_float4(gg[d], gg[d + 1], gg[d + 2], gg[d + 3]);
      ds_s[i] = ds;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        float sim = dot_row<HD>(q, k_s + j * HD) + brow[j];
        if (MASK) sim += mrow[j];
        const float e32 = expf(fminf(fmaxf(sim, -CLIP), CLIP));
        const float de = dot_row<HD>(gg, v_s + j * HD) + ds;
        const float dsim = fabsf(sim) < CLIP ? IO<T>::round(e32 * de) : 0.0f;
        axpy_row<HD>(dsim, k_s + j * HD, acc);
      }
      T* dst = dqkv + row * C3 + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = acc[d + t] * scale;
        IO<T>::store4(dst + d, x);
      }
    }
    __syncthreads();

    // pass B: key row j = i, column j of the logits
    if (active) {
      float kj[HD], vj[HD], dk[HD], dv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        kj[d] = k_s[i * HD + d];
        vj[d] = v_s[i * HD + d];
        dk[d] = 0.0f;
        dv[d] = 0.0f;
      }
#pragma unroll 2
      for (int r = 0; r < N; ++r) {
        float sim = dot_row<HD>(kj, q_s + r * HD) + bias_s[r * LD + i];
        if (MASK) sim += mask_s[r * LD + i];
        const float e32 = expf(fminf(fmaxf(sim, -CLIP), CLIP));
        const float de = dot_row<HD>(vj, g_s + r * HD) + ds_s[r];
        const float dsim = fabsf(sim) < CLIP ? IO<T>::round(e32 * de) : 0.0f;
        axpy_row<HD>(dsim, q_s + r * HD, dk);
        axpy_row<HD>(IO<T>::round(e32), g_s + r * HD, dv);
        atomicAdd(acc_s + r * LD + i, dsim);
      }
      T* dst = dqkv + row * C3 + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        IO<T>::store4(dst + C + d, dk + d);
        IO<T>::store4(dst + 2 * C + d, dv + d);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * N; e += THREADS)
    atomicAdd(dbias + static_cast<size_t>(g) * N * N + e, acc_s[(e / N) * LD + e % N]);
}

// One launch's arguments, as the C entry points take them.
struct Args {
  const void* qkv;
  const void* bias;
  const void* mask;
  const void* gout;  // backward only
  void* out;         // forward: out; backward: dqkv
  void* dbias;       // backward only
  int Bn, C, heads, nW;
  float scale_io;    // hd^-0.5 rounded to the I/O dtype: scales q
  float scale;       // hd^-0.5 in fp32: scales dq
};

struct Fwd {
  template <typename T, int HD, bool MASK>
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const int n_mask = MASK ? a.nW : 1;
    const int n_per = a.Bn / n_mask;
    const int wpb = windows_per_block(n_mask, n_per, a.heads, WINDOWS_PER_BLOCK);
    const int chunks = (n_per + wpb - 1) / wpb;
    const size_t smem = smem_bytes(HD, MASK);
    auto kernel = window_attention_fwd_kernel<T, HD, MASK>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n_mask * chunks, a.heads), THREADS, smem, stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const float*>(a.bias),
        static_cast<const float*>(a.mask), static_cast<T*>(a.out), a.C, n_mask, n_per, wpb,
        a.scale_io);
    return cudaGetLastError();
  }
};

struct Bwd {
  template <typename T, int HD, bool MASK>
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    const int n_mask = MASK ? a.nW : 1;
    const int n_per = a.Bn / n_mask;
    const int wpb = windows_per_block(n_mask, n_per, a.heads, BWD_WINDOWS_PER_BLOCK);
    const int chunks = (n_per + wpb - 1) / wpb;
    const size_t smem = bwd_smem_bytes(HD, MASK);
    auto kernel = window_attention_bwd_kernel<T, HD, MASK>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n_mask * chunks, a.heads), THREADS, smem, stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const float*>(a.bias),
        static_cast<const float*>(a.mask), static_cast<const T*>(a.gout),
        static_cast<T*>(a.out), static_cast<float*>(a.dbias), a.C, n_mask, n_per, wpb,
        a.scale_io, a.scale);
    return cudaGetLastError();
  }
};

template <typename Op, typename T, bool MASK>
cudaError_t dispatch_hd(const Args& a, cudaStream_t stream) {
  switch (a.C / a.heads) {
    case 4: return Op::template run<T, 4, MASK>(a, stream);
    case 8: return Op::template run<T, 8, MASK>(a, stream);
    case 16: return Op::template run<T, 16, MASK>(a, stream);
    case 32: return Op::template run<T, 32, MASK>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Op>
int dispatch(const Args& a, int is_bf16, void* stream) {
  if (a.heads <= 0 || a.C % a.heads != 0 || a.Bn <= 0 ||
      (a.mask && (a.nW <= 0 || a.Bn % a.nW != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = a.mask ? dispatch_hd<Op, __nv_bfloat16, true>(a, s)
                 : dispatch_hd<Op, __nv_bfloat16, false>(a, s);
  } else {
    err = a.mask ? dispatch_hd<Op, float, true>(a, s) : dispatch_hd<Op, float, false>(a, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// qkv (Bn, 64, 3C) fp32 or bf16; bias (heads, 64, 64) fp32; mask (nW, 64, 64)
// fp32 or null; out (Bn, 64, C) in the dtype of qkv.  All contiguous and
// 16-byte aligned; head dim C / heads in {4, 8, 16, 32}; Bn a multiple of nW.
// scale is hd^-0.5 already rounded to the I/O dtype.  Launches on `stream`
// and returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dmh_window_attention_fwd(const void* qkv, const void* bias, const void* mask,
                                        void* out, int Bn, int C, int heads, int nW,
                                        float scale, int is_bf16, void* stream) {
  const Args a{qkv, bias, mask, nullptr, out, nullptr, Bn, C, heads, nW, scale, 0.0f};
  return dispatch<Fwd>(a, is_bf16, stream);
}

// The forward's arguments, plus gout (Bn, 64, C) and dqkv (Bn, 64, 3C) in the
// dtype of qkv, dbias (heads, 64, 64) fp32 and zeroed by the caller (the
// kernel adds to it), scale_io = hd^-0.5 rounded to the I/O dtype and
// scale = hd^-0.5 in fp32.
extern "C" int dmh_window_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                        const void* gout, void* dqkv, void* dbias, int Bn,
                                        int C, int heads, int nW, float scale_io, float scale,
                                        int is_bf16, void* stream) {
  const Args a{qkv, bias, mask, gout, dqkv, dbias, Bn, C, heads, nW, scale_io, scale};
  return dispatch<Bwd>(a, is_bf16, stream);
}

// Bytes of dynamic shared memory a launch with head dim hd asks for.
extern "C" int dmh_window_attention_smem_bytes(int hd, int has_mask) {
  return static_cast<int>(smem_bytes(hd, has_mask != 0));
}

extern "C" int dmh_window_attention_bwd_smem_bytes(int hd, int has_mask) {
  return static_cast<int>(bwd_smem_bytes(hd, has_mask != 0));
}
