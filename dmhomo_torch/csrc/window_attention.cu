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
// (bytes bound against the tensor cores' 989 TFLOP/s).  In practice the
// work per logit that no product does (the bias and mask, the clip and exp,
// the rounding, dsim) sets the time: at hd = 4 a logit is 4 multiply-adds
// against some twenty other instructions.
//
// The backward and the forward's warp-tile kernel lay the logits out as
// mma.sync does: a warp owns 16 query rows of one head, and with g = lane /
// 4, t = lane % 4 a thread holds rows g and g + 8, keys 8 j + 2 t and
// 8 j + 2 t + 1.  bf16 launches run every
// product on tensor cores (mma.sync m16n8k16, m16n8k8 with the reduction
// zero-padded to 8 at hd = 4); every operand is a bf16 value already (the
// scaled q, k, v, round(e), round(gg), round(dsim)), so the tensor cores
// compute the plain version's products and only the summation order
// differs.  fp32 launches compute the same layout with FMAs on CUDA cores
// (no TF32).
//
// The forward.  A block owns one window-in-image w, a chunk of the windows
// k * n_mask + w, which share the mask row w (image-major windows), and a
// group of heads; it stages the group's bias tiles and that mask row in
// shared memory once and walks its windows.  Two designs, by what bounds
// them:
//  * bf16, and fp32 at hd 4: warp tiles.  HG heads a block, where HG * hd
//    values fill 16 bytes (bf16) or 32 (fp32) of each token's q, k and v
//    (two heads of hd 4; four heads, whole 32-byte sectors in bf16, were
//    slower).  The next window's q, k and v columns of the group are
//    copied by cp.async (16 bytes where aligned, else 8) while the current
//    one is worked on, with one barrier per window.  Four warps take one
//    head (two heads at a time where HG > 1); keys go 64 at a time in bf16
//    (16 in fp32) and e stays in registers: in bf16 its packed
//    accumulators are the A fragments of e v; in fp32 each thread sums e v
//    over its own keys and the four lanes of a row add by shuffles.  Each
//    bias and mask value is read once, as a float2.
//  * fp32 from hd 8 up: a thread per query row, ROW_GROUPS windows of one
//    head in flight.  On CUDA cores a warp tile reads two operand bytes
//    from shared memory per multiply-add; here every thread of a window
//    reads the same k and v row at once (a broadcast) and keeps q and its
//    output row in registers.  Up to hd 16 the next round's q, k and v rows
//    are loaded into registers while this round is worked on.
// exp is expf in fp32; in bf16, where e is rounded to 8 bits, ex2.approx of
// the clipped logit times log2(e).  The backward takes expf in both dtypes.
//
// The backward.  A block of four warps owns one head and a chunk of
// consecutive windows, sized so that the grid fills the card once; it stages
// the head's bias tile once.  Per window it takes the head's q (scaled), k,
// v and gout columns (the next window's copied by cp.async while this one
// is worked on) into fp32 tiles; warp w takes query rows 16 w ..: the
// logits once (mask row b % nW read as float2s), e32 kept in registers
// (negated outside the clip, where dsim is 0) and round(e) stored to a
// 64 x 64 tile, s, ctx = e v, gg, ds, de = round(gg) v^T + ds, dsim =
// round(e32 de) kept in registers and stored to a second tile (both tiles
// in the I/O dtype, which holds them exactly), dq = dsim k; then key rows
// 16 w ..: dk = dsim^T q and dv = e^T round(gg) from the two tiles.  Every
// logit is computed once: one exp, one q.k.  dbias is summed in registers
// over the chunk and written once to the block's slab of the dbias buffer;
// a second launch adds the slabs in a fixed order into the first.  No
// atomic anywhere, so a launch gives the same bits run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int N = 64;            // tokens per 8x8 window
constexpr int TEAM = 128;        // four warps: 16 query rows each
constexpr int ELD = N + 4;       // row stride of the backward's fp32 e and dsim tiles
constexpr int BLD = N + 8;       // of a bias or mask tile: conflict-free float2 reads
constexpr int SMS = 132;         // streaming multiprocessors of an H100 SXM
constexpr int SMEM_PER_SM = 233472;
constexpr int SMEM_RESERVED = 1024;  // bytes the card keeps per resident block
constexpr int FWD_MAX_WINDOWS = 32;  // windows a forward block takes at most
constexpr int FWD_WAVES = 2;         // forward blocks per SM slot the chunks aim at
constexpr int FWD_BF16_KEYS = 64;   // keys a bf16 forward warp takes at a time
constexpr int ROW_GROUPS = 4;        // fp32 forward at hd >= 8: windows in flight per block
constexpr int RLD = N + 1;           // its bias and mask rows: conflict-free column reads
constexpr int DBIAS_THREADS = 256;
constexpr int DBIAS_PARTS = 4;       // ranges of slabs the reduction sums apart, then adds
constexpr float CLIP = 60.0f;

template <typename T>
struct IO;

template <>
struct IO<float> {
  static __device__ __forceinline__ void load4(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
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
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <typename T>
struct Bf16 {
  static constexpr bool value = false;
};
template <>
struct Bf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

// bytes of q (k, v) per token a forward block's head group reads
template <typename T>
constexpr int FWD_GROUP_BYTES = Bf16<T>::value ? 16 : 32;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
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

// One warp's 16 x 8NT tile in mma.sync's accumulator layout: acc[j][q] is
// row g + 8 (q / 2), column 8 j + 2 t + q % 2, and
//   acc[j] += sum over k < K of a(m, k) b(k, n),  m < 16, n < 8 NT,
// with the operands read in pairs along k through the callers' functions:
// a(m, k) gives (a(m, k), a(m, k + 1)) and b(k, n) gives (b(k, n), b(k + 1,
// n)) for even k, as float2s (0 outside the operands).  bf16: mma.sync on
// tensor cores, each operand rounded to bf16 as it is packed (exact for the
// bf16 values the callers give it); K a multiple of 8 (m16n8k16 steps, one
// m16n8k8 for the rest).  fp32: FMAs on CUDA cores, the same layout, K even.
template <typename T, int NT, int K>
struct WarpMma;

template <int NT, int K>
struct WarpMma<float, NT, K> {
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

template <int NT, int K>
struct WarpMma<__nv_bfloat16, NT, K> {
  static_assert(K % 8 == 0, "the reduction must be a multiple of 8");

  // a caller's pair, packed here, or already packed (a uint32_t)
  template <typename F>
  static __device__ __forceinline__ uint32_t frag(F f, int i, int k) {
    const auto x = f(i, k);
    if constexpr (std::is_same_v<std::decay_t<decltype(x)>, uint32_t>) {
      return x;
    } else {
      return pack_bf16(x.x, x.y);
    }
  }

  template <typename FA, typename FB>
  static __device__ __forceinline__ void run(float (&acc)[NT][4], FA a, FB b) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 + 16 <= K; k0 += 16) {
      const uint32_t ah[4] = {frag(a, g, k0 + 2 * t), frag(a, g + 8, k0 + 2 * t),
                              frag(a, g, k0 + 8 + 2 * t), frag(a, g + 8, k0 + 8 + 2 * t)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        mma16(acc[j], ah, frag(b, k0 + 2 * t, n), frag(b, k0 + 8 + 2 * t, n));
      }
    }
    if constexpr (K % 16 != 0) {
      constexpr int k0 = K - 8;
      const uint32_t a0 = frag(a, g, k0 + 2 * t), a1 = frag(a, g + 8, k0 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma8(acc[j], a0, a1, frag(b, k0 + 2 * t, 8 * j + g));
    }
  }
};

// p[0] and p[ld] of a bf16 buffer, packed (lo = p[0]) as an mma.sync operand
__device__ __forceinline__ uint32_t packed_pair(const __nv_bfloat16* p, int ld) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[ld]) << 16);
}

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
// 16 or 8 bytes from device to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// exp(clip(v, +-60)): expf for fp32; for bf16, whose e is rounded to 8
// bits, ex2.approx of the clipped value times log2(e): relative error about
// 2^-22 plus |v| 2^-24 from rounding the product (under 4e-6 at the clip),
// against bf16's rounding of 2^-9.  The forward only: the backward's
// unrounded e32 enters dsim = round(e32 de), so it takes expf (T = float).
template <typename T>
__device__ __forceinline__ float clipped_exp(float v) {
  const float x = fminf(fmaxf(v, -CLIP), CLIP);
  if constexpr (Bf16<T>::value) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  } else {
    return expf(x);
  }
}

// the reduction over a head dim: bf16 pads it to the mma's k (8)
template <typename T, int HD>
struct HeadK {
  static constexpr int value = Bf16<T>::value && HD < 8 ? 8 : HD;
};

// Blocks per SM the shared memory allows for `bytes` a block.
__host__ __device__ constexpr int smem_blocks(size_t bytes) {
  return static_cast<int>(SMEM_PER_SM / (bytes + SMEM_RESERVED));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Whether a forward launch takes the fp32 row kernel (a thread per query
// row, keys broadcast from shared memory): fp32 from hd 8 up, where the
// warp tiles' operand reads outweigh their products on CUDA cores.
template <typename T>
__host__ __device__ constexpr bool fwd_rows(int hd) {
  return !Bf16<T>::value && hd >= 8;
}
// Heads per forward block: HG * hd * sizeof(T) = FWD_GROUP_BYTES<T> of q
// (k, v) per token for small heads, one head from that width up.
template <typename T>
__host__ __device__ constexpr int fwd_heads(int hd) {
  return fwd_rows<T>(hd) || hd * static_cast<int>(sizeof(T)) >= FWD_GROUP_BYTES<T>
             ? 1
             : FWD_GROUP_BYTES<T> / (hd * static_cast<int>(sizeof(T)));
}
// warp tiles: four warps per head in flight, two heads at a time where the
// group has two; rows: ROW_GROUPS windows of 64 rows
template <typename T>
__host__ __device__ constexpr int fwd_threads(int hd) {
  return fwd_rows<T>(hd) ? ROW_GROUPS * N : (fwd_heads<T>(hd) > 1 ? 2 * TEAM : TEAM);
}
// Row stride (elements) of a staged q, k or v slice `width` elements wide:
// 8 (mod 32) floats or 12 (mod 32) bf16 pairs (32-bit words), so that the
// fragments' pair reads of rows g, columns 2 t are conflict-free.
template <typename T>
__host__ __device__ constexpr int stage_ld(int width) {
  return Bf16<T>::value ? width + 8 : (width == 8 ? 8 : width + 8);
}
// Bytes of a forward block: the group's bias tiles, the mask row, and two
// windows' q, k, v slices of the group.
// The row kernel's: the head's bias tile, the mask row, and k, v of its
// ROW_GROUPS windows in flight.
template <typename T>
__host__ __device__ constexpr size_t fwd_smem_bytes(int hd, bool mask) {
  return fwd_rows<T>(hd)
             ? sizeof(float) * static_cast<size_t>((mask ? 2 : 1) * N * RLD + ROW_GROUPS * 2 * N * hd)
             : sizeof(float) * static_cast<size_t>((fwd_heads<T>(hd) + (mask ? 1 : 0)) * N * BLD) +
                   sizeof(T) * static_cast<size_t>(2 * 3 * N * stage_ld<T>(fwd_heads<T>(hd) * hd));
}
// the launch bounds: blocks of fwd_threads an SM keeps resident
template <typename T>
__host__ __device__ constexpr int fwd_min_blocks(int hd) {
  return fwd_threads<T>(hd) == TEAM ? 4 : 2;
}

// fp32 forward from hd 8 up.  Block (w + n_mask * chunk, head g), the
// forward kernel's grid with one head a block: thread i of group grp owns
// query row i of windows kb + grp, kb + grp + ROW_GROUPS, ...; it keeps q_i
// and its output row in registers and reads the window's k and v rows from
// shared memory, the same row for every thread at once.  Up to hd 16 the
// next round's q, k and v rows are loaded into registers while this round
// is worked on.
template <int HD, bool MASK>
__global__ void __launch_bounds__(ROW_GROUPS * N, 2)
window_attention_fwd_rows_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                                 const float* __restrict__ mask, float* __restrict__ out, int C,
                                 int n_mask, int n_per, int wpb, float scale) {
  constexpr int THREADS = ROW_GROUPS * N;
  constexpr bool AHEAD = HD <= 16;
  extern __shared__ float4 smem4[];
  float* bias_s = reinterpret_cast<float*>(smem4);  // N x RLD
  float* mask_s = bias_s + N * RLD;                 // N x RLD, with a mask only
  float* kv_s = mask_s + (MASK ? N * RLD : 0);      // ROW_GROUPS x (k, v) x N x HD

  const int g = blockIdx.y;
  const int chunks = (n_per + wpb - 1) / wpb;
  const int w = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * wpb;
  const int k1 = min(k0 + wpb, n_per);
  const int tid = threadIdx.x, grp = tid / N, i = tid % N;
  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e % N;
    bias_s[r * RLD + c] = __ldg(bias + static_cast<size_t>(g) * N * N + e);
    if (MASK) mask_s[r * RLD + c] = __ldg(mask + static_cast<size_t>(w) * N * N + e);
  }
  float* k_s = kv_s + grp * 2 * N * HD;
  float* v_s = k_s + N * HD;
  const size_t C3 = 3 * static_cast<size_t>(C);
  const float* brow = bias_s + i * RLD;
  const float* mrow = mask_s + i * RLD;
  const auto row_of = [&](int k) {
    return qkv + ((static_cast<size_t>(k) * n_mask + w) * N + i) * C3 + g * HD;
  };
  // the next round's rows, in flight during this one (AHEAD)
  float nq[AHEAD ? HD : 4], nk[AHEAD ? HD : 4], nv[AHEAD ? HD : 4];
  const auto fetch = [&](int k) {
    if (k >= k1) return;
    const float* src = row_of(k);
#pragma unroll
    for (int d = 0; d < (AHEAD ? HD : 0); d += 4) {
      IO<float>::load4(src + d, nq + d);
      IO<float>::load4(src + C + d, nk + d);
      IO<float>::load4(src + 2 * C + d, nv + d);
    }
  };
  if (AHEAD) fetch(k0 + grp);
  for (int kb = k0; kb < k1; kb += ROW_GROUPS) {
    const int k = kb + grp;
    const bool active = k < k1;
    float q[HD];
    if (active) {
      const float* src = row_of(k);
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        float x[4], y[4], z[4];
        if constexpr (AHEAD) {
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = nq[d + u], y[u] = nk[d + u], z[u] = nv[d + u];
        } else {
          IO<float>::load4(src + d, x);
          IO<float>::load4(src + C + d, y);
          IO<float>::load4(src + 2 * C + d, z);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) q[d + u] = x[u] * scale;
        st4(k_s + i * HD + d, make_float4(y[0], y[1], y[2], y[3]));
        st4(v_s + i * HD + d, make_float4(z[0], z[1], z[2], z[3]));
      }
    }
    __syncthreads();  // the round's k, v (and, the first time, bias and mask) in place
    if (AHEAD) fetch(k + ROW_GROUPS);
    if (active) {
      float acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
      float s = 0.0f;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        const float4* k4 = reinterpret_cast<const float4*>(k_s + j * HD);
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < HD / 4; ++d) {
          const float4 kk = k4[d];
          dot = fmaf(q[4 * d], kk.x, dot);
          dot = fmaf(q[4 * d + 1], kk.y, dot);
          dot = fmaf(q[4 * d + 2], kk.z, dot);
          dot = fmaf(q[4 * d + 3], kk.w, dot);
        }
        float sim = dot + brow[j];
        if (MASK) sim += mrow[j];
        const float e = clipped_exp<float>(sim);
        s += e;
        const float4* v4 = reinterpret_cast<const float4*>(v_s + j * HD);
#pragma unroll
        for (int d = 0; d < HD / 4; ++d) {
          const float4 vv = v4[d];
          acc[4 * d] = fmaf(e, vv.x, acc[4 * d]);
          acc[4 * d + 1] = fmaf(e, vv.y, acc[4 * d + 1]);
          acc[4 * d + 2] = fmaf(e, vv.z, acc[4 * d + 2]);
          acc[4 * d + 3] = fmaf(e, vv.w, acc[4 * d + 3]);
        }
      }
      float* dst = out + (static_cast<size_t>(k) * n_mask + w) * N * C + static_cast<size_t>(i) * C + g * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4)
        st4(dst + d, make_float4(acc[d] / s, acc[d + 1] / s, acc[d + 2] / s, acc[d + 3] / s));
    }
    __syncthreads();  // the group's k, v rows free for the next round
  }
}

// One head's attention for the warp's 16 query rows m0 .. m0 + 15: q, k, v
// the staged slices (rows LDS apart), bias_h and mask_w 64 x BLD tiles
// (mask_w null without a mask), out the window's output at the head's first
// channel (rows C apart).
template <typename T, int HD, int LDS>
__device__ __forceinline__ void fwd_head(const T* q, const T* k, const T* v, const float* bias_h,
                                         const float* mask_w, T* out, int C, int m0,
                                         float scale_io) {
  constexpr int HK = HeadK<T, HD>::value, NO = (HD + 7) / 8;
  constexpr int KC = Bf16<T>::value ? FWD_BF16_KEYS : 16, KT = KC / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[2] = {0.0f, 0.0f};
  float o[NO][4];   // bf16: e v in mma.sync's layout
  float of[2][HD];  // fp32: this thread's keys' share of e v for rows g, g + 8
  float qa[2][HD];  // fp32: q of rows g, g + 8, scaled, for every chunk of keys
  zero_tiles(o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      of[hr][d] = 0.0f;
      if constexpr (!Bf16<T>::value) qa[hr][d] = q[(m0 + g + 8 * hr) * LDS + d] * scale_io;
    }
  }
  float sim[KT][4];  // a chunk's logits, then (fp32) its e
#pragma unroll
  for (int kc = 0; kc < N; kc += KC) {
    zero_tiles(sim);
    if constexpr (Bf16<T>::value) {
      // operands packed as they sit in the buffers; q scaled by a bf16 multiply
      // (the exact product rounded once, as round(q * scale) in fp32)
      const __nv_bfloat162 sc = __float2bfloat162_rn(scale_io);
      WarpMma<T, KT, HK>::run(
          sim,
          [&](int m, int kk) {
            if (kk >= HD) return 0u;
            const __nv_bfloat162 x =
                __hmul2(*reinterpret_cast<const __nv_bfloat162*>(q + (m0 + m) * LDS + kk), sc);
            return *reinterpret_cast<const uint32_t*>(&x);
          },
          [&](int kk, int n) {
            return kk < HD ? *reinterpret_cast<const uint32_t*>(k + (kc + n) * LDS + kk) : 0u;
          });
    } else {
      // this thread's keys kc + 8 j + 2 t + u, each k row read as float4s
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const T* kr = k + (kc + 8 * j + 2 * t + u) * LDS;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 kk = ld4(kr + d);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& x = sim[j][2 * hr + u];
              x = fmaf(qa[hr][d], kk.x, x);
              x = fmaf(qa[hr][d + 1], kk.y, x);
              x = fmaf(qa[hr][d + 2], kk.z, x);
              x = fmaf(qa[hr][d + 3], kk.w, x);
            }
          }
        }
      }
    }
    uint32_t ep[KT][2];  // bf16: e of rows g and g + 8, packed (the A fragments of e v)
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = kc + 8 * j + 2 * t;
        const float2 b2 = *reinterpret_cast<const float2*>(bias_h + r * BLD + c);
        float x0 = sim[j][2 * hr] + b2.x, x1 = sim[j][2 * hr + 1] + b2.y;
        if (mask_w) {
          const float2 m2 = *reinterpret_cast<const float2*>(mask_w + r * BLD + c);
          x0 += m2.x;
          x1 += m2.y;
        }
        if constexpr (Bf16<T>::value) {  // e rounded as it is packed
          ep[j][hr] = pack_bf16(clipped_exp<T>(x0), clipped_exp<T>(x1));
          s[hr] += bf16_lo(ep[j][hr]) + bf16_hi(ep[j][hr]);
        } else {
          sim[j][2 * hr] = clipped_exp<T>(x0);
          sim[j][2 * hr + 1] = clipped_exp<T>(x1);
          s[hr] += sim[j][2 * hr] + sim[j][2 * hr + 1];
        }
      }
    }
    if constexpr (Bf16<T>::value) {
      // e v with e's accumulator tiles as the A fragments: tiles 2 kk and
      // 2 kk + 1 are keys kc + 16 kk .. kc + 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < KT / 2; ++kk) {
        const uint32_t a[4] = {ep[2 * kk][0], ep[2 * kk][1], ep[2 * kk + 1][0],
                               ep[2 * kk + 1][1]};
        const int key = kc + 16 * kk + 2 * t;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int n = 8 * j + g;
          const uint32_t b0 = n < HD ? packed_pair(v + key * LDS + n, LDS) : 0u;
          const uint32_t b1 = n < HD ? packed_pair(v + (key + 8) * LDS + n, LDS) : 0u;
          mma16(o[j], a, b0, b1);
        }
      }
    } else {
      // this thread's keys kc + 8 j + 2 t + u for rows g and g + 8
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const T* vr = v + (kc + 8 * j + 2 * t + u) * LDS;
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
  if constexpr (Bf16<T>::value) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        if (c < HD) put2(out + r * C + c, o[j][2 * hr] / s[hr], o[j][2 * hr + 1] / s[hr]);
      }
    }
  } else {
    // the four lanes of a row add their keys' sums; lane t stores dims
    // t HD / 4 .. (t + 1) HD / 4
    constexpr int PER = HD / 4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        of[hr][d] += __shfl_xor_sync(0xffffffffu, of[hr][d], 1);
        of[hr][d] += __shfl_xor_sync(0xffffffffu, of[hr][d], 2);
        if (d / PER == t) stf(out + (m0 + g + 8 * hr) * C + d, of[hr][d] / s[hr]);
      }
    }
  }
}

// grid: x = n_mask * chunks (window-in-image w, then chunk), y = head group.
// Window b = k * n_mask + w for k in [0, n_per): image-major flattening, so
// with a mask (n_mask = nW) every window of a block takes mask row w.
template <typename T, int HD, bool MASK>
__global__ void __launch_bounds__(fwd_threads<T>(HD), fwd_min_blocks<T>(HD))
window_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ out, int C,
                            int heads, int n_mask, int n_per, int wpb, float scale_io) {
  constexpr int HG = fwd_heads<T>(HD), THREADS = fwd_threads<T>(HD);
  constexpr int TEAMS = THREADS / TEAM, LDS = stage_ld<T>(HG * HD);
  constexpr int EL = static_cast<int>(sizeof(T));
  extern __shared__ float4 smem4[];
  float* bias_s = reinterpret_cast<float*>(smem4);     // HG x 64 x BLD
  float* mask_s = bias_s + HG * N * BLD;               // 64 x BLD, with a mask only
  T* stage = reinterpret_cast<T*>(mask_s + (MASK ? N * BLD : 0));  // 2 x (q, k, v) x 64 x LDS

  const int chunks = (n_per + wpb - 1) / wpb;
  const int w = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * wpb;
  const int k1 = min(k0 + wpb, n_per);
  const int h0 = blockIdx.y * HG, nh = min(HG, heads - h0);
  const int tid = threadIdx.x, team = tid / TEAM, m0 = 16 * ((tid / 32) % 4);

  for (int e = tid; e < nh * N * N / 4; e += THREADS) {
    const int hl = e / (N * N / 4), r = (e / (N / 4)) % N, c = 4 * (e % (N / 4));
    st4(bias_s + (hl * N + r) * BLD + c,
        __ldg(reinterpret_cast<const float4*>(bias + (static_cast<size_t>(h0 + hl) * N + r) * N + c)));
  }
  if (MASK) {
    for (int e = tid; e < N * N / 4; e += THREADS) {
      const int r = e / (N / 4), c = 4 * (e % (N / 4));
      st4(mask_s + r * BLD + c, __ldg(reinterpret_cast<const float4*>(
                                    mask + (static_cast<size_t>(w) * N + r) * N + c)));
    }
  }
  // the group's q, k, v columns of window k into stage buffer buf: 16-byte
  // copies where every row offset allows them, else 8-byte ones
  const int row_bytes = nh * HD * EL;
  const bool wide = (C * EL) % 16 == 0 && (h0 * HD * EL) % 16 == 0 && row_bytes % 16 == 0;
  const auto fetch = [&](int k, int buf) {
    const T* src = qkv + (static_cast<size_t>(k) * n_mask + w) * N * 3 * C + h0 * HD;
    T* dst = stage + buf * 3 * N * LDS;
    const int unit = wide ? 16 : 8, per_row = row_bytes / unit, step = unit / EL;
    for (int e = tid; e < 3 * N * per_row; e += THREADS) {
      const int a = e / (N * per_row), r = (e / per_row) % N, u = e % per_row;
      T* d = dst + (a * N + r) * LDS + u * step;
      const T* s = src + static_cast<size_t>(r) * 3 * C + a * C + u * step;
      if (wide)
        cp_async16(d, s);
      else
        cp_async8(d, s);
    }
    cp_async_commit();
  };

  if (k0 < k1) fetch(k0, 0);
  for (int k = k0; k < k1; ++k) {
    cp_async_wait();
    __syncthreads();  // window k staged for all; window k - 1's buffer free
    if (k + 1 < k1) fetch(k + 1, (k + 1 - k0) & 1);
    const T* q = stage + ((k - k0) & 1) * 3 * N * LDS;
    T* dst = out + (static_cast<size_t>(k) * n_mask + w) * N * C + h0 * HD;
    for (int hl = team; hl < nh; hl += TEAMS)
      fwd_head<T, HD, LDS>(q + hl * HD, q + N * LDS + hl * HD, q + 2 * N * LDS + hl * HD,
                           bias_s + hl * N * BLD, MASK ? mask_s : nullptr, dst + hl * HD, C, m0,
                           scale_io);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int head_ld(int hd) { return hd + 4; }

// Row stride of the backward's e and dsim tiles, in the I/O dtype (which
// holds round(e) and the rounded dsim exactly): 36 (mod 32) words in bf16,
// so that pair reads along rows and along columns are conflict-free.
template <typename T>
__host__ __device__ constexpr int ds_ld() {
  return Bf16<T>::value ? N + 8 : ELD;
}
// Bytes of a backward block: the head's bias tile and q (scaled), k, v,
// gout and round(gg) of one window's head (fp32); the e and dsim tiles and
// the next window's q, k, v and gout (I/O dtype).
template <typename T>
__host__ __device__ constexpr size_t bwd_smem_bytes(int hd) {
  return sizeof(float) * static_cast<size_t>(N * BLD + 5 * N * head_ld(hd)) +
         sizeof(T) * static_cast<size_t>(2 * N * ds_ld<T>() + 4 * N * hd);
}
// the launch bounds: blocks an SM keeps resident (hd 32's shared memory
// allows two)
__host__ __device__ constexpr int bwd_min_blocks(int hd) { return hd < 32 ? 3 : 2; }

// One window's q, k, v and gout columns of one head (64 x HD each, from
// rows 3C and C apart): copied by cp.async into a buffer in the I/O dtype
// (rows of HD values), then put into four 64 x head_ld(HD) fp32 tiles, q
// scaled by hd^-0.5 in the I/O dtype.
template <typename T, int HD>
struct HeadStage {
  static constexpr int EL = static_cast<int>(sizeof(T));
  static constexpr int UNIT = HD * EL < 16 ? 8 : 16;  // bytes a copy
  static constexpr int PER_ROW = HD * EL / UNIT, STEP = UNIT / EL;
  static constexpr int Q = HD / 4;

  static __device__ __forceinline__ void fetch(T* raw, const T* qkv_w, const T* gout_w, int C,
                                               int tid) {
    for (int e = tid; e < 4 * N * PER_ROW; e += TEAM) {
      const int a = e / (N * PER_ROW), t = (e / PER_ROW) % N, u = e % PER_ROW;
      const T* src = (a < 3 ? qkv_w + static_cast<size_t>(t) * 3 * C + a * C
                            : gout_w + static_cast<size_t>(t) * C) + u * STEP;
      T* dst = raw + (a * N + t) * HD + u * STEP;
      if constexpr (UNIT == 16) {
        cp_async16(dst, src);
      } else {
        cp_async8(dst, src);
      }
    }
    cp_async_commit();
  }

  static __device__ __forceinline__ void put(const T* raw, float* q_s, float scale_io, int tid) {
    for (int e = tid; e < 4 * N * Q; e += TEAM) {
      const int a = e / (N * Q), t = (e / Q) % N, c = 4 * (e % Q);
      float x[4];
      IO<T>::load4(raw + (a * N + t) * HD + c, x);
      const float mul = a == 0 ? scale_io : 1.0f;
      st4(q_s + (a * N + t) * head_ld(HD) + c,
          make_float4(IO<T>::round(x[0] * mul), IO<T>::round(x[1] * mul),
                      IO<T>::round(x[2] * mul), IO<T>::round(x[3] * mul)));
    }
  }
};

// Block (h, chunk) owns head h of windows chunk * per_block .. (+ per_block)
// and writes dq, dk, dv of that head for them and its dbias partial over
// them to slab `chunk` of dbias (chunks, heads, 64, 64).
template <typename T, int HD>
__global__ void __launch_bounds__(TEAM, bwd_min_blocks(HD))
window_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, const T* __restrict__ gout,
                            T* __restrict__ dqkv, float* __restrict__ dbias, int C, int nW,
                            int windows, int per_block, float scale_io, float scale) {
  constexpr int LH = head_ld(HD), HK = HeadK<T, HD>::value, NO = (HD + 7) / 8;
  extern __shared__ float4 smem4[];
  constexpr int DLD = ds_ld<T>();
  float* bias_s = reinterpret_cast<float*>(smem4);  // 64 x BLD
  float* q_s = bias_s + N * BLD;  // 64 x LH each: q scaled, k, v, gout, round(gg)
  float* k_s = q_s + N * LH;
  float* v_s = k_s + N * LH;
  float* d_s = v_s + N * LH;
  float* gg_s = d_s + N * LH;
  T* e_s = reinterpret_cast<T*>(gg_s + N * LH);     // 64 x DLD each: round(e), dsim
  T* ds_s = e_s + N * DLD;
  T* raw = ds_s + N * DLD;  // 4 x 64 x HD: the next window's q, k, v, gout

  const int h = blockIdx.x, heads = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (tid >> 5);
  const size_t LQ = 3 * static_cast<size_t>(C);
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  for (int e = tid; e < N * N / 4; e += TEAM) {
    const int r = e / (N / 4), c = 4 * (e % (N / 4));
    st4(bias_s + r * BLD + c, __ldg(reinterpret_cast<const float4*>(bias_h + r * N + c)));
  }
  float db[8][4];
  zero_tiles(db);
  const int w_begin = blockIdx.y * per_block;
  const int w_end = min(windows, w_begin + per_block);
  // the next window's inputs in flight while this one is worked on
  const auto fetch = [&](int win) {
    HeadStage<T, HD>::fetch(raw, qkv + static_cast<size_t>(win) * N * LQ + h * HD,
                            gout + static_cast<size_t>(win) * N * C + h * HD, C, tid);
  };
  if (w_begin < w_end) fetch(w_begin);
  cp_async_wait();
  __syncthreads();  // the bias tile and the first window's columns in place
  for (int win = w_begin; win < w_end; ++win) {
    T* dqkv_w = dqkv + static_cast<size_t>(win) * N * LQ + h * HD;
    HeadStage<T, HD>::put(raw, q_s, scale_io, tid);
    __syncthreads();
    if (win + 1 < w_end) fetch(win + 1);

    // the logits of the warp's query rows, once: e32 stays in registers
    // (negated outside the clip, where dsim is 0) and round(e) goes to the
    // e tile for dv; s sums round(e)
    float ev[8][4];
    zero_tiles(ev);
    WarpMma<T, 8, HK>::run(
        ev, [&](int m, int k) { return k < HD ? pair(q_s + (m0 + m) * LH + k) : zero2(); },
        [&](int k, int n) { return k < HD ? pair(k_s + n * LH + k) : zero2(); });
    const float* mask_w = mask ? mask + static_cast<size_t>(win % nW) * N * N : nullptr;
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        const float2 b2 = *reinterpret_cast<const float2*>(bias_s + r * BLD + c);
        float x0 = ev[j][2 * hr] + b2.x, x1 = ev[j][2 * hr + 1] + b2.y;
        if (mask_w) {
          const float2 m2 = __ldg(reinterpret_cast<const float2*>(mask_w + r * N + c));
          x0 += m2.x;
          x1 += m2.y;
        }
        const float e0 = clipped_exp<float>(x0), e1 = clipped_exp<float>(x1);  // expf
        ev[j][2 * hr] = fabsf(x0) < CLIP ? e0 : -e0;
        ev[j][2 * hr + 1] = fabsf(x1) < CLIP ? e1 : -e1;
        const float r0 = IO<T>::round(e0), r1 = IO<T>::round(e1);
        put2(e_s + r * DLD + c, r0, r1);
        s[hr] += r0 + r1;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 1);
      s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 2);
    }
    __syncwarp();
    // ctx = e v (bf16: round(e) packed from registers as the A fragments);
    // gg = gout / s; ds = -(gg . ctx) / s
    float ctx[NO][4];
    zero_tiles(ctx);
    if constexpr (Bf16<T>::value) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(fabsf(ev[2 * kk][0]), fabsf(ev[2 * kk][1])),
            pack_bf16(fabsf(ev[2 * kk][2]), fabsf(ev[2 * kk][3])),
            pack_bf16(fabsf(ev[2 * kk + 1][0]), fabsf(ev[2 * kk + 1][1])),
            pack_bf16(fabsf(ev[2 * kk + 1][2]), fabsf(ev[2 * kk + 1][3]))};
        const int key = 16 * kk + 2 * t;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int n = 8 * j + g;
          const float2 b0 = n < HD ? pair(v_s + key * LH + n, LH) : zero2();
          const float2 b1 = n < HD ? pair(v_s + (key + 8) * LH + n, LH) : zero2();
          mma16(ctx[j], a, pack_bf16(b0.x, b0.y), pack_bf16(b1.x, b1.y));
        }
      }
    } else {
      WarpMma<T, NO, N>::run(
          ctx, [&](int m, int k) { return pair(e_s + (m0 + m) * DLD + k); },
          [&](int k, int n) { return n < HD ? pair(v_s + k * LH + n, LH) : zero2(); });
    }
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
    // de = round(gg) v^T + ds; dsim = round(e32 de) inside the clip, kept in
    // ev and stored to the dsim tile for dk
    {
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
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float e32 = ev[j][2 * hr + u];
            ev[j][2 * hr + u] =
                e32 > 0.0f ? IO<T>::round(e32 * (de[j][2 * hr + u] + dsr[hr])) : 0.0f;
            db[j][2 * hr + u] += ev[j][2 * hr + u];
          }
          put2(ds_s + r * DLD + c, ev[j][2 * hr], ev[j][2 * hr + 1]);
        }
      }
    }
    __syncwarp();
    // dq = dsim k (bf16: dsim packed from registers as the A fragments),
    // scaled by hd^-0.5 (fp32) and rounded
    float dq[NO][4];
    zero_tiles(dq);
    if constexpr (Bf16<T>::value) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pack_bf16(ev[2 * kk][0], ev[2 * kk][1]),
                               pack_bf16(ev[2 * kk][2], ev[2 * kk][3]),
                               pack_bf16(ev[2 * kk + 1][0], ev[2 * kk + 1][1]),
                               pack_bf16(ev[2 * kk + 1][2], ev[2 * kk + 1][3])};
        const int key = 16 * kk + 2 * t;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int n = 8 * j + g;
          const float2 b0 = n < HD ? pair(k_s + key * LH + n, LH) : zero2();
          const float2 b1 = n < HD ? pair(k_s + (key + 8) * LH + n, LH) : zero2();
          mma16(dq[j], a, pack_bf16(b0.x, b0.y), pack_bf16(b1.x, b1.y));
        }
      }
    } else {
      WarpMma<T, NO, N>::run(
          dq, [&](int m, int k) { return pair(ds_s + (m0 + m) * DLD + k); },
          [&](int k, int n) { return n < HD ? pair(k_s + k * LH + n, LH) : zero2(); });
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        if (c < HD) put2(dqkv_w + r * LQ + c, dq[j][2 * hr] * scale, dq[j][2 * hr + 1] * scale);
      }
    }
    __syncthreads();
    // key rows m0 ..: dk = dsim^T q, dv = e^T round(gg)
    float dk[NO][4], dv[NO][4];
    zero_tiles(dk);
    zero_tiles(dv);
    WarpMma<T, NO, N>::run(
        dk, [&](int m, int k) { return pair(ds_s + k * DLD + m0 + m, DLD); },
        [&](int k, int n) { return n < HD ? pair(q_s + k * LH + n, LH) : zero2(); });
    WarpMma<T, NO, N>::run(
        dv, [&](int m, int k) { return pair(e_s + k * DLD + m0 + m, DLD); },
        [&](int k, int n) { return n < HD ? pair(gg_s + k * LH + n, LH) : zero2(); });
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
        if (c < HD) {
          put2(dqkv_w + C + r * LQ + c, dk[j][2 * hr], dk[j][2 * hr + 1]);
          put2(dqkv_w + 2 * C + r * LQ + c, dv[j][2 * hr], dv[j][2 * hr + 1]);
        }
      }
    }
    cp_async_wait();
    __syncthreads();  // the tiles free, the next window's columns in place
  }
  float* part = dbias + (static_cast<size_t>(blockIdx.y) * heads + h) * N * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + g + 8 * hr, c = 8 * j + 2 * t;
      put2(part + r * N + c, db[j][2 * hr], db[j][2 * hr + 1]);
    }
  }
}

// dbias[i] = the sum over the `slabs` slabs dbias[c * n + i], in a fixed
// order: DBIAS_PARTS contiguous ranges of slabs each summed in slab order by
// its own thread, then the ranges' sums added in order.  Each element's
// slabs are read and its sum written by one block, so the sum may replace
// slab 0 in place.
__global__ void __launch_bounds__(DBIAS_THREADS)
window_attention_dbias_kernel(float* dbias, int n, int slabs) {
  constexpr int COLS = DBIAS_THREADS / DBIAS_PARTS;
  __shared__ float part_s[DBIAS_PARTS][COLS];
  const int col = threadIdx.x % COLS, part = threadIdx.x / COLS;
  const int i = blockIdx.x * COLS + col;
  const int span = (slabs + DBIAS_PARTS - 1) / DBIAS_PARTS;
  const int c0 = part * span, c1 = min(slabs, c0 + span);
  float v = 0.0f;
  if (i < n) {
    int c = c0;
#pragma unroll 1
    for (; c + 8 <= c1; c += 8) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = dbias[static_cast<size_t>(c + u) * n + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) v += x[u];
    }
    for (; c < c1; ++c) v += dbias[static_cast<size_t>(c) * n + i];
  }
  part_s[part][col] = v;
  __syncthreads();
  if (part == 0 && i < n) {
    float sum = part_s[0][col];
#pragma unroll
    for (int p = 1; p < DBIAS_PARTS; ++p) sum += part_s[p][col];
    dbias[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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

// A launch's plan, from the shapes alone (ops/window_attention.py's
// launch_plan computes the same numbers).
struct Plan {
  int grid_x, grid_y, threads, smem, heads_per_block, windows_per_block, blocks_per_sm, partials;
};

template <typename T, int HD, bool MASK>
Plan fwd_plan(const Args& a) {
  Plan p{};
  const int n_mask = MASK ? a.nW : 1, n_per = a.Bn / n_mask;
  p.heads_per_block = fwd_heads<T>(HD);
  const int groups = (a.heads + p.heads_per_block - 1) / p.heads_per_block;
  p.threads = fwd_threads<T>(HD);
  p.smem = static_cast<int>(fwd_smem_bytes<T>(HD, MASK));
  p.blocks_per_sm = smem_blocks(p.smem) < 2048 / p.threads ? smem_blocks(p.smem) : 2048 / p.threads;
  // chunks of windows: about FWD_WAVES blocks per SM slot, up to
  // FWD_MAX_WINDOWS windows a block, spread evenly (the row kernel: whole
  // rounds of ROW_GROUPS windows)
  const int unit = fwd_rows<T>(HD) ? ROW_GROUPS : 1;
  const long long slots = static_cast<long long>(SMS) * p.blocks_per_sm * FWD_WAVES;
  long long want = static_cast<long long>(n_mask) * n_per * groups / slots;
  want = want < unit ? unit : (want > FWD_MAX_WINDOWS ? FWD_MAX_WINDOWS : want / unit * unit);
  int chunks = static_cast<int>((n_per + want - 1) / want);
  p.windows_per_block = ((n_per + chunks - 1) / chunks + unit - 1) / unit * unit;
  chunks = (n_per + p.windows_per_block - 1) / p.windows_per_block;
  p.grid_x = n_mask * chunks;
  p.grid_y = groups;
  p.partials = 0;
  return p;
}

template <typename T, int HD>
Plan bwd_plan(const Args& a) {
  Plan p{};
  p.threads = TEAM;
  p.heads_per_block = 1;
  p.smem = static_cast<int>(bwd_smem_bytes<T>(HD));
  p.blocks_per_sm = smem_blocks(p.smem) < bwd_min_blocks(HD) ? smem_blocks(p.smem) : bwd_min_blocks(HD);
  // (heads, chunks) blocks: the card's slots filled once
  int chunks = SMS * p.blocks_per_sm / a.heads;
  chunks = chunks < 1 ? 1 : (chunks > a.Bn ? a.Bn : chunks);
  p.windows_per_block = (a.Bn + chunks - 1) / chunks;
  chunks = (a.Bn + p.windows_per_block - 1) / p.windows_per_block;
  p.grid_x = a.heads;
  p.grid_y = chunks;
  p.partials = chunks;
  return p;
}

// Raises Kernel's dynamic shared-memory limit to `smem` bytes (the same at
// every call for one instantiation) on the first call on each device.
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

struct Fwd {
  template <typename T, int HD, bool MASK>
  static cudaError_t run(const Args& a, cudaStream_t stream, Plan* plan) {
    const Plan p = fwd_plan<T, HD, MASK>(a);
    if (plan) {
      *plan = p;
      return cudaSuccess;
    }
    const int n_mask = MASK ? a.nW : 1;
    if constexpr (fwd_rows<T>(HD)) {
      constexpr auto kernel = window_attention_fwd_rows_kernel<HD, MASK>;
      const cudaError_t err = prepare<kernel>(p.smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
          static_cast<const float*>(a.qkv), static_cast<const float*>(a.bias),
          static_cast<const float*>(a.mask), static_cast<float*>(a.out), a.C, n_mask,
          a.Bn / n_mask, p.windows_per_block, a.scale_io);
    } else {
      constexpr auto kernel = window_attention_fwd_kernel<T, HD, MASK>;
      const cudaError_t err = prepare<kernel>(p.smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
          static_cast<const T*>(a.qkv), static_cast<const float*>(a.bias),
          static_cast<const float*>(a.mask), static_cast<T*>(a.out), a.C, a.heads, n_mask,
          a.Bn / n_mask, p.windows_per_block, a.scale_io);
    }
    return cudaGetLastError();
  }
};

struct Bwd {
  template <typename T, int HD, bool MASK>
  static cudaError_t run(const Args& a, cudaStream_t stream, Plan* plan) {
    const Plan p = bwd_plan<T, HD>(a);
    if (plan) {
      *plan = p;
      return cudaSuccess;
    }
    constexpr auto kernel = window_attention_bwd_kernel<T, HD>;
    cudaError_t err = prepare<kernel>(p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const float*>(a.bias),
        static_cast<const float*>(a.mask), static_cast<const T*>(a.gout),
        static_cast<T*>(a.out), static_cast<float*>(a.dbias), a.C, MASK ? a.nW : 1, a.Bn,
        p.windows_per_block, a.scale_io, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || p.partials == 1) return err;
    const int n = a.heads * N * N;
    const int cols = DBIAS_THREADS / DBIAS_PARTS;
    window_attention_dbias_kernel<<<(n + cols - 1) / cols, DBIAS_THREADS, 0, stream>>>(
        static_cast<float*>(a.dbias), n, p.partials);
    return cudaGetLastError();
  }
};

template <typename Op, typename T, bool MASK>
cudaError_t dispatch_hd(const Args& a, cudaStream_t stream, Plan* plan) {
  switch (a.C / a.heads) {
    case 4: return Op::template run<T, 4, MASK>(a, stream, plan);
    case 8: return Op::template run<T, 8, MASK>(a, stream, plan);
    case 16: return Op::template run<T, 16, MASK>(a, stream, plan);
    case 32: return Op::template run<T, 32, MASK>(a, stream, plan);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Op>
int dispatch(const Args& a, int is_bf16, void* stream, Plan* plan = nullptr) {
  if (a.heads <= 0 || a.C % a.heads != 0 || a.Bn <= 0 ||
      (a.mask && (a.nW <= 0 || a.Bn % a.nW != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = a.mask ? dispatch_hd<Op, __nv_bfloat16, true>(a, s, plan)
                 : dispatch_hd<Op, __nv_bfloat16, false>(a, s, plan);
  } else {
    err = a.mask ? dispatch_hd<Op, float, true>(a, s, plan)
                 : dispatch_hd<Op, float, false>(a, s, plan);
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
// dtype of qkv, scale_io = hd^-0.5 rounded to the I/O dtype and scale =
// hd^-0.5 in fp32.  dbias is fp32 (partials, heads, 64, 64), partials the
// plan's (dmh_window_attention_plan): each block of the backward writes its
// chunk's dbias to its slab, and a second launch sums the slabs in a fixed
// order into slab 0, which is then the gradient.
extern "C" int dmh_window_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                        const void* gout, void* dqkv, void* dbias, int Bn,
                                        int C, int heads, int nW, float scale_io, float scale,
                                        int is_bf16, void* stream) {
  const Args a{qkv, bias, mask, gout, dqkv, dbias, Bn, C, heads, nW, scale_io, scale};
  return dispatch<Bwd>(a, is_bf16, stream);
}

// The plan of a forward (backward = 0) or backward launch at these shapes
// (nW = 0: no mask), into out[8]: grid x, grid y, threads, dynamic shared
// memory bytes, heads per block, windows per block, blocks per SM by shared
// memory and the launch bounds, dbias partials.  Returns 0, or the error a
// launch would return.
extern "C" int dmh_window_attention_plan(int Bn, int C, int heads, int nW, int is_bf16,
                                         int backward, int* out) {
  const int dummy = 0;
  const Args a{&dummy, &dummy, nW > 0 ? &dummy : nullptr, &dummy, nullptr, nullptr,
               Bn, C, heads, nW, 1.0f, 1.0f};
  Plan p{};
  const int err = backward ? dispatch<Bwd>(a, is_bf16, nullptr, &p)
                           : dispatch<Fwd>(a, is_bf16, nullptr, &p);
  if (err == 0) {
    const int v[8] = {p.grid_x, p.grid_y, p.threads, p.smem, p.heads_per_block,
                      p.windows_per_block, p.blocks_per_sm, p.partials};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
  }
  return err;
}
