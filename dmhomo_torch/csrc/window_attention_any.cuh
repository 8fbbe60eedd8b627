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
// 16, hd 4-32) some 5 flops per fp32 byte, so HBM's 3.35 TB/s bounds it, and
// what keeps a kernel off that bound is the work around each logit (bias,
// mask, clip, exp, roundings) and the latency of short dependent phases.
//
// The design.  A warp owns a (window, head) pair whole: it walks the window's
// query rows 16 at a time (mma.sync's m16 tile) and, for each, its keys 16 at
// a time, so a 4x4 window (N = 16) is exactly one tile and nothing in a pair
// needs more than __syncwarp.  Rows and keys are zero-padded to a multiple of
// 16 (padded_tokens), the head dim to 4 (fp32), 8, 16, 32 or 64 (padded_hd,
// the template argument); a padded key adds e = 0 to the sums, never
// exp(clip(bias)), and no padded row is stored.
//  * A block owns a group of heads (heads_per_block: at N <= 16 the group's q
//    columns of a token make up to 128 bytes, or all heads where there are
//    at most 8 and they make at most twice that; one head above) and a chunk
//    of windows; warp w takes head w % heads_per_block and every
//    warps_per_head-th window of each stage.  A stage is the next windows'
//    q, k, v (and gout) columns of the group, copied by cp.async through L1
//    (16 bytes where every row offset allows, else 8 or 4; odd bf16 head
//    dims element by element; neighbouring threads on a head row, then on
//    the next tokens of one slice) into per-head [token][ld] slices, double-
//    buffered so that the next stage is in flight while this one is worked
//    on; one __syncthreads a stage.  The grid fills the card once, by shared
//    memory, threads and the registers the launch bounds allow (bound_blocks).
//  * bf16: every product on tensor cores, mma.sync m16n8k16 (m16n8k8 at hd
//    <= 8) with ldmatrix operands from the slices; e, dsim stay in registers
//    as the A fragments of e v and dsim k, round(gg) is written over gout in
//    place.  Every operand is a bf16 value already (the scaled q, k, v,
//    round(e), round(gg), round(dsim)); each MMA that adds to a sum over
//    more than one 16-chunk is taken from zero and added in fp32 (mma_add).
//  * fp32: the same layout with FMAs on CUDA cores (no TF32): the logits
//    from float4 rows of q and k, e v and dsim k as each thread's keys' share
//    of whole output rows, added over the four lanes of a row by a reduce-
//    scatter of shuffles that leaves each lane a quarter of the row to store
//    (float4s).  A thread per query row measured slower.  The
//    forward unrolls a warp's two windows of a stage, so that one's loads and
//    products overlap the other's.
//  * The backward per pair: the logits once per (row, key): e32 (negated
//    outside the clip) into the warp's fp32 tile, the row sums, e v, gg and
//    ds (round(gg) over gout); dv = e^T round(gg) by key tiles; de, dsim over
//    the tile in place, dq = dsim k; dk = dsim^T q by key tiles.  The tile
//    (padded_tokens^2 fp32) is the warp's own; at N = 144, hd = 64, fp32 the
//    slices and the tile of one warp take 230,976 of a block's 232,448 bytes.
//  * At N <= 16 a warp keeps its head's bias tile in registers for the whole
//    launch, and its sum with the mask row of the current window: a block's
//    consecutive windows share a mask row (slot t of its range is window
//    (t % n_per) nW + t / n_per, n_per = Bn / nW), so the row is read again
//    only where it changes.  Above 16 both are read per logit as float2s.
//
// dbias without atomics: each warp sums its windows' dsim in a fixed order,
// in registers at N <= 16 (written once at the end), else into its own region
// of device memory (read, added, written by the same lane each window), one
// slab per (chunk, warp of a head): partials = chunks * warps_per_head.  A
// second launch sums the slabs in a fixed order (reduce_kernel: a warp per
// element, lanes over the slabs, a fixed butterfly).  The same bits every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

// Everything here has internal linkage (an unnamed namespace): two libraries
// that include this header must not share a symbol, such as prepare()'s
// per-device flags, which the dynamic linker would otherwise unify across
// them and so skip the shared-memory limit of the second library's kernels.
namespace wa_any {
namespace {

constexpr int THREADS = 256;  // the reduction's blocks; the most an attention block takes
constexpr int MAX_WARPS = THREADS / 32;
constexpr int MAX_N = 144;  // 12 x 12 windows, the largest published Swin window
constexpr int MAX_HD = 64;
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM
constexpr int SMEM_PER_SM = 233472;
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int SMEM_RESERVED = 1024;  // bytes the card keeps per resident block
constexpr int GROUP_BYTES = 128;  // q (k, v) bytes per token a head group aims at, N <= 16
constexpr int TASKS_PER_WARP = 2;  // windows a warp takes per stage, N <= 16
constexpr int SMALL_SMEM = 65536;  // the shared memory a block aims under, N <= 16
constexpr int PLAN_FIELDS = 15;
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

// ---------------------------------------------------------------------------
// PTX helpers: asynchronous copies, ldmatrix, mma.sync (also used by
// swin_block_any.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// a BYTES (16, 8 or 4) asynchronous copy, through L1 (the rest of a sector
// is read by the neighbouring copies)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
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

// d += a . b, m16n8k8, bf16 inputs, fp32 accumulation
__device__ __forceinline__ void mma8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d += a . b with the 16 products summed by the tensor core from zero and
// the sum added in fp32, rounded to nearest.  Chaining the accumulator
// through the tensor core, whose additions truncate, moved the sums off the
// plain version's fp32 sums far enough to flip bf16 roundings downstream
// (the 1x1-window dbias, a sum that cancels, left its tolerance).
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(s, a, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += s[q];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// both halves of a packed bf16 pair times those of s (each product rounded once)
__device__ __forceinline__ uint32_t hmul2(uint32_t x, uint32_t s) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                             *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&r);
}

// n / d for n < 2^31, d >= 1, by a multiply (the round-up method).
struct FastDiv {
  unsigned d, m, s;
};

inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned quot(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

// ---------------------------------------------------------------------------
// The plan: how a launch goes, from the shapes alone
// (ops/window_attention.py::generic_launch_plan mirrors it)
// ---------------------------------------------------------------------------

struct Plan {
  int grid_x, grid_y;  // (chunks of windows, head groups)
  int threads;
  int smem;  // dynamic shared memory, bytes
  int windows_per_stage;  // warps_per_head * tasks_per_warp
  int windows_per_block;
  int blocks_per_sm;  // by shared memory, threads and the launch bounds' registers
  int partials;  // the backward's dbias slabs, chunks * warps_per_head; 0 for the forward
  int heads_per_block, warps_per_head, stages, tasks_per_warp;
  int padded_tokens, padded_hd, ld;  // the staged slices: [padded_tokens][ld] per head
};

__host__ __device__ constexpr int pad_tokens(int N) { return (N + 15) / 16 * 16; }
__host__ __device__ constexpr int pad_hd(int hd, int item) {
  return item == 4 && hd <= 4 ? 4 : hd <= 8 ? 8 : hd <= 16 ? 16 : hd <= 32 ? 32 : 64;
}
// Row stride (elements) of a staged slice: bf16 rows an odd number of 16-byte
// units (ldmatrix's eight row addresses on distinct bank groups); fp32 rows
// 4 (mod 32) floats past a multiple, so that the float4 reads of rows g are
// conflict-free (hd 4 and 64 unpadded).
__host__ __device__ constexpr int stage_ld(int hdp, int item) {
  return item == 2 ? ((hdp / 8) % 2 ? hdp : hdp + 8) : (hdp == 4 || hdp == 64 ? hdp : hdp + 4);
}
// Row stride (floats) of a warp's e32 / dsim tile: 4 (mod 16) for the
// transposed pair reads; unpadded where the padding would not fit (fp32, hd
// 64, N > 128).
__host__ __device__ constexpr int tile_ld(int np, int hdp, int item) {
  return item == 4 && hdp == 64 && np > 128 ? np : np + 4;
}

// Blocks of THREADS threads the launch bounds promise an SM at a padded head
// dim and I/O size, and the registers a thread may then take (allocated 8 at
// a time): three (80 registers) in bf16 and fp32 at hd <= 4, two (128) in
// fp32 at hd 5-16, where spilling cost more than the blocks gained; one
// above.  Measured at the window-4 sites in both directions.
__host__ __device__ constexpr int bound_blocks(int hdp, int item) {
  return hdp > 16 ? 1 : item == 2 || hdp <= 4 ? 3 : 2;
}
__host__ __device__ constexpr int reg_cap(int hdp, int item) {
  return bound_blocks(hdp, item) > 1 ? 65536 / (THREADS * bound_blocks(hdp, item)) / 8 * 8 : 256;
}

inline Plan make_plan(int Bn, int N, int hd, int heads, int item, bool backward) {
  Plan p{};
  p.padded_tokens = pad_tokens(N);
  p.padded_hd = pad_hd(hd, item);
  p.ld = stage_ld(p.padded_hd, item);
  const int np = p.padded_tokens;
  const bool small = np == 16;
  const long long task = (backward ? 4ll : 3ll) * np * p.ld * item;  // one head of one window
  const long long scratch = backward ? 4ll * (np * tile_ld(np, p.padded_hd, item) + np) : 0;
  int nh = small ? GROUP_BYTES / (hd * item) : 1;
  nh = nh < 1 ? 1 : nh > MAX_WARPS ? MAX_WARPS : nh;
  if (small && heads <= MAX_WARPS && heads <= 2 * nh) nh = heads;  // no group left half idle
  if (nh > heads) nh = heads;
  const int groups = (heads + nh - 1) / nh;
  nh = (heads + groups - 1) / groups;
  int R = MAX_WARPS / nh, tpw = small ? TASKS_PER_WARP : 1, stages = 2;
  const long long budget = small ? SMALL_SMEM : SMEM_PER_BLOCK;
  auto bytes = [&]() { return stages * static_cast<long long>(R) * tpw * nh * task + nh * R * scratch; };
  while (bytes() > budget) {
    if (tpw > 1)
      tpw = 1;
    else if (R > 1)
      R /= 2;
    else if (stages > 1)
      stages = 1;
    else
      break;
  }
  p.heads_per_block = nh;
  p.warps_per_head = R;
  p.tasks_per_warp = tpw;
  p.stages = stages;
  p.threads = 32 * nh * R;
  p.smem = static_cast<int>(bytes() > SMEM_PER_BLOCK ? SMEM_PER_BLOCK + 1 : bytes());  // > : no fit
  int per_sm = SMEM_PER_SM / (p.smem + SMEM_RESERVED);
  if (per_sm > 2048 / p.threads) per_sm = 2048 / p.threads;
  if (per_sm > 65536 / (reg_cap(p.padded_hd, item) * p.threads))
    per_sm = 65536 / (reg_cap(p.padded_hd, item) * p.threads);
  p.blocks_per_sm = per_sm;
  const int G = R * tpw;
  p.windows_per_stage = G;
  const long long rounds = (Bn + G - 1) / G;
  long long chunks = static_cast<long long>(SMS) * (per_sm < 1 ? 1 : per_sm) / groups;
  if (chunks < 1) chunks = 1;
  if (chunks > rounds) chunks = rounds;
  long long per = (Bn + chunks - 1) / chunks;
  per = (per + G - 1) / G * G;
  chunks = (Bn + per - 1) / per;
  p.windows_per_block = static_cast<int>(per);
  p.grid_x = static_cast<int>(chunks);
  p.grid_y = groups;
  p.partials = backward ? p.grid_x * R : 0;
  return p;
}

inline bool plan_fits(const Plan& p) { return p.smem <= SMEM_PER_BLOCK && p.blocks_per_sm >= 1; }

// Bytes a staging copy moves: the most of 16, 8, 4 that divides every row
// offset (element by element, 2, for odd bf16 head dims).
inline int copy_unit(int C, int hd, int item) {
  for (int u = 16; u >= 4; u /= 2)
    if ((hd * item) % u == 0 && (C * item) % u == 0) return u;
  return item;
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

struct KArgs {
  const void* qkv;  // (Bn, N, 3C)
  const void* gout;  // (Bn, N, C), backward
  void* out;  // forward: out (Bn, N, C); backward: dqkv (Bn, N, 3C)
  const float* bias;  // (heads, N, N)
  const float* mask;  // (nW, N, N) or null
  float* slabs;  // backward: (partials, heads, N, N)
  int Bn, N, C, hd, heads, nW, per_block;
  int n_per;  // Bn / nW: windows per mask row (Bn without a mask)
  int nh, R, tpw, stages, np, unit;
  FastDiv f_units, f_nh, f_tokens, f_nper;  // units a head row, heads a group, tokens, n_per
  float scale_io, scale;
  int pair_ok;  // C and hd even: outputs stored two elements at a time
  int vec;  // fp32 row quarters: 4 (C, hd multiples of 4: float4 stores), 2 (pair_ok), 1
};

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// v0 to p[0] and, where n > 1, v1 to p[1]: one two-element store where pair
__device__ __forceinline__ void put(float* p, float v0, float v1, int n, bool pair) {
  if (n > 1 && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  if (n > 0) p[0] = v0;
  if (n > 1) p[1] = v1;
}
__device__ __forceinline__ void put(__nv_bfloat16* p, float v0, float v1, int n, bool pair) {
  if (n > 1 && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (n > 0) p[0] = __float2bfloat16_rn(v0);
  if (n > 1) p[1] = __float2bfloat16_rn(v1);
}

// Elements (row, key) and (row, key + 1) of an N x N fp32 matrix, 0 past N
// (key even; even: N even, so that both lie inside together, 8-byte aligned).
__device__ __forceinline__ float2 pair_at(const float* m, int row, int key, int N, bool even) {
  if (row >= N || key >= N) return make_float2(0.0f, 0.0f);
  const float* p = m + row * N + key;
  if (even) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), key + 1 < N ? __ldg(p + 1) : 0.0f);
}

// exp(clip(v, +-60)): expf; for the bf16 forward, whose e is rounded to 8
// bits, ex2.approx of the clipped value times log2(e) (relative error about
// 2^-22 plus |v| 2^-24, against bf16's 2^-9).
template <bool APPROX>
__device__ __forceinline__ float clipped_exp(float v) {
  const float x = fminf(fmaxf(v, -CLIP), CLIP);
  if constexpr (APPROX) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  } else {
    return expf(x);
  }
}

// acc[j][q] = sum over d of A[16 rt + g + 8 (q / 2)][d] s . B[16 kc + 8 j + 2 t + q % 2][d]:
// a 16 x 16 block of the product of two staged slices ([row][LD], zero past
// hd and past N), A scaled by s in the I/O dtype (q by hd^-0.5; round(gg) by 1).
template <typename T, int HDP>
__device__ __forceinline__ void block16(float (&acc)[2][4], const T* A, const T* B, int rt, int kc,
                                        float s) {
  constexpr int LD = stage_ld(HDP, sizeof(T));
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  if constexpr (kBf16<T>) {
    const uint32_t sc = pack_bf16(s, s);
    if constexpr (HDP == 8) {
      uint32_t a[2], b[2];
      ldsm_x2(a, A + (16 * rt + (lane & 15)) * LD);
      ldsm_x2(b, B + (16 * kc + (lane & 15)) * LD);
      a[0] = hmul2(a[0], sc);
      a[1] = hmul2(a[1], sc);
      mma8(acc[0], a[0], a[1], b[0]);
      mma8(acc[1], a[0], a[1], b[1]);
    } else {
#pragma unroll
      for (int ks = 0; ks < HDP / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, A + (16 * rt + (lane & 15)) * LD + 16 * ks + 8 * (lane >> 4));
        ldsm_x4(b, B + (16 * kc + 8 * (lane >> 4) + (lane & 7)) * LD + 16 * ks +
                       8 * ((lane >> 3) & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = hmul2(a[i], sc);
        if (ks == 0) {
          mma(acc[0], a, b[0], b[1]);
          mma(acc[1], a, b[2], b[3]);
        } else {
          mma_add(acc[0], a, b[0], b[1]);
          mma_add(acc[1], a, b[2], b[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < HDP; d += 4) {
      float4 qa[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        qa[hr] = ld4(A + (16 * rt + g + 8 * hr) * LD + d);
        qa[hr].x *= s, qa[hr].y *= s, qa[hr].z *= s, qa[hr].w *= s;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float4 kk = ld4(B + (16 * kc + 8 * j + 2 * t + u) * LD + d);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float& x = acc[j][2 * hr + u];
            x = fmaf(qa[hr].x, kk.x, x);
            x = fmaf(qa[hr].y, kk.y, x);
            x = fmaf(qa[hr].z, kk.z, x);
            x = fmaf(qa[hr].w, kk.w, x);
          }
        }
      }
    }
  }
}

// bf16: o[n][q] += sum over the 16 keys of chunk kc of x(row g + 8 (q / 2),
// key) . B[16 kc + key][8 n + 2 t + q % 2], x given in block16's layout
// (rounded to bf16 as it is packed: the A fragments), B a staged slice read
// transposed by ldmatrix; the chunk's sum added in fp32 (mma_add).
template <int HDP>
__device__ __forceinline__ void rows_times_bf16(float (&o)[HDP / 8][4], const float (&x)[2][4],
                                                const __nv_bfloat16* B, int kc) {
  constexpr int LD = stage_ld(HDP, 2);
  const int lane = threadIdx.x & 31;
  const uint32_t a[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                         pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
  if constexpr (HDP == 8) {
    uint32_t b[2];
    ldsm_x2_trans(b, B + (16 * kc + (lane & 15)) * LD);
    mma_add(o[0], a, b[0], b[1]);
  } else {
#pragma unroll
    for (int n = 0; n < HDP / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, B + (16 * kc + 8 * ((lane >> 3) & 1) + (lane & 7)) * LD + 8 * n +
                           8 * (lane >> 4));
      mma_add(o[n], a, b[0], b[1]);
      mma_add(o[n + 1], a, b[2], b[3]);
    }
  }
}

// fp32: of[hr][d] += sum over this thread's keys 16 kc + 8 j + 2 t + u of
// x[j][2 hr + u] B[key][d] (rows g + 8 hr); the four lanes of a row add
// their shares afterwards (quad_sum).
template <int HDP>
__device__ __forceinline__ void rows_times_f32(float (&of)[2][HDP], const float (&x)[2][4],
                                               const float* B, int kc) {
  constexpr int LD = stage_ld(HDP, 4);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* row = B + (16 * kc + 8 * j + 2 * t + u) * LD;
#pragma unroll
      for (int d = 0; d < HDP; d += 4) {
        const float4 bb = ld4(row + d);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float e = x[j][2 * hr + u];
          of[hr][d] = fmaf(e, bb.x, of[hr][d]);
          of[hr][d + 1] = fmaf(e, bb.y, of[hr][d + 1]);
          of[hr][d + 2] = fmaf(e, bb.z, of[hr][d + 2]);
          of[hr][d + 3] = fmaf(e, bb.w, of[hr][d + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// o[n][q] += sum over the query rows r of chunk kq of X[r][16 kt + g + 8 (q /
// 2)] . B[r][8 n + 2 t + q % 2]: a key tile of a product with the transpose
// of a warp's fp32 tile X (e32 for dv, |.| rounded; dsim for dk), B a staged
// slice scaled by s (q by hd^-0.5 for dk).  bf16 on tensor cores, each
// chunk's sum added in fp32; fp32 by FMAs in the same layout.
template <typename T, int HDP, bool E>
__device__ __forceinline__ void cols_times(float (&o)[(HDP + 7) / 8][4], const float* X, int tld,
                                           const T* B, int kt, int kq, float s) {
  constexpr int LD = stage_ld(HDP, sizeof(T));
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto x = [&](int r, int c) {
    const float v = X[r * tld + c];
    return E ? fabsf(v) : v;
  };
  if constexpr (kBf16<T>) {
    const int r0 = 16 * kq + 2 * t, c0 = 16 * kt + g;
    const uint32_t a[4] = {pack_bf16(x(r0, c0), x(r0 + 1, c0)),
                           pack_bf16(x(r0, c0 + 8), x(r0 + 1, c0 + 8)),
                           pack_bf16(x(r0 + 8, c0), x(r0 + 9, c0)),
                           pack_bf16(x(r0 + 8, c0 + 8), x(r0 + 9, c0 + 8))};
    const uint32_t sc = pack_bf16(s, s);
    if constexpr (HDP == 8) {
      uint32_t b[2];
      ldsm_x2_trans(b, B + (16 * kq + (lane & 15)) * LD);
      mma_add(o[0], a, hmul2(b[0], sc), hmul2(b[1], sc));
    } else {
#pragma unroll
      for (int n = 0; n < HDP / 8; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, B + (16 * kq + 8 * ((lane >> 3) & 1) + (lane & 7)) * LD + 8 * n +
                             8 * (lane >> 4));
        mma_add(o[n], a, hmul2(b[0], sc), hmul2(b[1], sc));
        mma_add(o[n + 1], a, hmul2(b[2], sc), hmul2(b[3], sc));
      }
    }
  } else {
    constexpr int NO = (HDP + 7) / 8;
#pragma unroll 4
    for (int k = 16 * kq; k < 16 * kq + 16; k += 2) {
      const float a0x = x(k, 16 * kt + g), a0y = x(k + 1, 16 * kt + g);
      const float a1x = x(k, 16 * kt + g + 8), a1y = x(k + 1, 16 * kt + g + 8);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = 8 * j + 2 * t + u;
          const float bx = n < HDP ? B[k * LD + n] * s : 0.0f;
          const float by = n < HDP ? B[(k + 1) * LD + n] * s : 0.0f;
          o[j][u] = fmaf(a0y, by, fmaf(a0x, bx, o[j][u]));
          o[j][2 + u] = fmaf(a1y, by, fmaf(a1x, bx, o[j][2 + u]));
        }
      }
    }
  }
}

template <int M>
__device__ __forceinline__ void zero_tiles(float (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
}

// Stores an m16 x 8NO tile o (mma.sync's accumulator layout) times mul to
// rows 16 m0 + g (+ 8) of dst (rows `stride` apart), columns < hd, rows < N.
template <typename T, int NO>
__device__ __forceinline__ void store_tile(T* dst, long long stride, const float (&o)[NO][4],
                                           const float (&mul)[2], int m0, int N, int hd,
                                           bool pair) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = 16 * m0 + g + 8 * hr;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * t;
      put(dst + row * stride + c, o[n][2 * hr] * mul[hr], o[n][2 * hr + 1] * mul[hr], hd - c,
          pair);
    }
  }
}

// fp32: the four lanes of a row add their shares of rows g, g + 8 (of) so
// that lane t ends with columns t HDP / 4 .. (t + 1) HDP / 4 of the sums
// (oq): half the columns across lanes t ^ 2, then half of those across t ^ 1.
template <int HDP>
__device__ __forceinline__ void quad_scatter(const float (&of)[2][HDP],
                                             float (&oq)[2][HDP / 4]) {
  constexpr int H = HDP / 2, Q = HDP / 4;
  const int t = threadIdx.x & 3;
  const bool hi = t & 2, odd = t & 1;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float x[H];
#pragma unroll
    for (int d = 0; d < H; ++d) {
      const float mine = hi ? of[hr][H + d] : of[hr][d];
      const float other = hi ? of[hr][d] : of[hr][H + d];
      x[d] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
    }
#pragma unroll
    for (int d = 0; d < Q; ++d) {
      const float mine = odd ? x[Q + d] : x[d];
      const float other = odd ? x[d] : x[Q + d];
      oq[hr][d] = mine + __shfl_xor_sync(0xffffffffu, other, 1);
    }
  }
}

// fp32: stores lane t's quarter oq of rows g, g + 8 of row tile m0, each
// value divided by den (divide) or times it, to dst (rows `stride` apart),
// rows < N, columns < hd; vectors where the quarter lies whole inside hd
// (vec: 2 = float2 stores allowed, 4 = float4 as well).
template <int HDP>
__device__ __forceinline__ void store_quarter(float* dst, long long stride,
                                              const float (&oq)[2][HDP / 4],
                                              const float (&den)[2], bool divide, int m0, int N,
                                              int hd, int vec) {
  constexpr int Q = HDP / 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = t * Q;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = 16 * m0 + g + 8 * hr;
    if (row >= N) continue;
    float v[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) v[i] = divide ? oq[hr][i] / den[hr] : oq[hr][i] * den[hr];
    float* p = dst + row * stride + c0;
    if (c0 + Q <= hd && Q % 4 == 0 && vec >= 4) {
#pragma unroll
      for (int i = 0; i < Q; i += 4)
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else if (c0 + Q <= hd && Q % 2 == 0 && vec >= 2) {
#pragma unroll
      for (int i = 0; i < Q; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i)
        if (c0 + i < hd) p[i] = v[i];
    }
  }
}

// The forward of one (window, head): q, k, v the staged slices; out the
// window's output at the head's first channel (rows C apart).
template <typename T, int HDP>
__device__ __forceinline__ void forward_pair(const T* q, const T* k, const T* v, T* out,
                                             const float (&bm)[2][4], const float* bias_h,
                                             const float* mask_w, const KArgs& a) {
  constexpr int NO = (HDP + 7) / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int N = a.N, chunks = a.np / 16;
  const bool even = (N & 1) == 0;
#pragma unroll 1
  for (int rt = 0; rt < chunks; ++rt) {
    float rs[2] = {0.0f, 0.0f};
    float o[NO][4];
    float of[2][kBf16<T> ? 1 : HDP];
    zero_tiles(o);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int d = 0; d < (kBf16<T> ? 1 : HDP); ++d) of[hr][d] = 0.0f;
#pragma unroll 1
    for (int kc = 0; kc < chunks; ++kc) {
      float s[2][4];
      block16<T, HDP>(s, q, k, rt, kc, a.scale_io);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * rt + g + 8 * hr, key = 16 * kc + 8 * j + 2 * t;
          const float2 b2 = chunks == 1 ? make_float2(bm[j][2 * hr], bm[j][2 * hr + 1])
                                        : pair_at(bias_h, row, key, N, even);
          float x0 = s[j][2 * hr] + b2.x, x1 = s[j][2 * hr + 1] + b2.y;
          if (mask_w && chunks > 1) {
            const float2 m2 = pair_at(mask_w, row, key, N, even);
            x0 += m2.x;
            x1 += m2.y;
          }
          const bool in = row < N;
          const float e0 = in && key < N ? round_to<T>(clipped_exp<kBf16<T>>(x0)) : 0.0f;
          const float e1 = in && key + 1 < N ? round_to<T>(clipped_exp<kBf16<T>>(x1)) : 0.0f;
          s[j][2 * hr] = e0;
          s[j][2 * hr + 1] = e1;
          rs[hr] += e0 + e1;  // e0 and e1 hold bf16 values: packing them again is exact
        }
      }
      if constexpr (kBf16<T>)
        rows_times_bf16<HDP>(o, s, v, kc);
      else
        rows_times_f32<HDP>(of, s, v, kc);
    }
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) inv[hr] = quad_sum(rs[hr]);
    if constexpr (kBf16<T>) {
      // out = round(o / s), o times 1 / s rounded to nearest: within an fp32
      // ulp of the quotient, far below bf16's rounding
      const float rcp[2] = {__frcp_rn(inv[0]), __frcp_rn(inv[1])};
      store_tile<T, NO>(out, a.C, o, rcp, rt, N, a.hd, a.pair_ok);
    } else {
      float oq[2][HDP / 4];
      quad_scatter<HDP>(of, oq);
      store_quarter<HDP>(reinterpret_cast<float*>(out), a.C, oq, inv, true, rt, N, a.hd, a.vec);
    }
  }
}

// The backward of one (window, head): q, k, v, go the staged slices (go, the
// gradient of out, becomes round(gg) in place); et the warp's fp32 tile and
// rd its rows' ds; dq the window's dqkv at the head's first q channel (rows
// 3C apart); db the warp's dbias in registers (N <= 16), else slab its region
// of device memory for this head.
template <typename T, int HDP>
__device__ __forceinline__ void backward_pair(const T* q, const T* k, const T* v, T* go,
                                              float* et, float* rd, T* dq, float (&db)[2][4],
                                              float* slab, const float (&bm)[2][4],
                                              const float* bias_h, const float* mask_w,
                                              const KArgs& a) {
  constexpr int LD = stage_ld(HDP, sizeof(T));
  constexpr int NO = (HDP + 7) / 8;
  constexpr int FH = kBf16<T> ? 1 : HDP;  // fp32 whole-row accumulators
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int N = a.N, chunks = a.np / 16, hd = a.hd;
  const int tld = tile_ld(a.np, HDP, sizeof(T));
  const long long C3 = 3ll * a.C;
  const bool even = (N & 1) == 0;
  // A: the logits once: e32 to the tile (negated outside the clip, 0 past
  // N), s, ctx = e v, gg = gout / s, ds = -(gg . ctx) / s; round(gg) over gout
#pragma unroll 1
  for (int rt = 0; rt < chunks; ++rt) {
    float rs[2] = {0.0f, 0.0f};
    float o[NO][4];
    float of[2][FH];
    zero_tiles(o);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int d = 0; d < FH; ++d) of[hr][d] = 0.0f;
#pragma unroll 1
    for (int kc = 0; kc < chunks; ++kc) {
      float s[2][4];
      block16<T, HDP>(s, q, k, rt, kc, a.scale_io);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * rt + g + 8 * hr, key = 16 * kc + 8 * j + 2 * t;
          const float2 b2 = chunks == 1 ? make_float2(bm[j][2 * hr], bm[j][2 * hr + 1])
                                        : pair_at(bias_h, row, key, N, even);
          float x[2] = {s[j][2 * hr] + b2.x, s[j][2 * hr + 1] + b2.y};
          if (mask_w && chunks > 1) {
            const float2 m2 = pair_at(mask_w, row, key, N, even);
            x[0] += m2.x;
            x[1] += m2.y;
          }
          float sv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const bool valid = row < N && key + u < N;
            const float e32 = valid ? clipped_exp<false>(x[u]) : 0.0f;
            sv[u] = fabsf(x[u]) < CLIP ? e32 : -e32;
            s[j][2 * hr + u] = e32;
            rs[hr] += round_to<T>(e32);
          }
          *reinterpret_cast<float2*>(et + row * tld + key) = make_float2(sv[0], sv[1]);
        }
      }
      if constexpr (kBf16<T>)
        rows_times_bf16<HDP>(o, s, v, kc);
      else
        rows_times_f32<HDP>(of, s, v, kc);
    }
    float srow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      srow[hr] = quad_sum(rs[hr]);
      if (16 * rt + g + 8 * hr >= N) srow[hr] = 1.0f;  // a padded row: gg = 0, ds = 0
    }
    float dot[2] = {0.0f, 0.0f};
    if constexpr (kBf16<T>) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
              go + (16 * rt + g + 8 * hr) * LD + 8 * n + 2 * t);
          const float2 gv = __bfloat1622float2(*p);
          const float g0 = gv.x / srow[hr], g1 = gv.y / srow[hr];
          dot[hr] = fmaf(g1, o[n][2 * hr + 1], fmaf(g0, o[n][2 * hr], dot[hr]));
          *p = __floats2bfloat162_rn(g0, g1);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) dot[hr] = quad_sum(dot[hr]);
    } else {
      // lane t: its quarter of ctx, gg (written over gout) and of gg . ctx
      float cq[2][FH / 4];
      quad_scatter<FH>(of, cq);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* grow = reinterpret_cast<float*>(go) + (16 * rt + g + 8 * hr) * LD + t * (FH / 4);
#pragma unroll
        for (int i = 0; i < FH / 4; ++i) {
          const float gv = grow[i] / srow[hr];
          dot[hr] = fmaf(gv, cq[hr][i], dot[hr]);
          grow[i] = gv;
        }
        dot[hr] = quad_sum(dot[hr]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) rd[16 * rt + g + 8 * hr] = -dot[hr] / srow[hr];
    }
  }
  __syncwarp();
  // B: dv = e^T round(gg), by key tiles
#pragma unroll 1
  for (int kt = 0; kt < chunks; ++kt) {
    float o[NO][4];
    zero_tiles(o);
#pragma unroll 1
    for (int kq = 0; kq < chunks; ++kq) cols_times<T, HDP, true>(o, et, tld, go, kt, kq, 1.0f);
    const float one[2] = {1.0f, 1.0f};
    store_tile<T, NO>(dq + 2 * a.C, C3, o, one, kt, N, hd, a.pair_ok);
  }
  __syncwarp();
  // C: de = round(gg) v^T + ds, dsim = round(e32 de) inside the clip (over
  // the tile), dbias, dq = round((dsim k) hd^-0.5)
#pragma unroll 1
  for (int rt = 0; rt < chunks; ++rt) {
    float o[NO][4];
    float of[2][FH];
    zero_tiles(o);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int d = 0; d < FH; ++d) of[hr][d] = 0.0f;
    const float ds[2] = {rd[16 * rt + g], rd[16 * rt + g + 8]};
#pragma unroll 1
    for (int kc = 0; kc < chunks; ++kc) {
      float de[2][4];
      block16<T, HDP>(de, go, v, rt, kc, 1.0f);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * rt + g + 8 * hr, key = 16 * kc + 8 * j + 2 * t;
          float2* p = reinterpret_cast<float2*>(et + row * tld + key);
          const float2 e2 = *p;
          const float d0 = e2.x > 0.0f ? round_to<T>(e2.x * (de[j][2 * hr] + ds[hr])) : 0.0f;
          const float d1 = e2.y > 0.0f ? round_to<T>(e2.y * (de[j][2 * hr + 1] + ds[hr])) : 0.0f;
          *p = make_float2(d0, d1);
          de[j][2 * hr] = d0;
          de[j][2 * hr + 1] = d1;
          if (chunks == 1) {
            db[j][2 * hr] += d0;
            db[j][2 * hr + 1] += d1;
          } else if (row < N && key < N) {
            slab[row * N + key] += d0;
            if (key + 1 < N) slab[row * N + key + 1] += d1;
          }
        }
      }
      if constexpr (kBf16<T>)
        rows_times_bf16<HDP>(o, de, k, kc);
      else
        rows_times_f32<HDP>(of, de, k, kc);
    }
    const float sc[2] = {a.scale, a.scale};
    if constexpr (kBf16<T>) {
      store_tile<T, NO>(dq, C3, o, sc, rt, N, hd, a.pair_ok);
    } else {
      float oq[2][FH / 4];
      quad_scatter<FH>(of, oq);
      store_quarter<FH>(reinterpret_cast<float*>(dq), C3, oq, sc, false, rt, N, hd, a.vec);
    }
  }
  __syncwarp();
  // D: dk = dsim^T q, by key tiles
#pragma unroll 1
  for (int kt = 0; kt < chunks; ++kt) {
    float o[NO][4];
    zero_tiles(o);
#pragma unroll 1
    for (int kq = 0; kq < chunks; ++kq)
      cols_times<T, HDP, false>(o, et, tld, q, kt, kq, a.scale_io);
    const float one[2] = {1.0f, 1.0f};
    store_tile<T, NO>(dq + a.C, C3, o, one, kt, N, hd, a.pair_ok);
  }
  __syncwarp();  // the tile free for the next pair
}

// Both kernels: block (chunk, head group) walks its windows a stage at a
// time; warp w takes head w % nh and windows w / nh + R i of each stage.
template <typename T, int HDP, bool BWD>
__device__ __forceinline__ void attention_blocks(const KArgs& a) {
  constexpr int IT = sizeof(T);
  constexpr int LD = stage_ld(HDP, IT);
  constexpr int ARRAYS = BWD ? 4 : 3;
  extern __shared__ float4 smem4[];
  T* stage = reinterpret_cast<T*>(smem4);
  const int np = a.np;
  const int arr_elems = np * LD;  // one slice
  const int task_elems = ARRAYS * arr_elems;
  const int G = a.R * a.tpw;
  const int slot = G * a.nh * task_elems;  // elements of a stage
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, g = lane >> 2, t = lane & 3;
  const int hl = wid % a.nh, r = wid / a.nh;
  const int h0 = blockIdx.y * a.nh;
  const int nh_act = a.heads - h0 < a.nh ? a.heads - h0 : a.nh;
  const int h = h0 + hl;
  const bool active = hl < nh_act;
  const int begin = blockIdx.x * a.per_block;  // slots of the block's range
  const int end = begin + a.per_block < a.Bn ? begin + a.per_block : a.Bn;
  const int N = a.N, chunks = np / 16;
  float* tile = reinterpret_cast<float*>(stage + a.stages * slot) +
                wid * (np * tile_ld(np, HDP, IT) + np);  // the backward's per-warp tile, then ds
  const float* bias_h = a.bias + static_cast<long long>(active ? h : 0) * N * N;
  float* slab = BWD && active
                    ? a.slabs + ((static_cast<long long>(blockIdx.x) * a.R + r) * a.heads + h) * N * N
                    : nullptr;

  // padding stays zero: the copies write only the tokens and columns that
  // exist (nothing to clear where N and hd fill the padded sizes; the
  // columns past the padded hd are never read)
  if (N < np || a.hd < HDP) {
    uint32_t* z = reinterpret_cast<uint32_t*>(stage);
    const int words = a.stages * slot * IT / 4;
    for (int i = tid; i < words; i += blockDim.x) z[i] = 0u;
  }
  // N <= 16: bm = the head's bias tile plus the mask row of the current
  // window, in registers (the rows change rarely: slot t of the block's range
  // takes window (t % n_per) nW + t / n_per, mask row t / n_per)
  float bm[2][4], db[2][4];
  int mrow = -1;
  zero_tiles(db);
  const auto load_bm = [&](const float* mask_w) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = g + 8 * hr, key = 8 * j + 2 * t;
        float2 b2 = pair_at(bias_h, row, key, N, (N & 1) == 0);
        if (mask_w) {
          const float2 m2 = pair_at(mask_w, row, key, N, (N & 1) == 0);
          b2.x += m2.x;
          b2.y += m2.y;
        }
        bm[j][2 * hr] = b2.x;
        bm[j][2 * hr + 1] = b2.y;
      }
  };
  zero_tiles(bm);
  if (chunks == 1 && active && !a.mask) load_bm(nullptr);
  const auto window_of = [&](int slot) -> int {
    const unsigned q = quot(static_cast<unsigned>(slot), a.f_nper);
    return (slot - static_cast<int>(q) * a.n_per) * a.nW + static_cast<int>(q);
  };
  if (BWD && chunks > 1 && active) {
    for (int i = lane; i < N * N; i += 32) slab[i] = 0.0f;
    __syncwarp();
  }
  __syncthreads();

  const int per_head = a.hd * IT / a.unit;
  const int step = a.unit / IT;  // elements a copy
  const long long C3 = 3ll * a.C;
  const auto issue = [&](int s, int w0) {
    const int gn = end - w0 < G ? end - w0 : G;
    T* dst0 = stage + s * slot;
    const unsigned total = static_cast<unsigned>(G * ARRAYS * N * a.nh * per_head);
    // neighbouring threads: a head row's pieces, then the next tokens of the
    // same slice (rows ld apart in shared memory: no bank conflicts), then
    // the next head
    for (unsigned i = tid; i < total; i += blockDim.x) {
      const unsigned q1 = quot(i, a.f_units);
      const int u = static_cast<int>(i - q1 * per_head);
      const unsigned q2 = quot(q1, a.f_tokens);
      const int n = static_cast<int>(q1 - q2 * N);
      const unsigned q3 = quot(q2, a.f_nh);
      const int hh = static_cast<int>(q2 - q3 * a.nh);
      const int arr = static_cast<int>(q3 % ARRAYS), wl = static_cast<int>(q3 / ARRAYS);
      if (wl >= gn || hh >= nh_act) continue;
      const long long tok = static_cast<long long>(window_of(w0 + wl)) * N + n;
      const T* src = (arr < 3 ? static_cast<const T*>(a.qkv) + tok * C3 + arr * a.C
                              : static_cast<const T*>(a.gout) + tok * a.C) +
                     (h0 + hh) * a.hd + u * step;
      T* dst = dst0 + ((wl * a.nh + hh) * ARRAYS + arr) * arr_elems + n * LD + u * step;
      switch (a.unit) {
        case 16: cp_async<16>(dst, src); break;
        case 8: cp_async<8>(dst, src); break;
        case 4: cp_async<4>(dst, src); break;
        default: *dst = *src;
      }
    }
    cp_async_commit();
  };

  if (begin < end) issue(0, begin);
  int it = 0;
#pragma unroll 1
  for (int w0 = begin; w0 < end; w0 += G, ++it) {
    cp_async_wait<0>();
    __syncthreads();  // this stage in place for all; the other slot's readers done
    const int cur = a.stages == 2 ? (it & 1) : 0;
    if (a.stages == 2 && w0 + G < end) issue(cur ^ 1, w0 + G);
    // window i of this warp's share of the stage; false past the block's range
    const auto pair = [&](int i) {
      const int wl = r + a.R * i;
      if (w0 + wl >= end) return false;
      const long long w = window_of(w0 + wl);
      T* base = stage + cur * slot + (wl * a.nh + hl) * task_elems;
      const float* mask_w = a.mask ? a.mask + (w % a.nW) * N * N : nullptr;
      if (mask_w && chunks == 1 && w % a.nW != mrow) {
        mrow = static_cast<int>(w % a.nW);
        load_bm(mask_w);
      }
      if constexpr (BWD) {
        backward_pair<T, HDP>(base, base + arr_elems, base + 2 * arr_elems, base + 3 * arr_elems,
                              tile, tile + np * tile_ld(np, HDP, IT),
                              static_cast<T*>(a.out) + w * N * C3 + h * a.hd, db, slab, bm,
                              bias_h, mask_w, a);
      } else {
        forward_pair<T, HDP>(base, base + arr_elems, base + 2 * arr_elems,
                             static_cast<T*>(a.out) + w * N * a.C + h * a.hd, bm, bias_h, mask_w,
                             a);
      }
      return true;
    };
    if (active) {
      if constexpr (BWD) {  // one window at a time (registers)
#pragma unroll 1
        for (int i = 0; i < a.tpw; ++i)
          if (!pair(i)) break;
      } else {  // unrolled, so that one window's loads and products overlap the other's
#pragma unroll
        for (int i = 0; i < TASKS_PER_WARP; ++i)
          if (i >= a.tpw || !pair(i)) break;
      }
    }
    if (a.stages == 1) {
      __syncthreads();  // the slot's readers done
      if (w0 + G < end) issue(0, w0 + G);
    }
  }
  if (BWD && chunks == 1 && active) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = g + 8 * hr, key = 8 * j + 2 * t;
        if (row < N && key < N) {
          slab[row * N + key] = db[j][2 * hr];
          if (key + 1 < N) slab[row * N + key + 1] = db[j][2 * hr + 1];
        }
      }
  }
}

// grid (chunks, head groups); qkv (Bn, N, 3C), out (Bn, N, C) in T; bias
// (heads, N, N) and mask (nW, N, N) fp32.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, bound_blocks(HDP, sizeof(T)))
window_attention_any_fwd_kernel(const KArgs a) {
  attention_blocks<T, HDP, false>(a);
}

// grid (chunks, head groups); gout (Bn, N, C) and dqkv (Bn, N, 3C) in T;
// slabs (chunks * warps_per_head, heads, N, N) fp32.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, bound_blocks(HDP, sizeof(T)))
window_attention_any_bwd_kernel(const KArgs a) {
  attention_blocks<T, HDP, true>(a);
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

template <auto Kernel>
cudaError_t launch_kernel(const KArgs& a, const Plan& p, cudaStream_t stream) {
  const cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return err;
  Kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HDP, bool BWD>
cudaError_t launch(const KArgs& a, const Plan& p, cudaStream_t stream) {
  if constexpr (BWD)
    return launch_kernel<window_attention_any_bwd_kernel<T, HDP>>(a, p, stream);
  else
    return launch_kernel<window_attention_any_fwd_kernel<T, HDP>>(a, p, stream);
}

// Launches the plan's kernel: the template of its padded head dim.
template <typename T, bool BWD>
cudaError_t run(const void* qkv, const float* bias, const float* mask, const void* gout,
                void* out, float* slabs, int Bn, int N, int C, int heads, int nW,
                float scale_io, float scale, cudaStream_t stream) {
  const int hd = C / heads;
  const Plan p = make_plan(Bn, N, hd, heads, sizeof(T), BWD);
  if (!plan_fits(p)) return cudaErrorInvalidValue;
  KArgs a{};
  a.qkv = qkv;
  a.gout = gout;
  a.out = out;
  a.bias = bias;
  a.mask = mask;
  a.slabs = slabs;
  a.Bn = Bn;
  a.N = N;
  a.C = C;
  a.hd = hd;
  a.heads = heads;
  a.nW = mask ? nW : 1;
  a.n_per = Bn / a.nW;
  a.per_block = p.windows_per_block;
  a.nh = p.heads_per_block;
  a.R = p.warps_per_head;
  a.tpw = p.tasks_per_warp;
  a.stages = p.stages;
  a.np = p.padded_tokens;
  a.unit = copy_unit(C, hd, sizeof(T));
  a.f_units = fast_div(static_cast<unsigned>(hd * static_cast<int>(sizeof(T)) / a.unit));
  a.f_nh = fast_div(static_cast<unsigned>(p.heads_per_block));
  a.f_tokens = fast_div(static_cast<unsigned>(N));
  a.f_nper = fast_div(static_cast<unsigned>(a.n_per));
  a.scale_io = scale_io;
  a.scale = scale;
  a.pair_ok = C % 2 == 0 && hd % 2 == 0;
  a.vec = C % 4 == 0 && hd % 4 == 0 ? 4 : a.pair_ok ? 2 : 1;
  switch (p.padded_hd) {
    case 4:
      if constexpr (!kBf16<T>) return launch<T, 4, BWD>(a, p, stream);
      return cudaErrorInvalidValue;
    case 8: return launch<T, 8, BWD>(a, p, stream);
    case 16: return launch<T, 16, BWD>(a, p, stream);
    case 32: return launch<T, 32, BWD>(a, p, stream);
    case 64: return launch<T, 64, BWD>(a, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Launches the forward: qkv (Bn, N, 3C) -> out (Bn, N, C).
template <typename T>
cudaError_t forward(const T* qkv, const float* bias, const float* mask, T* out, int Bn, int N,
                    int C, int heads, int nW, float scale_io, cudaStream_t stream) {
  return run<T, false>(qkv, bias, mask, nullptr, out, nullptr, Bn, N, C, heads, nW, scale_io,
                       1.0f, stream);
}

// Launches the backward's per-window kernel: dqkv (Bn, N, 3C) and the dbias
// slabs (plan.partials, heads, N, N); the caller sums the slabs.
template <typename T>
cudaError_t backward(const T* qkv, const float* bias, const float* mask, const T* gout, T* dqkv,
                     float* slabs, int Bn, int N, int C, int heads, int nW, float scale_io,
                     float scale, cudaStream_t stream) {
  return run<T, true>(qkv, bias, mask, gout, dqkv, slabs, Bn, N, C, heads, nW, scale_io, scale,
                      stream);
}

}  // namespace
}  // namespace wa_any
