// Linear attention at any heads and dim_head (the generic variant) for
// Hopper, sm_90a: pass 1 (the k side) with a weight-preparing launch and a
// LayerNorm-statistics launch before it and a fixed-order reduction launch
// after it, and pass 2 (the q side).
//
// Replaces: dmhomo_tpu/ops/linear_attention.py:145 _pass1_kernel and :163
// _pass2_kernel (the Pallas TPU kernels of pallas_linear_attention, which
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
//                  with mean, rstd of each token over C in fp32 (eps 1e-5),
//                  computed here or given
//   pass 1:  ek = round(exp(clip(k, +-60)));  s_h = sum_n ek_h (fp32);
//            E_h = ek_h^T v_h (fp32), the D x D diagonal block of head h
//   pass 2:  context_h = round(E_h * D^-0.5 / (s_h * N))  (row d by s_h[d])
//            eq = round(exp(clip(q, +-60)))
//            out_h = round(round(eq_h . context_h) / round(sum_d eq_h))
//
// What bounds them on an H100.  Per token, pass 1 does 2 * C * 2HD flops of
// projection and 2 * H * D^2 for E; pass 2 2 * C * HD and 2 * H * D^2 for
// eq . context, and writes HD outputs.  At the UNet's (8, 64) sites (C
// 64-512) pass 1 is operations bound on bf16 tensor cores (about 1000 flops
// a byte of x at C = 64), pass 2 bytes bound (its output is 512 values a
// token); in fp32 (67 TFLOP/s on CUDA cores) both are operations bound.
// Past the products, each pass applies an epilogue to every projected value
// (the prenorm fold, roundings, an exp).
//
// The design.  A block holds a group of heads whose padded columns make 128
// (dim_head padded to DP in {16, 32, 64, 128}, 128 / DP heads; the last
// group's missing heads are masked), so an x tile staged in shared memory
// serves every head of the group, and E and s of the group stay in
// registers across the tiles of the block's token chunk.  The LayerNorm
// statistics are computed once per tile by a launch of their own; every
// group's block reads them with its x tile instead of computing them again
// on the critical path of its tile.  x comes through a ring of 2-3 slots of
// cp.async copies (16 bytes where token stride 1 and the alignment allow
// it, else element loads through any strides), a slot holding a tile's
// channels c0 .. c0 + KC - 1.  The weights are staged in shared memory once
// per block where they fit ("resident"), else one channel step per ring
// slot ("streamed").  Pass 1's weights, round(diag(g) W) in dt in the order
// its kernel reads them, and u = g . W (fp32) come from a small launch
// before it, once per call, into the caller's scratch after the partials;
// pass 2 has no scratch argument, so each of its persistent blocks makes
// its group's weights and u once (streamed: its weights once per channel
// step of each tile).  The bf16 kernels at DP <= 64 are held to 128
// registers so that two blocks share an SM: one block's epilogue (fp32
// arithmetic and exps) then overlaps the other's tensor-core work, which
// on the H100 outweighs the few spills the cap costs pass 1.

// bf16 (the conditional UNet's generation path): tensor cores, mma.sync
// m16n8k16 with fp32 accumulation fed by ldmatrix.  Pass 1 projects
// transposed (rows are the group's 128 k then 128 v columns, columns 64
// tokens; each warp 32 rows x 64 tokens), rounds and exponentiates in
// registers and writes ek^T and v^T of the tile to shared memory as bf16;
// then warp w holds rows d 16w .. 16w+15 of its head's E_h over all e
// (DP / 8 n-tiles) and adds ek^T v from ldmatrix over the tile's tokens,
// and s_h from the same A fragments.  Pass 2 projects q = x . wt^T with 16
// tokens of one head per warp unit, so eq passes from the accumulators to
// the A operand of num = eq . context in registers (context rebuilt in
// shared memory once per block and batch row), and writes the tile through
// shared memory so that the stores are coalesced in either layout.
// mma.sync rather than wgmma: pass 2's eq would have to go back to shared
// memory for wgmma's B-in-shared-memory form, and pass 1's E operands are
// already in shared memory but 64-token tiles are below wgmma's economic
// size; the tuned library makes the same choice.
//
// fp32 (the unconditional twin, and the tests' 1e-5 tolerance): CUDA cores,
// TF32 never used.  Pass 1 as the tuned fp32 kernel: 64-token tiles, KC 32,
// each thread 8 tokens x 8 columns (its 4 k and 4 v columns of the group),
// ek and v of the tile in shared memory, each thread's block of E (4-8 x
// 4-8 of one head) in registers across tiles.  Pass 2: each thread 8 (16 at
// DP = 128) tokens x 4 q columns, eq of the tile in shared memory, then
// eq . context per head.
//
// No atomics anywhere: pass 1's blocks write (E_h, s_h) of their chunk to a
// slot of their own, and linear_attention_any_reduce_kernel sums the slots
// in chunk order, so reruns give the same bits.  x and out are addressed
// through element strides, so the UNet's NCHW activations (token stride 1)
// are read and written in place.  Everything but the C entry points has
// internal linkage (an unnamed namespace), so the two linear-attention
// libraries share no symbol.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int GROUP = 128;          // padded head columns a block holds
constexpr int TILE1 = 64;           // pass 1 tokens per tile
constexpr int KC_BF16 = 64;         // channels per ring slot
constexpr int KC_FP32 = 32;
constexpr int MAX_HEADS = 16;
constexpr int MAX_DH = 128;
constexpr int MAX_HIDDEN = 1024;    // heads * dim_head
constexpr int MAX_C = 1024;
constexpr int MAX_B = 65535;        // grid z
constexpr int SMS = 132;
constexpr int TARGET1 = SMS * 8;    // pass 1 blocks in all: about eight waves of one per SM
constexpr int TARGET2 = SMS * 2;    // pass 2 persistent blocks in all
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int PREP_COLS = 64;       // channels per block of the preparing launch
constexpr float CLIP = 60.0f;

struct Strides {
  long long b, n, c;
};

// What a launch needs beside its pointers.
struct Args {
  int B, N, C, cp, heads, dh;
  int n_tiles, chunks, tiles_per_chunk, nch;
  int resident, stages, prenorm, aligned, aligned_out;
  float scale;
};

template <typename E>
__device__ __forceinline__ float to_f(E v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float clipped_exp(float v) {
  return expf(fminf(fmaxf(v, -CLIP), CLIP));
}

// exp(clip(v, +-60)) for a value rounded to bf16 next: ex2.approx of v *
// log2(e), within a few fp32 ulps of expf, far below a bf16 step; flushing
// subnormals changes nothing, as exp(-60) is a normal number
__device__ __forceinline__ float clipped_exp_fast(float v) {
  const float e2 = fminf(fmaxf(v, -CLIP), CLIP) * 1.4426950408889634f;  // log2(e)
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e2));
  return r;
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

__device__ __forceinline__ void cp_async_wait_all() {
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

// the two values of a packed bf16 pair, as fp32
__device__ __forceinline__ float lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// a / b rounded to nearest, from rb = 1 / b rounded to nearest (one
// correction step; exact for the normal, finite operands here)
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

// ---------------------------------------------------------------------------
// The plan: launch geometry and shared memory from the shapes alone (the
// Python side's generic_launch_plan computes the same)
// ---------------------------------------------------------------------------

__host__ __device__ inline int dim_head_padded(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128;
}

__host__ __device__ inline int tile_of(int pass, int dp) {
  return pass == 2 && dp == 128 ? 2 * TILE1 : TILE1;
}

// Dynamic shared memory of a block (fp32: the CUDA-core kernels).
inline int smem_bytes(int pass, int fp32, int dp, int cp, int resident, int stages) {
  const int T = tile_of(pass, dp), es = fp32 ? 4 : 2, kc = fp32 ? KC_FP32 : KC_BF16;
  const int slot = kc * (T + (fp32 ? 4 : 8)) * es + 2 * T * 4;  // x rows, mean, rstd
  if (pass == 1) {
    const int R = 2 * GROUP;
    const int w_res = fp32 ? cp * R * 4 : R * (cp + 8) * 2;
    const int w_slot = fp32 ? kc * R * 4 : R * (kc + 8) * 2;
    const int ekv = fp32 ? 2 * T * GROUP * 4 : R * (T + 8) * 2;
    return (resident ? w_res : 0) + stages * (slot + (resident ? 0 : w_slot)) + ekv + R * 4;
  }
  const int R = GROUP;
  const int w_res = fp32 ? cp * R * 4 : R * (cp + 8) * 2;
  const int w_str = fp32 ? kc * R * 4 : R * (kc + 8) * 2;
  const int tile = fp32 ? (R * (T + 4) + 16) * 4 : R * (T + 8) * 2;  // eq / output, rows = columns
  const int ctx = fp32 ? R * dp * 4 : R * (dp + 8) * 2;
  return (resident ? w_res : w_str) + stages * slot + tile + ctx + R * 4;
}

struct Plan {
  int dp;          // dim_head padded
  int hg;          // heads per group (GROUP / dp)
  int groups;
  int cp;          // channels padded to a multiple of 16
  int tile;        // tokens per tile
  int n_tiles;
  int grid_x;      // pass 1: token chunks per (group, batch); pass 2: blocks per group
  int tiles_per_chunk;  // pass 2: most tiles of a block
  int smem[2];     // bf16, fp32
  int resident[2];
  int stages[2];
  long long slots;        // pass 1: floats of the per-chunk (E_h, s_h) slots
  long long prep_offset;  // pass 1: floats before u and the prepared weights
  long long scratch;      // pass 1: floats of the whole scratch
};

inline Plan make_plan(int pass, int B, int N, int C, int heads, int dh) {
  Plan p{};
  p.dp = dim_head_padded(dh);
  p.hg = GROUP / p.dp;
  p.groups = (heads + p.hg - 1) / p.hg;
  p.cp = (C + 15) / 16 * 16;
  p.tile = tile_of(pass, p.dp);
  p.n_tiles = (N + p.tile - 1) / p.tile;
  for (int f = 0; f < 2; ++f) {
    p.resident[f] = 0;
    p.stages[f] = 2;
    bool found = false;
    for (int res = 1; res >= 0 && !found; --res)
      for (int st = 3; st >= 2 && !found; --st)
        if (smem_bytes(pass, f, p.dp, p.cp, res, st) <= SMEM_LIMIT) {
          p.resident[f] = res;
          p.stages[f] = st;
          found = true;
        }
    p.smem[f] = smem_bytes(pass, f, p.dp, p.cp, p.resident[f], p.stages[f]);
  }
  if (pass == 1) {
    long long want = (TARGET1 + (long long)B * p.groups - 1) / ((long long)B * p.groups);
    if (want < 1) want = 1;
    if (want > p.n_tiles) want = p.n_tiles;
    p.tiles_per_chunk = (int)((p.n_tiles + want - 1) / want);
    p.grid_x = (p.n_tiles + p.tiles_per_chunk - 1) / p.tiles_per_chunk;
    p.slots = (long long)B * heads * p.grid_x * ((long long)dh * dh + dh);
    p.prep_offset = (p.slots + 63) / 64 * 64;
    p.scratch = p.prep_offset + (long long)p.groups * 2 * GROUP +
                (long long)p.groups * p.cp * 2 * GROUP;
  } else {
    const long long total = (long long)B * p.n_tiles;
    long long g = (TARGET2 + p.groups - 1) / p.groups;
    if (g > total) g = total;
    p.grid_x = (int)g;
    p.tiles_per_chunk = (int)((total + g - 1) / g);
    p.slots = p.prep_offset = p.scratch = 0;
  }
  return p;
}

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

// Stage channels c0 .. c0+kc-1 of tokens t0 .. t0+tile-1 of batch row b as
// rows of xld elements, zeros past C and N; with `stats`, also mean and rstd
// of the tokens (fp32, 2 x tile, after the rows).  aligned: 16-byte
// cp.async copies (token stride 1, N and the row strides multiples of a
// copy, 16-byte aligned bases); otherwise element loads through the strides.
template <typename E>
__device__ void load_x(E* xs, int xld, float* st, const E* __restrict__ x, Strides sx,
                       const float* mean, const float* rstd, bool stats, bool aligned, int b,
                       int t0, int c0, int kc, int tile, int N, int C) {
  constexpr int V = 16 / sizeof(E);
  const E* xb = x + b * sx.b;
  const int tid = threadIdx.x;
  if (aligned) {
    const int per_row = tile / V;
    for (int e = tid; e < kc * per_row; e += THREADS) {
      const int row = e / per_row, j = e % per_row, c = c0 + row, tok = t0 + V * j;
      const bool ok = c < C && tok < N;
      cp_async16(smem_u32(xs + row * xld + V * j), ok ? xb + c * sx.c + tok : x, ok ? 16 : 0);
    }
    if (stats)
      for (int e = tid; e < 2 * (tile / 4); e += THREADS) {
        const int which = e / (tile / 4), j = e % (tile / 4), tok = t0 + 4 * j;
        const float* src = which ? rstd : mean;
        const bool ok = tok < N;
        cp_async16(smem_u32(st + which * tile + 4 * j), ok ? src + (long long)b * N + tok : src,
                   ok ? 16 : 0);
      }
  } else {
    const bool token_fastest = sx.n <= sx.c;
    for (int e = tid; e < kc * tile; e += THREADS) {
      const int row = token_fastest ? e / tile : e % kc;
      const int t = token_fastest ? e % tile : e / kc;
      const int c = c0 + row, tok = t0 + t;
      xs[row * xld + t] = (c < C && tok < N) ? xb[tok * sx.n + c * sx.c] : from_f<E>(0.0f);
    }
    if (stats)
      for (int e = tid; e < 2 * tile; e += THREADS) {
        const int which = e / tile, t = e % tile, tok = t0 + t;
        st[which * tile + t] = tok < N ? (which ? rstd : mean)[(long long)b * N + tok] : 0.0f;
      }
  }
}

// Pass 1's prepared weights, columns c0 .. c0+n-1 (n a multiple of 16) of
// the group's rows into shared memory.  bf16: rows of the 256 k and v
// columns (cp channels each) into rows ld apart; fp32: channel rows of 256
// columns.
__device__ void load_w_bf16(bf16* ws, int ld, const bf16* __restrict__ wg, int cp, int c0, int n) {
  const int per_row = n / 8;
  for (int e = threadIdx.x; e < 2 * GROUP * per_row; e += THREADS) {
    const int r = e / per_row, j = e % per_row;
    cp_async16(smem_u32(ws + r * ld + 8 * j), wg + (long long)r * cp + c0 + 8 * j, 16);
  }
}

__device__ void load_w_fp32(float* ws, const float* __restrict__ wg, int c0, int n) {
  constexpr int PER_ROW = 2 * GROUP / 4;
  for (int e = threadIdx.x; e < n * PER_ROW; e += THREADS) {
    const int row = e / PER_ROW, j = e % PER_ROW;
    cp_async16(smem_u32(ws + row * 2 * GROUP + 4 * j),
               wg + (long long)(c0 + row) * 2 * GROUP + 4 * j, 16);
  }
}

// Pass 1's statistics launch, grid (token blocks of 64, batch): mean and
// rstd of each token over C (fp32, eps 1e-5), four threads per token, each
// holding STEP / 4 of a step's channels in registers: two-pass within a
// step, steps merged as Chan et al. (one step: the two-pass mean and biased
// variance).  Once per call, so every head group's block reads them.
constexpr int STATS_STEP = 64;

template <typename E>
__global__ void __launch_bounds__(THREADS)
linear_attention_any_stats_kernel(const E* __restrict__ x, Strides sx, float* __restrict__ mean,
                                  float* __restrict__ rstd, int N, int C) {
  constexpr int NV = STATS_STEP / 4;
  const int tk = threadIdx.x / 4, p = threadIdx.x % 4, b = blockIdx.y;
  const int tok = blockIdx.x * (THREADS / 4) + tk;
  const E* xt = x + b * sx.b + min(tok, N - 1) * sx.n;
  float rm = 0.0f, rq = 0.0f;
  for (int c0 = 0; c0 < C; c0 += STATS_STEP) {
    const int cv = min(STATS_STEP, C - c0);
    float v[NV], s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[k] = p + 4 * k < cv ? to_f(xt[(c0 + p + 4 * k) * sx.c]) : 0.0f;
      s4[k % 4] += v[k];
    }
    float sm = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    sm += __shfl_xor_sync(0xffffffffu, sm, 1);
    sm += __shfl_xor_sync(0xffffffffu, sm, 2);
    const float m = __fdividef(sm, (float)cv);
    float q4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float d = p + 4 * k < cv ? v[k] - m : 0.0f;
      q4[k % 4] = fmaf(d, d, q4[k % 4]);
    }
    float q = (q4[0] + q4[1]) + (q4[2] + q4[3]);
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    if (c0 == 0) {
      rm = m;
      rq = q;
    } else {
      const float na = (float)c0, nb = (float)cv, rn = __fdividef(1.0f, na + nb);
      const float delta = m - rm;
      rm = fmaf(delta, nb * rn, rm);
      rq = rq + q + delta * delta * (na * nb * rn);
    }
  }
  if (p == 0 && tok < N) {
    mean[(long long)b * N + tok] = rm;
    rstd[(long long)b * N + tok] = rsqrtf(__fdividef(rq, (float)C) + 1e-5f);
  }
}

// The w_qkv column of row r of a group (padded head columns: head
// group * hg + r / dp, d = r % dp) among columns `base` + h * dh + d, or -1
// for a padding row.
__device__ __forceinline__ int group_col(int r, int dp, int group, int heads, int dh, int base) {
  const int hl = r / dp, d = r % dp, h = group * (GROUP / dp) + hl;
  return (d < dh && h < heads) ? base + h * dh + d : -1;
}

// u[r] = sum_c g[c] W[c][col(r)] (fp32, unrounded W, channel order)
__device__ __forceinline__ float gain_times_w(const float* __restrict__ w,
                                              const float* __restrict__ g, int C, int wcols,
                                              int col) {
  float u = 0.0f;
  if (col >= 0)
    for (int c = 0; c < C; ++c) u = fmaf(g[c], w[(long long)c * wcols + col], u);
  return u;
}

// Pass 1's preparing launch, grid (channel blocks + 1, groups): each block's
// 256 threads are the group's rows (k columns, then v columns); blocks x <
// gridDim.x - 1 write round(g W) of their channels into wt (bf16: [group][row]
// [cp]; fp32: [group][channel][row]), zeros past C and for padding rows;
// with g, the last block writes u = g . W (fp32) into u[group][row].
template <typename E>
__global__ void __launch_bounds__(THREADS)
linear_attention_any_prep_kernel(const float* __restrict__ w, const float* __restrict__ g,
                                 float* __restrict__ u, E* __restrict__ wt, int C, int cp,
                                 int heads, int dh, int dp) {
  const int r = threadIdx.x, group = blockIdx.y;
  const int hd = heads * dh, wcols = 3 * hd;
  const int col = group_col(r % GROUP, dp, group, heads, dh, (1 + r / GROUP) * hd);
  const int wblocks = (cp + PREP_COLS - 1) / PREP_COLS;
  if ((int)blockIdx.x == wblocks) {
    u[group * 2 * GROUP + r] = gain_times_w(w, g, C, wcols, col);
    return;
  }
  const int c0 = blockIdx.x * PREP_COLS, c1 = min(cp, c0 + PREP_COLS);
  for (int c = c0; c < c1; ++c) {
    float v = 0.0f;
    if (col >= 0 && c < C) v = w[(long long)c * wcols + col] * (g ? g[c] : 1.0f);
    if (sizeof(E) == 2)
      wt[((long long)group * 2 * GROUP + r) * cp + c] = from_f<E>(v);
    else
      wt[((long long)group * cp + c) * 2 * GROUP + r] = from_f<E>(v);
  }
}

// ---------------------------------------------------------------------------
// Pass 1, bf16 on tensor cores
// ---------------------------------------------------------------------------

// Grid (token chunk, head group, batch).  Warp w projects rows 32w .. 32w+31
// of the group's 256 (k then v) over the tile's 64 tokens; after the
// epilogue it holds E rows d 16w .. 16w+15 (of head 16w / DP) over all e.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1)
linear_attention_any_pass1_bf16_kernel(const bf16* __restrict__ x, Strides sx,
                                       const bf16* __restrict__ wt, const float* __restrict__ u,
                                       float* mean, float* rstd, float* __restrict__ partials,
                                       Args p) {
  constexpr int R = 2 * GROUP, HG = GROUP / DP, T = TILE1, XLD = T + 8, KC = KC_BF16;
  constexpr int NE = DP / 8;  // the warp's E n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunk = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  const int wld = p.resident ? p.cp + 8 : KC + 8;  // weight row, bf16
  bf16* ws = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + (p.resident ? R * wld * 2 : 0);
  const int xbytes = KC * XLD * 2 + 2 * T * 4;  // a slot's x rows and statistics
  const int sbytes = xbytes + (p.resident ? 0 : R * wld * 2);
  bf16* ekv = reinterpret_cast<bf16*>(ring + p.stages * sbytes);  // ek^T rows, then v^T rows
  float* u_s = reinterpret_cast<float*>(ekv + R * XLD);

  const int tile0 = chunk * p.tiles_per_chunk;
  const int tile1 = min(p.n_tiles, tile0 + p.tiles_per_chunk);
  const int nch = p.nch, n_units = (tile1 - tile0) * nch;
  const bf16* wg = wt + (long long)group * R * p.cp;

  if (p.resident) load_w_bf16(ws, wld, wg, p.cp, 0, p.cp);  // lands with the first slot
  auto fetch = [&](int unit) {
    if (unit < n_units) {
      const int tile = tile0 + unit / nch, ch = unit % nch;
      unsigned char* slot = ring + (unit % p.stages) * sbytes;
      load_x<bf16>(reinterpret_cast<bf16*>(slot), XLD,
                   reinterpret_cast<float*>(slot + KC * XLD * 2), x, sx, mean, rstd,
                   p.prenorm && ch == nch - 1, p.aligned, b, tile * T, ch * KC, KC, T, p.N, p.C);
      if (!p.resident)
        load_w_bf16(reinterpret_cast<bf16*>(slot + xbytes), wld, wg, p.cp, ch * KC,
                    min(KC, p.cp - ch * KC));
    }
    cp_async_commit();
  };
  for (int s = 0; s < p.stages - 1; ++s) fetch(s);
  if (p.prenorm)
    for (int r = tid; r < R; r += THREADS) u_s[r] = u[group * R + r];

  float acc[2][8][4];  // rows 32 warp + 16 i .., tokens 8 j ..
  float e_acc[NE][4];
  float s_acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NE; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) e_acc[n][q] = 0.0f;
  const int ehl = (16 * warp) / DP;  // the head of the warp's E rows
  const uint32_t ws_addr = smem_u32(ws), ekv_addr = smem_u32(ekv);

  for (int un = 0; un < n_units; ++un) {
    cp_async_wait_oldest(p.stages);
    __syncthreads();
    fetch(un + p.stages - 1);
    unsigned char* slot = ring + (un % p.stages) * sbytes;
    const bf16* xs = reinterpret_cast<const bf16*>(slot);
    const float* st = reinterpret_cast<const float*>(slot + KC * XLD * 2);
    const int ch = un % nch, t0 = (tile0 + un / nch) * T;
    const bool last = ch == nch - 1;
    const int kv = min(KC, p.cp - ch * KC);
    const uint32_t w_addr = p.resident ? ws_addr + ch * KC * 2 : smem_u32(slot + xbytes);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    }
    // projection: acc[i][j] += wt rows (32 warp + 16 i ..) . x^T (tokens 8 j ..)
    const uint32_t xs_addr = smem_u32(xs);
    for (int kk = 0; kk < kv; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], w_addr + ((32 * warp + 16 * i + (lane & 15)) * wld + kk + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4) {
        uint32_t xf[4];
        ldsm_x4_trans(xf, xs_addr + ((kk + (lane & 15)) * XLD + 16 * n4 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * n4], af[i], xf[0], xf[1]);
          mma(acc[i][2 * n4 + 1], af[i], xf[2], xf[3]);
        }
      }
    }
    if (!last) continue;

    // epilogue: prenorm fold; k rounded, ek = round(exp(clip(k))); v rounded;
    // zero past N and in padding rows; into ek^T / v^T as bf16 pairs of tokens
    const float* m_src = st;
    const float* r_src = st + T;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int qr = 0; qr < 2; ++qr) {
        const int r = 32 * warp + 16 * i + (lane >> 2) + 8 * qr;
        const int local = r % GROUP, d = local % DP;
        const bool row_ok = d < p.dh && group * HG + local / DP < p.heads;
        const bool is_k = r < GROUP;
        const float uu = p.prenorm ? u_s[r] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = 8 * j + 2 * (lane & 3);
          float a0 = acc[i][j][2 * qr], a1 = acc[i][j][2 * qr + 1];
          if (p.prenorm) {
            a0 = (a0 - m_src[t] * uu) * r_src[t];
            a1 = (a1 - m_src[t + 1] * uu) * r_src[t + 1];
          }
          if (is_k) {
            const uint32_t k = pack(a0, a1);
            a0 = clipped_exp_fast(lo(k));
            a1 = clipped_exp_fast(hi(k));
          }
          const bool ok0 = row_ok && t0 + t < p.N, ok1 = row_ok && t0 + t + 1 < p.N;
          *reinterpret_cast<uint32_t*>(ekv + r * XLD + t) = pack(ok0 ? a0 : 0.0f, ok1 ? a1 : 0.0f);
        }
      }
    __syncthreads();
    // E_h += ek_h^T v_h over the tile (A: ek^T rows d, k = tokens; B: v^T
    // rows e), s_h from the same A fragments
#pragma unroll
    for (int ks = 0; ks < T / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, ekv_addr + ((16 * warp + (lane & 15)) * XLD + 16 * ks + (lane >> 4) * 8) * 2);
      s_acc[0] += (lo(af[0]) + hi(af[0])) + (lo(af[2]) + hi(af[2]));
      s_acc[1] += (lo(af[1]) + hi(af[1])) + (lo(af[3]) + hi(af[3]));
#pragma unroll
      for (int nb = 0; nb < DP / 16; ++nb) {
        uint32_t bv[4];
        ldsm_x4(bv, ekv_addr + ((GROUP + ehl * DP + 16 * nb + (lane & 7) + ((lane >> 4) << 3)) * XLD +
                                16 * ks + ((lane >> 3) & 1) * 8) * 2);
        mma(e_acc[2 * nb], af, bv[0], bv[1]);
        mma(e_acc[2 * nb + 1], af, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block
  // this chunk's (E_h, s_h) into its slot, every element by one lane
  const int h = group * HG + ehl, d0 = (16 * warp) % DP;
  if (h < p.heads) {
    const long long per = (long long)p.dh * p.dh + p.dh;
    float* slot = partials + (((long long)b * p.heads + h) * p.chunks + chunk) * per;
#pragma unroll
    for (int n = 0; n < NE; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + (lane >> 2) + 8 * (q >> 1), e = 8 * n + 2 * (lane & 3) + (q & 1);
        if (d < p.dh && e < p.dh) slot[d * p.dh + e] = e_acc[n][q];
      }
#pragma unroll
    for (int qr = 0; qr < 2; ++qr) {
      float v = s_acc[qr];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int d = d0 + (lane >> 2) + 8 * qr;
      if ((lane & 3) == 0 && d < p.dh) slot[p.dh * p.dh + d] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 1, fp32 on CUDA cores
// ---------------------------------------------------------------------------

// Grid (token chunk, head group, batch).  Thread (i = tid / 32, j = tid % 32)
// projects tokens 8i .. 8i+7 onto the group's k columns 4j .. 4j+3 and the v
// columns of the same (head, d); after the tile's ek and v are in shared
// memory it adds ek^T v into its ER x EC block of its head's E.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
linear_attention_any_pass1_fp32_kernel(const float* __restrict__ x, Strides sx,
                                       const float* __restrict__ wf, const float* __restrict__ u,
                                       float* mean, float* rstd, float* __restrict__ partials,
                                       Args p) {
  constexpr int R = 2 * GROUP, HG = GROUP / DP, T = TILE1, XLD = T + 4, KC = KC_FP32;
  constexpr int ER = DP == 128 ? 8 : DP == 16 ? 2 : 4;  // a thread's E rows and columns
  constexpr int EC = DP >= 64 ? 8 : 4;
  constexpr int NEB = DP / EC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, i = tid / 32, j = tid % 32;
  const int chunk = blockIdx.x, group = blockIdx.y, b = blockIdx.z;
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (p.resident ? p.cp * R * 4 : 0);
  const int xbytes = KC * XLD * 4 + 2 * T * 4;
  const int sbytes = xbytes + (p.resident ? 0 : KC * R * 4);
  float* eks = reinterpret_cast<float*>(ring + p.stages * sbytes);
  float* vs = eks + T * GROUP;
  float* u_s = vs + T * GROUP;

  const int tile0 = chunk * p.tiles_per_chunk;
  const int tile1 = min(p.n_tiles, tile0 + p.tiles_per_chunk);
  const int nch = p.nch, n_units = (tile1 - tile0) * nch;
  const float* wg = wf + (long long)group * p.cp * R;

  if (p.resident) load_w_fp32(ws, wg, 0, p.cp);
  auto fetch = [&](int unit) {
    if (unit < n_units) {
      const int tile = tile0 + unit / nch, ch = unit % nch;
      unsigned char* slot = ring + (unit % p.stages) * sbytes;
      load_x<float>(reinterpret_cast<float*>(slot), XLD,
                    reinterpret_cast<float*>(slot + KC * XLD * 4), x, sx, mean, rstd,
                    p.prenorm && ch == nch - 1, p.aligned, b, tile * T, ch * KC, KC, T, p.N, p.C);
      if (!p.resident)
        load_w_fp32(reinterpret_cast<float*>(slot + xbytes), wg, ch * KC, min(KC, p.cp - ch * KC));
    }
    cp_async_commit();
  };
  for (int s = 0; s < p.stages - 1; ++s) fetch(s);
  if (p.prenorm)
    for (int r = tid; r < R; r += THREADS) u_s[r] = u[group * R + r];

  // E: head ehl, rows d0 .., columns e0 .. of its block
  const int ehl = tid / (2 * DP), local = tid % (2 * DP);
  const int d0 = (local / NEB) * ER, e0 = (local % NEB) * EC;
  const bool s_owner = local % NEB == 0;
  float e_acc[ER][EC], s_acc[ER];
#pragma unroll
  for (int a = 0; a < ER; ++a) {
    s_acc[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < EC; ++c) e_acc[a][c] = 0.0f;
  }
  float acc[8][8];

  for (int un = 0; un < n_units; ++un) {
    cp_async_wait_oldest(p.stages);
    __syncthreads();
    fetch(un + p.stages - 1);
    unsigned char* slot = ring + (un % p.stages) * sbytes;
    const float* xs = reinterpret_cast<const float*>(slot);
    const float* st = reinterpret_cast<const float*>(slot + KC * XLD * 4);
    const int ch = un % nch, t0 = (tile0 + un / nch) * T;
    const float* wsrc = p.resident ? ws + ch * KC * R : reinterpret_cast<const float*>(slot + xbytes);
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    }
    const int kmax = min(KC, p.C - ch * KC);
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + c * XLD + 8 * i);
      const float4 xb = *reinterpret_cast<const float4*>(xs + c * XLD + 8 * i + 4);
      const float4 wk = *reinterpret_cast<const float4*>(wsrc + c * R + 4 * j);
      const float4 wv = *reinterpret_cast<const float4*>(wsrc + c * R + GROUP + 4 * j);
      const float av[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wc[8] = {wk.x, wk.y, wk.z, wk.w, wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], wc[q], acc[r][q]);
    }
    if (ch != nch - 1) continue;

    const float* m_src = st;
    const float* r_src = st + T;
    bool col_ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * j + q;
      col_ok[q] = col % DP < p.dh && group * HG + col / DP < p.heads;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = 8 * i + r;
      const bool valid = t0 + t < p.N;
      const float m = p.prenorm ? m_src[t] : 0.0f, rs = p.prenorm ? r_src[t] : 0.0f;
      float kq[4], vq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float k = acc[r][q], v = acc[r][4 + q];
        if (p.prenorm) {
          k = (k - m * u_s[4 * j + q]) * rs;
          v = (v - m * u_s[GROUP + 4 * j + q]) * rs;
        }
        const bool ok = valid && col_ok[q];
        kq[q] = ok ? clipped_exp(k) : 0.0f;
        vq[q] = ok ? v : 0.0f;
      }
      *reinterpret_cast<float4*>(eks + t * GROUP + 4 * j) = make_float4(kq[0], kq[1], kq[2], kq[3]);
      *reinterpret_cast<float4*>(vs + t * GROUP + 4 * j) = make_float4(vq[0], vq[1], vq[2], vq[3]);
    }
    __syncthreads();
    const int n_valid = min(T, p.N - t0);
    const float* ek_row = eks + ehl * DP + d0;
    const float* v_row = vs + ehl * DP + e0;
#pragma unroll 4
    for (int t = 0; t < n_valid; ++t) {
      float kk[ER], vv[EC];
#pragma unroll
      for (int a = 0; a < ER; a += 2) {
        const float2 k2 = *reinterpret_cast<const float2*>(ek_row + t * GROUP + a);
        kk[a] = k2.x;
        kk[a + 1] = k2.y;
      }
#pragma unroll
      for (int c = 0; c < EC; c += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(v_row + t * GROUP + c);
        vv[c] = v4.x;
        vv[c + 1] = v4.y;
        vv[c + 2] = v4.z;
        vv[c + 3] = v4.w;
      }
#pragma unroll
      for (int a = 0; a < ER; ++a) {
        s_acc[a] += kk[a];
#pragma unroll
        for (int c = 0; c < EC; ++c) e_acc[a][c] = fmaf(kk[a], vv[c], e_acc[a][c]);
      }
    }
  }
  cp_async_wait_all();
  const int h = group * HG + ehl;
  if (h < p.heads) {
    const long long per = (long long)p.dh * p.dh + p.dh;
    float* slot = partials + (((long long)b * p.heads + h) * p.chunks + chunk) * per;
#pragma unroll
    for (int a = 0; a < ER; ++a) {
      const int d = d0 + a;
      if (d >= p.dh) continue;
#pragma unroll
      for (int c = 0; c < EC; ++c)
        if (e0 + c < p.dh) slot[d * p.dh + e0 + c] = e_acc[a][c];
      if (s_owner) slot[p.dh * p.dh + d] = s_acc[a];
    }
  }
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

// ---------------------------------------------------------------------------
// Pass 2
// ---------------------------------------------------------------------------

// The block's flat tiles (batch row, tile): a contiguous share of B * n_tiles.
struct Range {
  long long first, last;
};

__device__ __forceinline__ Range block_range(long long total) {
  return {total * blockIdx.x / gridDim.x, total * (blockIdx.x + 1) / gridDim.x};
}

// Pass 2's q weights of the group, round(g W) in dt, channels c0 .. c0+n-1
// (n even): bf16 rows of the 128 columns, ld apart; fp32 channel rows of 128.
template <typename E>
__device__ void stage_w2(E* ws, int ld, const float* __restrict__ w, const float* __restrict__ g,
                         int c0, int n, int C, int wcols, int col) {
  const int part = threadIdx.x / GROUP;  // the thread's row is threadIdx.x % GROUP (col)
  const int r = threadIdx.x % GROUP;
  if (sizeof(E) == 2) {
    for (int c = c0 + 2 * part; c < c0 + n; c += 2 * (THREADS / GROUP)) {
      const float w0 = col >= 0 && c < C ? w[(long long)c * wcols + col] : 0.0f;
      const float w1 = col >= 0 && c + 1 < C ? w[(long long)(c + 1) * wcols + col] : 0.0f;
      const float g0 = g && c < C ? g[c] : 1.0f, g1 = g && c + 1 < C ? g[c + 1] : 1.0f;
      *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(ws) + r * ld + c - c0) =
          pack(w0 * g0, w1 * g1);
    }
  } else {
    for (int c = c0 + part; c < c0 + n; c += THREADS / GROUP) {
      const float v = col >= 0 && c < C ? w[(long long)c * wcols + col] * (g ? g[c] : 1.0f) : 0.0f;
      reinterpret_cast<float*>(ws)[(c - c0) * GROUP + r] = v;
    }
  }
}

// Grid (blocks per group, head group), persistent over a contiguous share of
// the (batch row, tile) sequence.  Warp w works on units (16 tokens 16 (w %
// TB) .., head w / TB + k * (8 / TB)): q of those tokens and that head's
// columns, then eq . context_h and the output.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1)
linear_attention_any_pass2_bf16_kernel(const bf16* __restrict__ x, Strides sx,
                                       const float* __restrict__ w, const float* __restrict__ g,
                                       const float* mean, const float* rstd,
                                       const float* __restrict__ sums, bf16* __restrict__ out,
                                       Strides so, Args p) {
  constexpr int R = GROUP, HG = GROUP / DP, T = DP == 128 ? 128 : 64, XLD = T + 8, OLD = T + 8;
  constexpr int CLD = DP + 8, KC = KC_BF16;
  constexpr int TB = T / 16, UPW = TB * HG / 8, HSTEP = 8 / TB, NJ = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, group = blockIdx.y;
  const Range rg = block_range((long long)p.B * p.n_tiles);
  if (rg.first >= rg.last) return;
  const int wld = p.resident ? p.cp + 8 : KC + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + R * wld * 2;
  const int xbytes = KC * XLD * 2, sbytes = xbytes + 2 * T * 4;
  bf16* os = reinterpret_cast<bf16*>(ring + p.stages * sbytes);  // output tile, rows = features
  bf16* cs = os + R * OLD;                                         // context, rows (head, d)
  float* u_s = reinterpret_cast<float*>(cs + R * CLD);

  const int nch = p.nch;
  const int n_units = (int)(rg.last - rg.first) * nch;
  auto fetch = [&](int unit) {
    if (unit < n_units) {
      const long long flat = rg.first + unit / nch;
      const int ch = unit % nch;
      unsigned char* slot = ring + (unit % p.stages) * sbytes;
      load_x<bf16>(reinterpret_cast<bf16*>(slot), XLD, reinterpret_cast<float*>(slot + xbytes), x,
                   sx, mean, rstd, p.prenorm && ch == nch - 1, p.aligned,
                   (int)(flat / p.n_tiles), (int)(flat % p.n_tiles) * T, ch * KC, KC, T, p.N, p.C);
    }
    cp_async_commit();
  };
  for (int s = 0; s < p.stages - 1; ++s) fetch(s);
  const int hd = p.heads * p.dh, wcols = 3 * hd;
  const int my_col = group_col(tid % GROUP, DP, group, p.heads, p.dh, 0);
  if (p.resident) stage_w2<bf16>(ws, wld, w, g, 0, p.cp, p.C, wcols, my_col);
  if (p.prenorm && tid < R) u_s[tid] = gain_times_w(w, g, p.C, wcols, my_col);

  float acc[UPW][NJ][4];
  int cur_b = -1;
  const int tb = warp % TB;
  const uint32_t ws_addr = smem_u32(ws), cs_addr = smem_u32(cs);

  for (int un = 0; un < n_units; ++un) {
    cp_async_wait_oldest(p.stages);
    __syncthreads();
    fetch(un + p.stages - 1);
    unsigned char* slot = ring + (un % p.stages) * sbytes;
    const long long flat = rg.first + un / nch;
    const int ch = un % nch;
    const int b = (int)(flat / p.n_tiles), t0 = (int)(flat % p.n_tiles) * T;
    if (ch == 0) {
      if (b != cur_b) {
        // context_h = round(E_h * scale / (s_h * N)), zero in the padding
        const float* sb = sums + (long long)b * hd * (p.dh + 1);
        for (int e = tid; e < R * DP; e += THREADS) {
          const int row = e / DP, ec = e % DP, hl = row / DP, d = row % DP;
          const int h = group * HG + hl;
          float v = 0.0f;
          if (h < p.heads && d < p.dh && ec < p.dh)
            v = (sb[(long long)h * p.dh * p.dh + d * p.dh + ec] * p.scale) /
                (sb[(long long)hd * p.dh + h * p.dh + d] * (float)p.N);
          cs[row * CLD + ec] = __float2bfloat16_rn(v);
        }
        __syncthreads();
        cur_b = b;
      }
#pragma unroll
      for (int k = 0; k < UPW; ++k)
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[k][n][q] = 0.0f;
    }
    const int kv = min(KC, p.cp - ch * KC), wc0 = p.resident ? ch * KC : 0;
    if (!p.resident) {
      stage_w2<bf16>(ws, wld, w, g, ch * KC, kv, p.C, wcols, my_col);
      __syncthreads();
    }
    // projection: acc[k] += x (tokens 16 tb ..) . wt^T (the unit head's columns)
    const uint32_t xs_addr = smem_u32(slot);
    for (int kk = 0; kk < kv; kk += 16) {
      uint32_t af[4];
      ldsm_x4_trans(af, xs_addr + ((kk + (lane & 7) + ((lane >> 4) << 3)) * XLD + 16 * tb +
                                   ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int k = 0; k < UPW; ++k) {
        const int hl = warp / TB + k * HSTEP;
#pragma unroll
        for (int nb = 0; nb < DP / 16; ++nb) {
          uint32_t r[4];
          ldsm_x4(r, ws_addr + ((hl * DP + 16 * nb + (lane & 7) + ((lane >> 4) << 3)) * wld + wc0 +
                                kk + ((lane >> 3) & 1) * 8) * 2);
          mma(acc[k][2 * nb], af, r[0], r[1]);
          mma(acc[k][2 * nb + 1], af, r[2], r[3]);
        }
      }
    }
    if (ch != nch - 1) continue;

    // epilogue: eq = round(exp(clip(q))), den = round(sum_d eq), num =
    // eq . context_h, out = round(round(num) / den)
    const float* st = reinterpret_cast<const float*>(slot + xbytes);
    float m[2], rs[2];
#pragma unroll
    for (int qr = 0; qr < 2; ++qr) {
      const int t = 16 * tb + (lane >> 2) + 8 * qr;
      m[qr] = p.prenorm ? st[t] : 0.0f;
      rs[qr] = p.prenorm ? st[T + t] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < UPW; ++k) {
      const int hl = warp / TB + k * HSTEP;
      const bool head_ok = group * HG + hl < p.heads;
      uint32_t pq[NJ][2];  // eq pairs of columns 8j + 2 (lane % 4), rows (lane / 4) + 8 qr
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const int dl = 8 * jn + 2 * (lane & 3), f = hl * DP + dl;
        const float u0 = p.prenorm ? u_s[f] : 0.0f, u1 = p.prenorm ? u_s[f + 1] : 0.0f;
        const bool ok0 = head_ok && dl < p.dh, ok1 = head_ok && dl + 1 < p.dh;
#pragma unroll
        for (int qr = 0; qr < 2; ++qr) {
          float a0 = acc[k][jn][2 * qr], a1 = acc[k][jn][2 * qr + 1];
          if (p.prenorm) {
            a0 = (a0 - m[qr] * u0) * rs[qr];
            a1 = (a1 - m[qr] * u1) * rs[qr];
          }
          const uint32_t q = pack(a0, a1);
          pq[jn][qr] = pack(ok0 ? clipped_exp_fast(lo(q)) : 0.0f, ok1 ? clipped_exp_fast(hi(q)) : 0.0f);
        }
      }
      float den[2], rden[2];
#pragma unroll
      for (int qr = 0; qr < 2; ++qr) {
        float dsum = 0.0f;
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) dsum += lo(pq[jn][qr]) + hi(pq[jn][qr]);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
        den[qr] = round_bf16(dsum);
        rden[qr] = 1.0f / den[qr];
      }
      float num[NJ][4];
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) num[n][q] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t af[4] = {pq[2 * kk][0], pq[2 * kk][1], pq[2 * kk + 1][0], pq[2 * kk + 1][1]};
#pragma unroll
        for (int nb = 0; nb < DP / 16; ++nb) {  // context rows d = 16 kk .., columns e = 16 nb ..
          uint32_t r[4];
          ldsm_x4_trans(r, cs_addr + ((hl * DP + 16 * kk + (lane & 15)) * CLD + 16 * nb +
                                      (lane >> 4) * 8) * 2);
          mma(num[2 * nb], af, r[0], r[1]);
          mma(num[2 * nb + 1], af, r[2], r[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int qr = 0; qr < 2; ++qr) {
          const int f = hl * DP + 8 * n + 2 * (lane & 3);
          const int t = 16 * tb + (lane >> 2) + 8 * qr;
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
    if (p.aligned_out) {
      for (int e = tid; e < R * (T / 8); e += THREADS) {
        const int f = e / (T / 8), jj = e % (T / 8), tok = t0 + 8 * jj;
        const int F = group_col(f, DP, group, p.heads, p.dh, 0);
        if (F >= 0 && tok < p.N)
          *reinterpret_cast<uint4*>(ob + F * so.c + tok) =
              *reinterpret_cast<const uint4*>(os + f * OLD + 8 * jj);
      }
    } else {
      const bool token_fastest = so.n <= so.c;
      for (int e = tid; e < R * T; e += THREADS) {
        const int t = token_fastest ? e % T : e / R, f = token_fastest ? e / T : e % R;
        const int F = group_col(f, DP, group, p.heads, p.dh, 0);
        if (F >= 0 && t0 + t < p.N) ob[(t0 + t) * so.n + F * so.c] = os[f * OLD + t];
      }
    }
  }
  cp_async_wait_all();
}

// Grid as the bf16 pass 2.  Thread (i = tid / 32, j = tid % 32) projects
// tokens TR i .. TR i + TR-1 onto q columns 4j .. 4j+3 of the group, then
// computes eq . context of those tokens and columns (one head's) from the
// tile's eq in shared memory, rows of columns (a thread's tokens contiguous;
// rows shifted 4 floats per 32 columns, against bank conflicts).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
linear_attention_any_pass2_fp32_kernel(const float* __restrict__ x, Strides sx,
                                       const float* __restrict__ w, const float* __restrict__ g,
                                       const float* mean, const float* rstd,
                                       const float* __restrict__ sums, float* __restrict__ out,
                                       Strides so, Args p) {
  constexpr int R = GROUP, HG = GROUP / DP, T = DP == 128 ? 128 : 64, TR = T / 8, XLD = T + 4;
  constexpr int KC = KC_FP32, ELD = T + 4;  // eq / output rows, one per column
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, i = tid / 32, j = tid % 32, group = blockIdx.y;
  const Range rg = block_range((long long)p.B * p.n_tiles);
  if (rg.first >= rg.last) return;
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (p.resident ? p.cp : KC) * R * 4;
  const int xbytes = KC * XLD * 4, sbytes = xbytes + 2 * T * 4;
  float* eqs = reinterpret_cast<float*>(ring + p.stages * sbytes);
  float* ctx = eqs + R * ELD + 16;
  auto erow = [](int col) { return col * ELD + 4 * (col / 32); };
  float* u_s = ctx + R * DP;

  const int nch = p.nch;
  const int n_units = (int)(rg.last - rg.first) * nch;
  auto fetch = [&](int unit) {
    if (unit < n_units) {
      const long long flat = rg.first + unit / nch;
      const int ch = unit % nch;
      unsigned char* slot = ring + (unit % p.stages) * sbytes;
      load_x<float>(reinterpret_cast<float*>(slot), XLD, reinterpret_cast<float*>(slot + xbytes),
                    x, sx, mean, rstd, p.prenorm && ch == nch - 1, p.aligned,
                    (int)(flat / p.n_tiles), (int)(flat % p.n_tiles) * T, ch * KC, KC, T, p.N, p.C);
    }
    cp_async_commit();
  };
  for (int s = 0; s < p.stages - 1; ++s) fetch(s);
  const int hd = p.heads * p.dh, wcols = 3 * hd;
  const int my_col = group_col(tid % GROUP, DP, group, p.heads, p.dh, 0);
  if (p.resident) stage_w2<float>(ws, 0, w, g, 0, p.cp, p.C, wcols, my_col);
  if (p.prenorm && tid < R) u_s[tid] = gain_times_w(w, g, p.C, wcols, my_col);

  const int hl = (4 * j) / DP, e0 = (4 * j) % DP;
  bool col_ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) col_ok[q] = group_col(4 * j + q, DP, group, p.heads, p.dh, 0) >= 0;
  float acc[TR][4];
  int cur_b = -1;

  for (int un = 0; un < n_units; ++un) {
    cp_async_wait_oldest(p.stages);
    __syncthreads();
    fetch(un + p.stages - 1);
    unsigned char* slot = ring + (un % p.stages) * sbytes;
    const float* xs = reinterpret_cast<const float*>(slot);
    const long long flat = rg.first + un / nch;
    const int ch = un % nch;
    const int b = (int)(flat / p.n_tiles), t0 = (int)(flat % p.n_tiles) * T;
    if (ch == 0) {
      if (b != cur_b) {
        const float* sb = sums + (long long)b * hd * (p.dh + 1);
        for (int e = tid; e < R * DP; e += THREADS) {
          const int row = e / DP, ec = e % DP, h = group * HG + row / DP, d = row % DP;
          float v = 0.0f;
          if (h < p.heads && d < p.dh && ec < p.dh)
            v = (sb[(long long)h * p.dh * p.dh + d * p.dh + ec] * p.scale) /
                (sb[(long long)hd * p.dh + h * p.dh + d] * (float)p.N);
          ctx[e] = v;
        }
        __syncthreads();
        cur_b = b;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
    const int wc0 = p.resident ? ch * KC : 0;
    if (!p.resident) {
      stage_w2<float>(ws, 0, w, g, ch * KC, min(KC, p.cp - ch * KC), p.C, wcols, my_col);
      __syncthreads();
    }
    const int kmax = min(KC, p.C - ch * KC);
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      float av[TR];
#pragma unroll
      for (int r = 0; r < TR; r += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(xs + c * XLD + TR * i + r);
        av[r] = a4.x;
        av[r + 1] = a4.y;
        av[r + 2] = a4.z;
        av[r + 3] = a4.w;
      }
      const float4 wv = *reinterpret_cast<const float4*>(ws + (wc0 + c) * R + 4 * j);
      const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], wq[q], acc[r][q]);
    }
    if (ch != nch - 1) continue;

    const float* st = reinterpret_cast<const float*>(slot + xbytes);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int t = TR * i + r;
      const float m = p.prenorm ? st[t] : 0.0f, rs = p.prenorm ? st[T + t] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float qv = acc[r][q];
        if (p.prenorm) qv = (qv - m * u_s[4 * j + q]) * rs;
        acc[r][q] = col_ok[q] ? clipped_exp(qv) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < TR; r += 4)
        *reinterpret_cast<float4*>(eqs + erow(4 * j + q) + TR * i + r) =
            make_float4(acc[r][q], acc[r + 1][q], acc[r + 2][q], acc[r + 3][q]);
    __syncthreads();
    float num[TR][4], den[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      den[r] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) num[r][q] = 0.0f;
    }
    const float* crow = ctx + hl * DP * DP + e0;
    const float* ehead = eqs + TR * i;
#pragma unroll 4
    for (int d = 0; d < p.dh; ++d) {
      const float4 cc = *reinterpret_cast<const float4*>(crow + d * DP);
      float ev[TR];
#pragma unroll
      for (int r = 0; r < TR; r += 4) {
        const float4 e4 = *reinterpret_cast<const float4*>(ehead + erow(hl * DP + d) + r);
        ev[r] = e4.x;
        ev[r + 1] = e4.y;
        ev[r + 2] = e4.z;
        ev[r + 3] = e4.w;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float a = ev[r];
        num[r][0] = fmaf(a, cc.x, num[r][0]);
        num[r][1] = fmaf(a, cc.y, num[r][1]);
        num[r][2] = fmaf(a, cc.z, num[r][2]);
        num[r][3] = fmaf(a, cc.w, num[r][3]);
        den[r] += a;
      }
    }
    __syncthreads();
    float rden[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) rden[r] = 1.0f / den[r];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < TR; r += 4)
        *reinterpret_cast<float4*>(eqs + erow(4 * j + q) + TR * i + r) = make_float4(
            div_rn(num[r][q], den[r], rden[r]), div_rn(num[r + 1][q], den[r + 1], rden[r + 1]),
            div_rn(num[r + 2][q], den[r + 2], rden[r + 2]),
            div_rn(num[r + 3][q], den[r + 3], rden[r + 3]));
    __syncthreads();
    float* ob = out + b * so.b;
    if (p.aligned_out) {
      for (int e = tid; e < R * (T / 4); e += THREADS) {
        const int f = e / (T / 4), jj = e % (T / 4), tok = t0 + 4 * jj;
        const int F = group_col(f, DP, group, p.heads, p.dh, 0);
        if (F >= 0 && tok < p.N)
          *reinterpret_cast<float4*>(ob + F * so.c + tok) =
              *reinterpret_cast<const float4*>(eqs + erow(f) + 4 * jj);
      }
    } else {
      const bool token_fastest = so.n <= so.c;
      for (int e = tid; e < R * T; e += THREADS) {
        const int t = token_fastest ? e % T : e / R, f = token_fastest ? e / T : e % R;
        const int F = group_col(f, DP, group, p.heads, p.dh, 0);
        if (F >= 0 && t0 + t < p.N) ob[(t0 + t) * so.n + F * so.c] = eqs[erow(f) + t];
      }
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool valid(int B, int N, int C, int heads, int dh) {
  return B >= 1 && B <= MAX_B && N >= 1 && C >= 1 && C <= MAX_C && heads >= 1 &&
         heads <= MAX_HEADS && dh >= 1 && dh <= MAX_DH && heads * dh <= MAX_HIDDEN;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// 16-byte copies reach every group of v tokens of t (B, N, C): token stride
// 1, N and the other strides multiples of v, an aligned base.
bool aligned_rows(const void* t, Strides s, int N, int v) {
  return s.n == 1 && N % v == 0 && s.c % v == 0 && s.b % v == 0 && aligned16(t);
}

template <typename K>
int launch_check(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP>
int pass1_main(bool bf16_io, const void* x, Strides sx, const void* wt, const float* u,
               float* mean, float* rstd, float* partials, const Plan& pl, Args a, int B,
               cudaStream_t s) {
  const int f = bf16_io ? 0 : 1;
  const dim3 grid(pl.grid_x, pl.groups, B);
  int err;
  if (bf16_io) {
    auto k = linear_attention_any_pass1_bf16_kernel<DP>;
    if ((err = launch_check(k, pl.smem[f])) != 0) return err;
    k<<<grid, THREADS, pl.smem[f], s>>>(static_cast<const bf16*>(x), sx,
                                         static_cast<const bf16*>(wt), u, mean, rstd, partials, a);
  } else {
    auto k = linear_attention_any_pass1_fp32_kernel<DP>;
    if ((err = launch_check(k, pl.smem[f])) != 0) return err;
    k<<<grid, THREADS, pl.smem[f], s>>>(static_cast<const float*>(x), sx,
                                         static_cast<const float*>(wt), u, mean, rstd, partials, a);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int pass2_main(bool bf16_io, const void* x, Strides sx, const float* w, const float* g,
               const float* mean, const float* rstd, const float* sums, void* out, Strides so,
               const Plan& pl, Args a, cudaStream_t s) {
  const int f = bf16_io ? 0 : 1;
  const dim3 grid(pl.grid_x, pl.groups);
  int err;
  if (bf16_io) {
    auto k = linear_attention_any_pass2_bf16_kernel<DP>;
    if ((err = launch_check(k, pl.smem[f])) != 0) return err;
    k<<<grid, THREADS, pl.smem[f], s>>>(static_cast<const bf16*>(x), sx, w, g, mean, rstd, sums,
                                         static_cast<bf16*>(out), so, a);
  } else {
    auto k = linear_attention_any_pass2_fp32_kernel<DP>;
    if ((err = launch_check(k, pl.smem[f])) != 0) return err;
    k<<<grid, THREADS, pl.smem[f], s>>>(static_cast<const float*>(x), sx, w, g, mean, rstd, sums,
                                         static_cast<float*>(out), so, a);
  }
  return (int)cudaGetLastError();
}

Args make_args(const Plan& pl, bool bf16_io, int B, int N, int C, int heads, int dh) {
  const int f = bf16_io ? 0 : 1, kc = bf16_io ? KC_BF16 : KC_FP32;
  Args a{};
  a.B = B;
  a.N = N;
  a.C = C;
  a.cp = pl.cp;
  a.heads = heads;
  a.dh = dh;
  a.n_tiles = pl.n_tiles;
  a.chunks = pl.grid_x;
  a.tiles_per_chunk = pl.tiles_per_chunk;
  a.nch = (pl.cp + kc - 1) / kc;
  a.resident = pl.resident[f];
  a.stages = pl.stages[f];
  return a;
}

}  // namespace

extern "C" {

// Pass 1 and its reduction: x (B, N, C) fp32 or bf16 (is_bf16) through its
// element strides, w_qkv (C, 3*heads*dh) fp32, g (C,) fp32 or NULL (no
// prenorm); with g, mean and rstd (B, N) fp32 are computed and written
// (compute_stats) or read.  partials: scratch of at least the plan's
// `scratch` floats (n_partials): the per-chunk slots, every one written
// before it is read, then u and the prepared weights; sums (B,
// heads*dh*(dh+1)) fp32 is written, not added to.  Up to four launches
// (prepare, statistics, pass 1, reduce) on `stream`; returns
// cudaGetLastError() (0 = launched).
int dmh_linear_attention_any_pass1(const void* x, long long sxb, long long sxn, long long sxc,
                                   const float* w_qkv, const float* g, float* mean, float* rstd,
                                   int compute_stats, float* sums, float* partials,
                                   long long n_partials, int B, int N, int C, int heads, int dh,
                                   int is_bf16, void* stream) {
  if (!valid(B, N, C, heads, dh)) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(1, B, N, C, heads, dh);
  if (n_partials < pl.scratch) return (int)cudaErrorInvalidValue;
  const Strides sx{sxb, sxn, sxc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* u = partials + pl.prep_offset;
  void* wt = u + (long long)pl.groups * 2 * GROUP;
  const dim3 pgrid((pl.cp + PREP_COLS - 1) / PREP_COLS + (g ? 1 : 0), pl.groups);
  if (is_bf16)
    linear_attention_any_prep_kernel<bf16><<<pgrid, THREADS, 0, s>>>(
        w_qkv, g, u, static_cast<bf16*>(wt), C, pl.cp, heads, dh, pl.dp);
  else
    linear_attention_any_prep_kernel<float><<<pgrid, THREADS, 0, s>>>(
        w_qkv, g, u, static_cast<float*>(wt), C, pl.cp, heads, dh, pl.dp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (g != nullptr && compute_stats) {
    const dim3 sgrid((N + THREADS / 4 - 1) / (THREADS / 4), B);
    if (is_bf16)
      linear_attention_any_stats_kernel<bf16><<<sgrid, THREADS, 0, s>>>(
          static_cast<const bf16*>(x), sx, mean, rstd, N, C);
    else
      linear_attention_any_stats_kernel<float><<<sgrid, THREADS, 0, s>>>(
          static_cast<const float*>(x), sx, mean, rstd, N, C);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  Args a = make_args(pl, is_bf16, B, N, C, heads, dh);
  a.prenorm = g != nullptr;
  a.aligned = aligned_rows(x, sx, N, is_bf16 ? 8 : 4) &&
              (g == nullptr || (aligned16(mean) && aligned16(rstd)));
  switch (pl.dp) {
    case 16: err = pass1_main<16>(is_bf16, x, sx, wt, u, mean, rstd, partials, pl, a, B, s); break;
    case 32: err = pass1_main<32>(is_bf16, x, sx, wt, u, mean, rstd, partials, pl, a, B, s); break;
    case 64: err = pass1_main<64>(is_bf16, x, sx, wt, u, mean, rstd, partials, pl, a, B, s); break;
    default: err = pass1_main<128>(is_bf16, x, sx, wt, u, mean, rstd, partials, pl, a, B, s);
  }
  if (err) return err;
  const long long total = (long long)B * heads * ((long long)dh * dh + dh);
  linear_attention_any_reduce_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                                       s>>>(partials, sums, B, heads, dh, pl.grid_x);
  return (int)cudaGetLastError();
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
  const Plan pl = make_plan(2, B, N, C, heads, dh);
  Args a = make_args(pl, is_bf16, B, N, C, heads, dh);
  const int v = is_bf16 ? 8 : 4;
  a.prenorm = g != nullptr;
  a.scale = scale;
  a.aligned = aligned_rows(x, sx, N, v) && (g == nullptr || (aligned16(mean) && aligned16(rstd)));
  a.aligned_out = aligned_rows(out, so, N, v);
  switch (pl.dp) {
    case 16: return pass2_main<16>(is_bf16, x, sx, w_qkv, g, mean, rstd, sums, out, so, pl, a, s);
    case 32: return pass2_main<32>(is_bf16, x, sx, w_qkv, g, mean, rstd, sums, out, so, pl, a, s);
    case 64: return pass2_main<64>(is_bf16, x, sx, w_qkv, g, mean, rstd, sums, out, so, pl, a, s);
    default: return pass2_main<128>(is_bf16, x, sx, w_qkv, g, mean, rstd, sums, out, so, pl, a, s);
  }
}

// The plan of pass 1 or 2 at these shapes, into out[15]: grid x (pass 1:
// token chunks; pass 2: persistent blocks per group), grid y (head groups),
// grid z (pass 1: batch; pass 2: 1), threads, the bf16 kernels' dynamic
// shared memory bytes, tokens per tile, tiles per chunk (pass 2: most tiles
// of a block), the scratch floats (low 31 bits; pass 1), the padded
// dim_head, heads per group, the bf16 kernels' resident weights (1) or
// streamed (0) and ring slots, then the fp32 kernels' shared memory, resident
// flag and slots.  Returns 0, or the error a launch would return.
int dmh_linear_attention_any_plan(int pass, int B, int N, int C, int heads, int dh, int* out) {
  if (!valid(B, N, C, heads, dh) || (pass != 1 && pass != 2)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(pass, B, N, C, heads, dh);
  const int vals[15] = {p.grid_x, p.groups, pass == 1 ? B : 1, THREADS, p.smem[0], p.tile,
                        p.tiles_per_chunk, (int)(p.scratch & 0x7fffffff), p.dp, p.hg,
                        p.resident[0], p.stages[0], p.smem[1], p.resident[1], p.stages[1]};
  for (int i = 0; i < 15; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
