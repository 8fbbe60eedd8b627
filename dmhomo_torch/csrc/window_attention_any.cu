// The generic window attention's C entry points (kernels in
// window_attention_any.cuh): forward, backward with its dbias reduction, and
// the launch plan.  Built by ops/build.py with nvcc for sm_90a into a shared
// library called through ctypes by ops/window_attention.py, which takes this
// variant wherever the tuned library (window_attention.cu) does not: N != 64
// tokens or a head dim outside 4, 8, 16, 32.

#include "window_attention_any.cuh"

namespace {

bool valid(int Bn, int N, int C, int heads, const void* mask, int nW) {
  return Bn > 0 && N >= 1 && N <= wa_any::MAX_N && heads > 0 && C % heads == 0 &&
         C / heads <= wa_any::MAX_HD && (!mask || (nW > 0 && Bn % nW == 0));
}

}  // namespace

// qkv (Bn, N, 3C) fp32 or bf16; bias (heads, N, N) fp32; mask (nW, N, N) fp32
// or null; out (Bn, N, C) in the dtype of qkv; all contiguous.  N <= 144,
// head dim C / heads <= 64, Bn a multiple of nW; scale is hd^-0.5 rounded to
// the I/O dtype.  Launches on `stream` and returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int dmh_window_attention_any_fwd(const void* qkv, const float* bias,
                                            const float* mask, void* out, int Bn, int N, int C,
                                            int heads, int nW, float scale, int is_bf16,
                                            void* stream) {
  if (!valid(Bn, N, C, heads, mask, nW)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(wa_any::forward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(qkv), bias, mask, static_cast<__nv_bfloat16*>(out),
        Bn, N, C, heads, nW, scale, s));
  return static_cast<int>(wa_any::forward<float>(static_cast<const float*>(qkv), bias, mask,
                                                 static_cast<float*>(out), Bn, N, C, heads, nW,
                                                 scale, s));
}

// The forward's arguments, plus gout (Bn, N, C) and dqkv (Bn, N, 3C) in the
// dtype of qkv, scale_io = hd^-0.5 rounded to the I/O dtype and scale =
// hd^-0.5 in fp32.  dbias is fp32 (partials, heads, N, N), partials the
// plan's: each block writes its chunk's slab, and a second launch (none for
// one slab) sums the slabs in a fixed order into slab 0, the gradient.
extern "C" int dmh_window_attention_any_bwd(const void* qkv, const float* bias,
                                            const float* mask, const void* gout, void* dqkv,
                                            float* dbias, int Bn, int N, int C, int heads,
                                            int nW, float scale_io, float scale, int is_bf16,
                                            void* stream) {
  if (!valid(Bn, N, C, heads, mask, nW)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = wa_any::backward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(qkv), bias, mask,
        static_cast<const __nv_bfloat16*>(gout), static_cast<__nv_bfloat16*>(dqkv), dbias, Bn,
        N, C, heads, nW, scale_io, scale, s);
  else
    err = wa_any::backward<float>(static_cast<const float*>(qkv), bias, mask,
                                  static_cast<const float*>(gout), static_cast<float*>(dqkv),
                                  dbias, Bn, N, C, heads, nW, scale_io, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const wa_any::Plan p = wa_any::make_plan(Bn, N, C / heads, heads, true);
  if (p.partials == 1) return 0;
  wa_any::Segments ss{};
  const long long elems = static_cast<long long>(heads) * N * N;
  ss.s[0] = {dbias, nullptr, dbias, elems, elems, 0, p.partials, 0};
  ss.count = 1;
  return static_cast<int>(wa_any::launch_reduce(ss, s));
}

// The plan of a forward (backward = 0) or backward launch at these shapes,
// into out[9]: grid x (chunks), grid y (heads), threads, dynamic shared
// memory bytes, windows per round, windows per block, blocks per SM by shared
// memory and threads, dbias partials, the staged slices' row stride.
// Returns 0, or the error a launch would return.
extern "C" int dmh_window_attention_any_plan(int Bn, int N, int C, int heads, int backward,
                                             int* out) {
  if (!valid(Bn, N, C, heads, nullptr, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const wa_any::Plan p = wa_any::make_plan(Bn, N, C / heads, heads, backward != 0);
  if (!wa_any::plan_fits(p)) return static_cast<int>(cudaErrorInvalidValue);
  const int v[9] = {p.grid_x, p.grid_y, p.threads, p.smem, p.windows_per_round,
                    p.windows_per_block, p.blocks_per_sm, p.partials, p.ld};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
