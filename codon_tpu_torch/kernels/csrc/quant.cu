// The int8 conv's quantize-gather and dequant epilogue for Hopper (sm_90a),
// with a plain C interface.
//
// Built with plain nvcc into the same shared library as cac.cu and bound
// with ctypes (codon_tpu_torch/kernels/_build.py, kernels/quant.py). No
// PyTorch header is included: the Python wrappers allocate every output,
// check device, dtype, shape, contiguity and alignment, and pass raw
// pointers plus PyTorch's current stream. Every entry point returns
// cudaGetLastError() after its launch; the wrapper raises on a non-zero
// code.
//
// No Pallas source. On the TPU, XLA fused the quantize into the int8 conv's
// input and the dequant into its epilogue (codon_tpu/quant_ops.py:103-131,
// 346-370). PyTorch has no int8 conv, so kernels/quant.py runs it as
// quant_im2col -> torch._int_mm (cuBLASLt, int8 x int8 -> int32) ->
// dequant_epilogue over blocks of images. quant_im2col writes the int8
// patches from the activations in two passes of 1-byte codes, and
// dequant_epilogue the masked activation-dtype output straight from the
// int32 products: the plain route on the card would build float patches (4
// bytes an element, x25 at the 5x5 sites) before it quantized them, and
// three more passes to rescale and mask.
//
// The kernels round exactly as their plain versions (and the JAX package)
// do: a true IEEE division, round half to even, clamp to +-127; every
// product rounded on its own (no FMA contraction). The same inputs give
// the same bits as the plain versions, which chip_smoke.py and the CUDA
// tests hold them to.
//
// Dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8 (quant_im2col's
// input only, already on the site's grid).
//
// Grouped convs (the merged-tower forward's two towers in one tensor, JAX's
// feature_group_count=2) run group by group over one quantized input: the
// gather reads a channel window [c0, c0 + cg) of the C-channel codes (row
// pitch C), and the epilogue writes a column window [o0, o0 + cog) of the
// C_out-channel output (row pitch C_out). The quantize pass runs once a
// conv, over all C channels, not once a group.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;             // int8 codes in one 16-byte vector
constexpr int kBlocksPerSM = 16;     // grid-stride grids: 132 SMs x 16

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half_rn(v); }
};

// 16 consecutive elements of T -> float, in 16-byte loads.
template <typename T>
__device__ __forceinline__ void load16f(const T* p, float* v) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kVec / per; ++j) {
    uint4 raw = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < per; ++i) v[j * per + i] = Cvt<T>::to_f(e[i]);
  }
}

// round(v / s) clipped to +-127: jnp.round and torch.round round half to
// even, as rintf does in the default rounding mode
__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// ---------------------------------------------------------------------------
// quant_im2col
//
// x (N, H, W, C) NHWC -> patches (N*H*W, k*k*C) int8, row-major, a row's K
// ordered (dy, dx, c) as the folded HWIO weights reshaped to (K, C_out).
// Float input is quantized on the site's grid, round(x / s) clipped to
// +-127, s per channel (mode 1, static) or per image (mode 2, dynamic);
// int8 input (mode 0) is already on it. SAME padding is written as code 0.
//
// Bound: bytes. It writes N*H*W*k*k*C bytes of codes and reads x once
// (4 x 184,320 x 3,200 B = 2.36 GB of patches at a 5x5, 128-channel site
// of the main path, ~0.70 ms at 3.35 TB/s; the reads of x add 1/25 of that
// in int8, 2/25 in bfloat16).
//
// Design: two passes. quantize_kernel divides each element once into an
// int8 NHWC scratch (the first version quantized inside the gather, once a
// tap: 25 IEEE divisions an element at a 5x5 site, 4.3x its byte bound on
// the H100); im2col_gather_kernel then copies 16-byte vectors of codes,
// one thread a vector (16 channels of one tap of one pixel), neighbouring
// threads on neighbouring vectors, so every store is a full coalesced
// 16-byte write and the k*k re-reads of a pixel's codes come from L2. A 1x1
// site on float input is the quantize pass alone. Grid-stride loops over
// 32-bit vector indices (the wrapper keeps a block of patches under 2 GiB,
// 2^27 vectors).
// ---------------------------------------------------------------------------

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                int8_t* __restrict__ out, int C, unsigned image_vecs,
                unsigned total) {
  const unsigned cv = C / kVec;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    float vals[kVec];
    load16f(x + (size_t)v * kVec, vals);
    const unsigned c0 = (v % cv) * kVec;
    const unsigned img = v / image_vecs;
    uint4 codes;
    int8_t* q = reinterpret_cast<int8_t*>(&codes);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float s = MODE == 1 ? __ldg(scale + c0 + i) : __ldg(scale + img);
      q[i] = quantize(vals[i], s);
    }
    reinterpret_cast<uint4*>(out)[v] = codes;
  }
}

__global__ void __launch_bounds__(kThreads)
im2col_gather_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                     int H, int W, int C, int k, int c0, int cg,
                     unsigned total) {
  const unsigned cv = cg / kVec;               // vectors of a pixel's window
  const unsigned kv = (unsigned)(k * k) * cv;  // vectors of a patch row
  const int r = k / 2;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const unsigned row = v / kv;
    const unsigned rem = v - row * kv;
    const unsigned tap = rem / cv;
    const unsigned g = rem - tap * cv;
    const int dy = (int)tap / k;
    const int dx = (int)tap - dy * k;
    const unsigned t = row / (unsigned)W;
    const int px = (int)(row - t * (unsigned)W);
    const unsigned img = t / (unsigned)H;
    const int py = (int)(t - img * (unsigned)H);
    const int sy = py + dy - r;
    const int sx = px + dx - r;
    uint4 codes = make_uint4(0u, 0u, 0u, 0u);
    if (sy >= 0 && sy < H && sx >= 0 && sx < W)
      codes = *reinterpret_cast<const uint4*>(
          x + (((size_t)img * H + sy) * W + sx) * C + c0 + g * kVec);
    reinterpret_cast<uint4*>(out)[v] = codes;
  }
}

// ---------------------------------------------------------------------------
// dequant_epilogue
//
// acc (N*H*W, C) int32 -> columns [o0, o0 + C) of out (N, H, W, pitch) in
// T (pitch = C_out of the whole output; C and o0 = 0 but for a group of a
// grouped conv), each element
//   a = T(float(acc))                 (round_to(out_dt, acc))
//   y = T(a * T(sw[c]))               static
//   y = T(a * T(sx[n] * sw[c]))       dynamic (sx * sw in float32)
//   y = T(y * mask[pixel])            with a validity mask
// as `acc * sw.astype(out_dt)` then `apply_mask` in the JAX package.
//
// Bound: bytes. It reads 4 bytes and writes sizeof(T) a product (4 x
// 184,320 x 128 x 6 B = 566 MB at a 128-channel bf16 site of the main
// path, ~0.17 ms). Design: one thread 8 consecutive outputs of one pixel
// (two 16-byte loads of int32, one or two 16-byte stores), the mask value
// and the image's scale read once a thread.
// ---------------------------------------------------------------------------

template <typename T, bool DYN, bool MASK>
__global__ void __launch_bounds__(kThreads)
dequant_epilogue_kernel(const int32_t* __restrict__ acc,
                        const float* __restrict__ sw,
                        const float* __restrict__ sx,
                        const T* __restrict__ mask, T* __restrict__ out,
                        int C, int pitch, int o0, unsigned hw,
                        unsigned total) {
  const unsigned per_row = C / 8;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const unsigned row = v / per_row;
    const int c0 = (int)(v - row * per_row) * 8;
    const size_t at = (size_t)row * C + c0;
    const int4 a0 = reinterpret_cast<const int4*>(acc + at)[0];
    const int4 a1 = reinterpret_cast<const int4*>(acc + at)[1];
    const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float m = MASK ? Cvt<T>::to_f(mask[row]) : 1.f;
    const float sxv = DYN ? __ldg(sx + row / hw) : 1.f;
    uint4 u[sizeof(T) / 2];
    T* y = reinterpret_cast<T*>(u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = DYN ? __fmul_rn(sxv, __ldg(sw + c0 + i))
                          : __ldg(sw + c0 + i);
      const float av = Cvt<T>::to_f(Cvt<T>::from_f(__int2float_rn(a[i])));
      const float sv = Cvt<T>::to_f(Cvt<T>::from_f(s));
      float o = Cvt<T>::to_f(Cvt<T>::from_f(__fmul_rn(av, sv)));
      if (MASK) o = __fmul_rn(o, m);
      y[i] = Cvt<T>::from_f(o);
    }
#pragma unroll
    for (int j = 0; j < (int)(sizeof(T) / 2); ++j)
      reinterpret_cast<uint4*>(out + (size_t)row * pitch + o0 + c0)[j] = u[j];
  }
}

int grid_for(unsigned total) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned need = (total + kThreads - 1) / kThreads;
  const unsigned cap = (unsigned)sms * kBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

template <typename T>
void launch_quantize(const void* x, const float* scale, int mode, void* out,
                     int C, unsigned image_vecs, unsigned total,
                     cudaStream_t st) {
  const int grid = grid_for(total);
  const T* xt = static_cast<const T*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  if (mode == 1)
    quantize_kernel<T, 1><<<grid, kThreads, 0, st>>>(xt, scale, o, C, image_vecs, total);
  else
    quantize_kernel<T, 2><<<grid, kThreads, 0, st>>>(xt, scale, o, C, image_vecs, total);
}

template <typename T>
void launch_epilogue(const int32_t* acc, const float* sw, const float* sx,
                     const void* mask, void* out, int C, int pitch, int o0,
                     unsigned hw, unsigned total, cudaStream_t st) {
  const int grid = grid_for(total);
  const T* m = static_cast<const T*>(mask);
  T* o = static_cast<T*>(out);
  if (sx && m)
    dequant_epilogue_kernel<T, true, true><<<grid, kThreads, 0, st>>>(acc, sw, sx, m, o, C, pitch, o0, hw, total);
  else if (sx)
    dequant_epilogue_kernel<T, true, false><<<grid, kThreads, 0, st>>>(acc, sw, sx, m, o, C, pitch, o0, hw, total);
  else if (m)
    dequant_epilogue_kernel<T, false, true><<<grid, kThreads, 0, st>>>(acc, sw, sx, m, o, C, pitch, o0, hw, total);
  else
    dequant_epilogue_kernel<T, false, false><<<grid, kThreads, 0, st>>>(acc, sw, sx, m, o, C, pitch, o0, hw, total);
}

}  // namespace

extern "C" {

// x (n, h, w, c) of dtype code `dtype` (0-2 float, 3 int8); mode 0 (int8
// input, scale null), 1 (scale[c]) or 2 (scale[n]); the channel window
// [c0, c0 + cg) is gathered; scratch (n, h, w, c) int8 for float input
// unless k = 1 and the window is all of c, else unused; out (n*h*w,
// k*k*cg) int8. c, c0 and cg are multiples of 16, k odd; n*h*w*k*k*cg/16
// and n*h*w*c/16 < 2^32.
int codon_quant_im2col(int dtype, const void* x, const float* scale,
                       int mode, void* scratch, void* out, int n, int h,
                       int w, int c, int k, int c0, int cg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned pix_vecs = (unsigned)((size_t)n * h * w * (c / kVec));
  const unsigned total =
      (unsigned)((size_t)n * h * w * (cg / kVec)) * (unsigned)(k * k);
  if (total == 0) return 0;
  const bool whole = k == 1 && c0 == 0 && cg == c;
  const void* codes = x;
  if (dtype != 3) {
    // the quantize pass: straight into the patches at a 1x1 site that
    // takes every channel
    void* dst = whole ? out : scratch;
    const unsigned image_vecs = (unsigned)((size_t)h * w * (c / kVec));
    if (dtype == 0)
      launch_quantize<float>(x, scale, mode, dst, c, image_vecs, pix_vecs, st);
    else if (dtype == 1)
      launch_quantize<__nv_bfloat16>(x, scale, mode, dst, c, image_vecs, pix_vecs, st);
    else
      launch_quantize<__half>(x, scale, mode, dst, c, image_vecs, pix_vecs, st);
    if (whole) return (int)cudaGetLastError();
    codes = scratch;
  }
  im2col_gather_kernel<<<grid_for(total), kThreads, 0, st>>>(
      static_cast<const int8_t*>(codes), static_cast<int8_t*>(out), h, w, c,
      k, c0, cg, total);
  return (int)cudaGetLastError();
}

// acc (n*h*w, c) int32; sw (c,) float32; sx (n,) float32 or null; mask
// (n, h, w) of the output dtype or null; out (n, h, w, pitch), its columns
// [o0, o0 + c) written. c, pitch and o0 are multiples of 8.
int codon_dequant_epilogue(int dtype, const int32_t* acc, const float* sw,
                           const float* sx, const void* mask, void* out,
                           int n, int h, int w, int c, int pitch, int o0,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned hw = (unsigned)h * (unsigned)w;
  const unsigned total = (unsigned)((size_t)n * hw * (c / 8));
  if (total == 0) return 0;
  if (dtype == 0)
    launch_epilogue<float>(acc, sw, sx, mask, out, c, pitch, o0, hw, total, st);
  else if (dtype == 1)
    launch_epilogue<__nv_bfloat16>(acc, sw, sx, mask, out, c, pitch, o0, hw,
                                   total, st);
  else
    launch_epilogue<__half>(acc, sw, sx, mask, out, c, pitch, o0, hw, total,
                            st);
  return (int)cudaGetLastError();
}

}  // extern "C"
