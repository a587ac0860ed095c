// CAC-stage kernels of CODONNet for Hopper (sm_90a), with a plain C interface.
//
// Built with plain nvcc into a shared library and bound with ctypes
// (codon_tpu_torch/kernels/_build.py, codon_tpu_torch/kernels/cac.py). No
// PyTorch header is included: the Python wrappers allocate every output and
// scratch buffer with torch.empty, check device, dtype, shape and contiguity,
// and pass raw pointers plus PyTorch's current stream. Every entry point
// returns cudaGetLastError() after its launches; the wrapper raises on a
// non-zero code.
//
// Tensors are contiguous NHWC with C innermost. The element type is float32,
// bfloat16 or float16 (dtype code 0, 1, 2); all accumulation is in float32.
// A thread reads 16 bytes of channels at a time, so C * sizeof(T) is a
// power-of-two multiple of 16 bytes of at most 512 (the wrapper checks):
// one pixel's channels span VPP = C * sizeof(T) / 16 neighbouring threads of
// one warp.
//
// Main-path shape for the bounds below: batch 4, 384 x 480 padded
// (Middlebury 463 x 370 with a mask), C = 64, bfloat16: one tower is
// 4 * 384 * 480 * 64 * 2 B = 94.4 MB. H100 SXM: 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 256;          // 32 threads x 16 B / 2 B
constexpr float kNeg = -3.0e38f;    // "minus infinity" of the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

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

// 16 bytes of T, loaded and stored as one uint4.
template <typename T> struct Pack {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T get(int i) const { return reinterpret_cast<const T*>(&raw)[i]; }
  __device__ __forceinline__ void set(int i, T v) { reinterpret_cast<T*>(&raw)[i] = v; }
};

template <typename T>
__device__ __forceinline__ Pack<T> load16(const T* p) {
  Pack<T> r;
  r.raw = *reinterpret_cast<const uint4*>(p);
  return r;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Pack<T>& r) {
  *reinterpret_cast<uint4*>(p) = r.raw;
}

// ---------------------------------------------------------------------------
// cac_stats
//
// Replaces the TPU kernel `cac_stats` / `_stats_kernel`
// (codon_tpu/kernels/cac.py:124-166, pallas_call at :143).
// Per image: channel sums and (masked) maxes of Fcat = [color | depth]
// (N, 1, 2C) float32, and the channel-pooled max and mean maps over the 2C
// channels, (N, H, W) in the activation type.
//
// Bound: bytes. It reads both towers once, 2 x 94.4 MB at the main-path
// shape, ~57 us at 3.35 TB/s; the mask and the two maps add ~4.4 MB.
// Design: the TPU kernel carried the sums across the H grid in a resident
// output block; Hopper's blocks run in no order, so the reduction is two
// deterministic passes with no float atomics. Pass 1: one block per
// (image, tile of rows; the wrapper picks the rows) streams its rows with 16-byte loads,
// neighbouring threads on neighbouring addresses; each thread keeps its
// channel slice's sums and maxes in registers, the pooled maps come out of a
// shuffle over the VPP threads of a pixel, and the block's per-channel
// partials go to a scratch buffer after a fixed-order shuffle and shared-
// memory reduction. Pass 2: one block per image adds the tiles' partials in
// tile order. The same inputs give the same bits on every run.
// ---------------------------------------------------------------------------

constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
stats_tiles_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ mask, float* __restrict__ part,
                   T* __restrict__ cmax, T* __restrict__ cmean,
                   int H, int W, int C, int tile_h, int tiles) {
  constexpr int V = Pack<T>::N;
  __shared__ float red[kStatsWarps][4][kMaxC];

  const int vpp = C / V;
  const int n = blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = tid % vpp;                       // channel slice [s*V, s*V+V)
  const int per_iter = kStatsThreads / vpp;      // pixels per block step
  const int row0 = t * tile_h;
  const long long npix = (long long)min(tile_h, H - row0) * W;
  const long long base = ((long long)n * H + row0) * W;
  const float denom = (float)(2 * C);

  float sx[V], sy[V], mx[V], my[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sx[i] = 0.f; sy[i] = 0.f; mx[i] = kNeg; my[i] = kNeg;
  }

  // p0 is uniform over the block, so every lane runs every shuffle below
  for (long long p0 = 0; p0 < npix; p0 += per_iter) {
    const long long p = p0 + tid / vpp;
    const bool in = p < npix;
    float px = 0.f, py = 0.f, pm = kNeg;
    if (in) {
      const long long pix = base + p;
      const Pack<T> a = load16(x + pix * C + (long long)s * V);
      const Pack<T> b = load16(y + pix * C + (long long)s * V);
      const bool valid = mask == nullptr || Cvt<T>::to_f(mask[pix]) > 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float av = Cvt<T>::to_f(a.get(i));
        const float bv = Cvt<T>::to_f(b.get(i));
        sx[i] += av;
        sy[i] += bv;
        if (valid) {
          mx[i] = fmaxf(mx[i], av);
          my[i] = fmaxf(my[i], bv);
        }
        px += av;
        py += bv;
        pm = fmaxf(pm, fmaxf(av, bv));
      }
    }
    for (int off = vpp >> 1; off > 0; off >>= 1) {
      px += __shfl_xor_sync(kFull, px, off);
      py += __shfl_xor_sync(kFull, py, off);
      pm = fmaxf(pm, __shfl_xor_sync(kFull, pm, off));
    }
    if (in && s == 0) {
      const long long pix = base + p;
      cmax[pix] = Cvt<T>::from_f(pm);
      cmean[pix] = Cvt<T>::from_f((px + py) / denom);
    }
  }

  // lanes that share a channel slice: fold the warp onto lanes 0..vpp-1
#pragma unroll
  for (int i = 0; i < V; ++i) {
    for (int off = vpp; off < 32; off <<= 1) {
      sx[i] += __shfl_xor_sync(kFull, sx[i], off);
      sy[i] += __shfl_xor_sync(kFull, sy[i], off);
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], off));
      my[i] = fmaxf(my[i], __shfl_xor_sync(kFull, my[i], off));
    }
  }
  if (lane < vpp) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = s * V + i;
      red[warp][0][c] = sy[i];   // Fcat is color first
      red[warp][1][c] = sx[i];
      red[warp][2][c] = my[i];
      red[warp][3][c] = mx[i];
    }
  }
  __syncthreads();
  const int c2 = 2 * C;
  float* out = part + ((long long)n * tiles + t) * 2 * c2;
  for (int cc = tid; cc < c2; cc += kStatsThreads) {
    const int q = cc < C ? 0 : 1;
    const int c = cc < C ? cc : cc - C;
    float sum = 0.f, mxv = kNeg;
    for (int w = 0; w < kStatsWarps; ++w) {
      sum += red[w][q][c];
      mxv = fmaxf(mxv, red[w][q + 2][c]);
    }
    out[cc] = sum;
    out[c2 + cc] = mxv;
  }
}

__global__ void stats_finish_kernel(const float* __restrict__ part,
                                    float* __restrict__ ch_sum,
                                    float* __restrict__ ch_max,
                                    int tiles, int c2) {
  const int n = blockIdx.x;
  for (int cc = threadIdx.x; cc < c2; cc += blockDim.x) {
    float sum = 0.f, mxv = kNeg;
    for (int t = 0; t < tiles; ++t) {
      const float* p = part + ((long long)n * tiles + t) * 2 * c2;
      sum += p[cc];
      mxv = fmaxf(mxv, p[c2 + cc]);
    }
    ch_sum[(long long)n * c2 + cc] = sum;
    ch_max[(long long)n * c2 + cc] = mxv;
  }
}

template <typename T>
cudaError_t launch_stats(const void* x, const void* y, const void* mask,
                         void* part, void* ch_sum, void* ch_max, void* cmax,
                         void* cmean, int n, int h, int w, int c, int tile_h,
                         cudaStream_t st) {
  const int tiles = (h + tile_h - 1) / tile_h;
  stats_tiles_kernel<T><<<dim3(tiles, n), kStatsThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(mask), static_cast<float*>(part),
      static_cast<T*>(cmax), static_cast<T*>(cmean), h, w, c, tile_h, tiles);
  stats_finish_kernel<<<n, 128, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(ch_sum),
      static_cast<float*>(ch_max), tiles, 2 * c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// spatial_logits
//
// Replaces the TPU kernel `spatial_logits` / `_logits_kernel`
// (codon_tpu/kernels/cac.py:188-207, pallas_call at :193): the k x k SAME
// zero-padded 2 -> 1 stencil over the pooled max (weight channel 0) and
// mean (channel 1) maps, float32 accumulation, output in the activation
// type. Taps are summed in the TPU kernel's order (dy outer, dx inner),
// each as acc + (wa * a + wb * b) with every multiply and add rounded on its
// own (no contraction into FMA), so the plain PyTorch version gives the
// same bits in every dtype.
//
// Bound: bytes, 3 maps of (N, H, W) = 4.4 MB at the main-path shape, ~1.3
// us at 3.35 TB/s. Above it sits the rounding rule's instruction floor: 4
// fp32 instructions a tap, 100 an output, ~2.2 us for 737,280 outputs at
// the card's ~33.5 T fp32 instructions/s. So the design spends as few
// other instructions as it can:
// - a block of 32 x 8 threads owns a 64-wide x 32-tall output tile (384
//   blocks at 4 x 384 x 480, under 3 an SM, one wave); each thread
//   computes a 2-wide x 4-tall block of outputs, sliding an 8-row window
//   of 6 columns of each plane through registers: 48 shared-memory reads
//   of 8 bytes for 8 outputs, where one output a thread read 50 floats.
//   Window row r gives output row o its taps of dy = r - o, so each output
//   still receives dy in rising order and, within a row, dx in rising
//   order. A warp reads 64 neighbouring floats of a staged row: no bank
//   conflicts;
// - the 2 k^2 weights are read from device memory once a block into
//   shared memory; every thread of a block reads the same ones, so ptxas
//   keeps them in uniform registers that the multiplies read directly, and
//   a thread needs 64 registers, 4 blocks (32 warps) an SM;
// - both planes of the tile and a k/2 halo are staged once in shared
//   memory as float32, by 16-byte vectors where a row is whole vectors (W
//   a multiple of 16 / sizeof(T) and both maps 16-byte aligned; the staged
//   columns widened to whole vectors, those outside the image zero), every
//   load of a thread issued before the first is converted, and element by
//   element otherwise, in the same kernel.
// k is a template parameter, so every loop over taps, window rows and
// outputs unrolls.
// ---------------------------------------------------------------------------

constexpr int kLogitTX = 32;          // threads across
constexpr int kLogitTY = 8;           // threads down
constexpr int kLogitCols = 2;         // output columns a thread
constexpr int kLogitRows = 4;         // output rows a thread
constexpr int kLogitThreads = kLogitTX * kLogitTY;
constexpr int kLogitTileW = kLogitTX * kLogitCols;   // 64 output columns
constexpr int kLogitTileH = kLogitTY * kLogitRows;   // 32 output rows

// 16 bytes of T -> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack16(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* f,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {    // a bf16 is the high half of its float
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& r, float* f, __half) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kLogitThreads, 4)
spatial_logits_kernel(const T* __restrict__ cmax, const T* __restrict__ cmean,
                      const float* __restrict__ wgt, T* __restrict__ out,
                      int H, int W, bool vec) {
  constexpr int R = K / 2;
  constexpr int V = Pack<T>::N;               // elements a 16-byte vector
  constexpr int SH = kLogitTileH + 2 * R;     // staged rows
  constexpr int SW = kLogitTileW + 2 * R;     // staged columns the taps read
  // staged columns [x0 - V, x0 + 64 + V): whole vectors around the taps'
  // [x0 - R, x0 + 64 + R); staged column C0 holds image column x0 - R
  constexpr int SV = kLogitTileW + 2 * V;
  constexpr int C0 = V - R;
  constexpr int WIN = kLogitCols + K - 1;     // window columns a thread
  static_assert(R <= V, "the halo fits in one vector a side");
  __shared__ __align__(16) float st[2][SH][SV];
  __shared__ __align__(16) float sw[2 * K * K];

  const int x0 = blockIdx.x * kLogitTileW;
  const int y0 = blockIdx.y * kLogitTileH;
  const int tid = threadIdx.y * kLogitTX + threadIdx.x;
  const long long plane = (long long)blockIdx.z * H * W;
  const T* const ma = cmax + plane;          // the two maps of image z
  const T* const mb = cmean + plane;

  // weight (dy, dx, channel): channel 0 multiplies the max map, 1 the mean
  const float wv = tid < 2 * K * K ? wgt[tid] : 0.f;
  if (vec) {
    // item i is vector i % NV of staged row i / NV (the max map's SH rows,
    // then the mean map's), which is also where its floats go in st
    constexpr int NV = SV / V;
    constexpr int ITEMS = 2 * SH * NV;
    constexpr int PER = (ITEMS + kLogitThreads - 1) / kLogitThreads;
    uint4 raw[PER];
    // every load of the thread in flight before the first is used
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * kLogitThreads;
      const int row = i / NV;
      const int p = row >= SH;
      const int gy = y0 - R + row - p * SH, gx = x0 - V + (i - row * NV) * V;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);   // SAME zero padding
      // W is whole vectors: a vector lies wholly inside or outside
      if (i < ITEMS && (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W)
        raw[k] = *reinterpret_cast<const uint4*>((p ? mb : ma) + gy * W + gx);
    }
    float* const flat = &st[0][0][0];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * kLogitThreads;
      if (i < ITEMS) {
        float f[V];
        unpack16(raw[k], f, T());
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          reinterpret_cast<float4*>(flat + i * V)[q] = make_float4(
              f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
      }
    }
  } else {
    for (int i = tid; i < 2 * SH * SW; i += kLogitThreads) {
      const int p = i / (SH * SW);
      const int rem = i - p * (SH * SW);
      const int ly = rem / SW, lx = rem - ly * SW;
      const int gy = y0 - R + ly, gx = x0 - R + lx;
      float v = 0.f;                          // SAME zero padding
      if ((unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W)
        v = Cvt<T>::to_f((p ? mb : ma)[gy * W + gx]);
      st[p][ly][C0 + lx] = v;
    }
  }
  if (tid < 2 * K * K) sw[tid] = wv;
  __syncthreads();

  float wa[K * K], wb[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    wa[t] = sw[2 * t];
    wb[t] = sw[2 * t + 1];
  }
  const int row0 = threadIdx.y * kLogitRows;  // the thread's first output row
  const int col0 = threadIdx.x * kLogitCols;  // and column, in the tile
  float acc[kLogitCols][kLogitRows];
#pragma unroll
  for (int c = 0; c < kLogitCols; ++c)
#pragma unroll
    for (int o = 0; o < kLogitRows; ++o) acc[c][o] = 0.f;
#pragma unroll
  for (int r = 0; r < kLogitRows + 2 * R; ++r) {
    float a[WIN], b[WIN];
#pragma unroll
    for (int x = 0; x < WIN; ++x) {
      a[x] = st[0][row0 + r][C0 + col0 + x];
      b[x] = st[1][row0 + r][C0 + col0 + x];
    }
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
#pragma unroll
      for (int c = 0; c < kLogitCols; ++c) {
#pragma unroll
        for (int o = 0; o < kLogitRows; ++o) {
          const int dy = r - o;
          if (dy >= 0 && dy < K) {
            const float ta = __fmul_rn(wa[dy * K + dx], a[c + dx]);
            const float tb = __fmul_rn(wb[dy * K + dx], b[c + dx]);
            acc[c][o] = __fadd_rn(acc[c][o], __fadd_rn(ta, tb));
          }
        }
      }
    }
  }
  // the thread's outputs, (c, o) at o * W + c from its first
  T* const dst = out + plane + (long long)(y0 + row0) * W + x0 + col0;
  const int cols = W - x0 - col0, rows = H - y0 - row0;
#pragma unroll
  for (int c = 0; c < kLogitCols; ++c)
#pragma unroll
    for (int o = 0; o < kLogitRows; ++o)
      if (c < cols && o < rows) dst[o * W + c] = Cvt<T>::from_f(acc[c][o]);
}

template <typename T>
cudaError_t launch_logits(const void* cmax, const void* cmean, const void* wgt,
                          void* out, int n, int h, int w, int k,
                          cudaStream_t st) {
  // every variant's spatial gate is 5x5
  if (k != 5) return cudaErrorInvalidValue;
  const bool vec = w % Pack<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(cmax) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cmean) % 16 == 0;
  const dim3 grid((w + kLogitTileW - 1) / kLogitTileW,
                  (h + kLogitTileH - 1) / kLogitTileH, n);
  spatial_logits_kernel<T, 5><<<grid, dim3(kLogitTX, kLogitTY), 0, st>>>(
      static_cast<const T*>(cmax), static_cast<const T*>(cmean),
      static_cast<const float*>(wgt), static_cast<T*>(out), h, w, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cac_apply
//
// Replaces the TPU kernel `cac_apply` / `_apply_kernel`
// (codon_tpu/kernels/cac.py:230-253, pallas_call at :239):
// ad = sigmoid(logits[n,h,w]) * gate[n,c] built in float32 and rounded once
// to the activation type, then out * ad + inputs and out_c * ad + inputs_c in
// the activation type (each product and sum rounded, as the TPU kernel and
// PyTorch's elementwise ops round them).
//
// Bound: bytes. 4 reads + 2 writes of a tower, 6 x 94.4 MB at the
// main-path shape, ~169 us at 3.35 TB/s. Design: one pass, each thread one
// 16-byte vector of all four inputs and both outputs, neighbouring threads on
// neighbouring addresses; one block row of the grid per image so the image's
// gate sits in shared memory; the logit is read once per pixel group
// (cached) and its sigmoid recomputed per thread.
// ---------------------------------------------------------------------------

constexpr int kApplyThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
cac_apply_kernel(const T* __restrict__ out, const T* __restrict__ outc,
                 const T* __restrict__ in, const T* __restrict__ inc,
                 const float* __restrict__ gate, const T* __restrict__ logits,
                 T* __restrict__ new_out, T* __restrict__ new_outc,
                 long long hw, int C) {
  constexpr int V = Pack<T>::N;
  __shared__ float sg[kMaxC];
  const int n = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kApplyThreads) sg[c] = gate[(long long)n * C + c];
  __syncthreads();

  const int vpp = C / V;
  const long long v = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
  if (v >= hw * vpp) return;
  const long long pix = (long long)n * hw + v / vpp;
  const int c0 = (int)(v % vpp) * V;
  const float z = Cvt<T>::to_f(logits[pix]);
  const float sp = 1.0f / (1.0f + expf(-z));
  const long long off = pix * C + c0;
  const Pack<T> a = load16(out + off);
  const Pack<T> b = load16(outc + off);
  const Pack<T> p = load16(in + off);
  const Pack<T> q = load16(inc + off);
  Pack<T> ra, rb;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float ad = Cvt<T>::to_f(Cvt<T>::from_f(__fmul_rn(sp, sg[c0 + i])));
    const float ma = Cvt<T>::to_f(Cvt<T>::from_f(__fmul_rn(Cvt<T>::to_f(a.get(i)), ad)));
    const float mb = Cvt<T>::to_f(Cvt<T>::from_f(__fmul_rn(Cvt<T>::to_f(b.get(i)), ad)));
    ra.set(i, Cvt<T>::from_f(__fadd_rn(ma, Cvt<T>::to_f(p.get(i)))));
    rb.set(i, Cvt<T>::from_f(__fadd_rn(mb, Cvt<T>::to_f(q.get(i)))));
  }
  store16(new_out + off, ra);
  store16(new_outc + off, rb);
}

template <typename T>
cudaError_t launch_apply(const void* out, const void* outc, const void* in,
                         const void* inc, const void* gate, const void* logits,
                         void* new_out, void* new_outc, int n, int h, int w,
                         int c, cudaStream_t st) {
  const long long hw = (long long)h * w;
  const long long nvec = hw * (c / Pack<T>::N);
  const dim3 grid((unsigned)((nvec + kApplyThreads - 1) / kApplyThreads), n);
  cac_apply_kernel<T><<<grid, kApplyThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(outc),
      static_cast<const T*>(in), static_cast<const T*>(inc),
      static_cast<const float*>(gate), static_cast<const T*>(logits),
      static_cast<T*>(new_out), static_cast<T*>(new_outc), hw, c);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Each entry point
// returns the launches' cudaGetLastError(), or cudaErrorInvalidValue for a
// dtype code or kernel size it does not take.
#define CODON_DISPATCH(dtype, FN, ...)                                  \
  switch (dtype) {                                                      \
    case 0: return (int)FN<float>(__VA_ARGS__);                         \
    case 1: return (int)FN<__nv_bfloat16>(__VA_ARGS__);                 \
    case 2: return (int)FN<__half>(__VA_ARGS__);                        \
    default: return (int)cudaErrorInvalidValue;                         \
  }

extern "C" {

int codon_cac_stats(int dtype, const void* x, const void* y, const void* mask,
                    void* part, void* ch_sum, void* ch_max, void* cmax,
                    void* cmean, int n, int h, int w, int c, int tile_h,
                    void* stream) {
  CODON_DISPATCH(dtype, launch_stats, x, y, mask, part, ch_sum, ch_max, cmax,
                 cmean, n, h, w, c, tile_h, static_cast<cudaStream_t>(stream));
}

int codon_spatial_logits(int dtype, const void* cmax, const void* cmean,
                         const void* wgt, void* out, int n, int h, int w,
                         int k, void* stream) {
  CODON_DISPATCH(dtype, launch_logits, cmax, cmean, wgt, out, n, h, w, k,
                 static_cast<cudaStream_t>(stream));
}

int codon_cac_apply(int dtype, const void* out, const void* outc,
                    const void* in, const void* inc, const void* gate,
                    const void* logits, void* new_out, void* new_outc, int n,
                    int h, int w, int c, void* stream) {
  CODON_DISPATCH(dtype, launch_apply, out, outc, in, inc, gate, logits,
                 new_out, new_outc, n, h, w, c,
                 static_cast<cudaStream_t>(stream));
}

const char* codon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
