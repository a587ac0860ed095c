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
// Tensors are NHWC with C innermost. The element type is float32, bfloat16
// or float16 (dtype code 0, 1, 2); all accumulation is in float32. A tower
// (cac_stats' two inputs, cac_apply's four inputs and two outputs) may be
// a channel window of a wider tensor: its C channels are contiguous, and
// `pitch` elements lie between one pixel's first channel and the next's
// (C for a contiguous tower; 2C for a half of the merged-tower forward's
// (N, H, W, 2C) tensor, read and written in place). The wrappers pass
// each tower's own first element, 16-byte aligned, with the pitch a
// whole number of 16-byte vectors.
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

#include <atomic>

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

// a load of data read once: evict-first in L1 and L2 (ld.global.cs)
template <typename T>
__device__ __forceinline__ Pack<T> load16_stream(const T* p) {
  Pack<T> r;
  r.raw = __ldcs(reinterpret_cast<const uint4*>(p));
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
// shape, ~57 us at 3.35 TB/s; the mask and the two maps add ~4.4 MB. At the
// training shape (16, 64, 64, 64) the towers are 16.8 MB, ~5 us: there a
// launch and the reduction's tail are a large share of the time.
//
// Design: one launch a call.
// - Chunks. Each image is cut into chunks of `rows` whole rows (the last
//   one shorter); chunk i is image i / per_image's chunk i % per_image. The
//   wrapper picks `rows` from (N, H, W) alone (kernels/cac.py `stats_plan`,
//   which mirrors this map): about 256 chunks a call (a constant: one
//   wave of an H100's 2 x 132 resident blocks), at most 64 an image, and
//   at least 256 pixels a chunk where the image has them. The b4 eval
//   gets 64 chunks of 6 rows an image, each TTA8 batch 16 of 24 or 30
//   rows, the training step 16 of 4 rows: 256 chunks each.
// - A persistent grid: the blocks the card holds at once (SMs x resident
//   blocks, asked of the occupancy API once a device), each walking chunks
//   i = blockIdx.x, + gridDim.x, ... (one chunk a block at the shapes
//   above). A chunk's per-channel partials go to its own slot i of the
//   scratch buffer, whichever block computes it.
// - Bytes in flight. A warp streams a run of 4 x 32 / VPP neighbouring
//   pixels an iteration: every lane issues its 16-byte load of each tower
//   for all 4 steps (and one lane in a pixel's group its mask element)
//   before the first value is used, 8 loads of 16 bytes a thread; the
//   mask reaches the pixel's other lanes by shuffle. Each thread keeps its
//   channel slice's sums and maxes in registers; the pooled maps come out
//   of a shuffle tree over the VPP lanes of a pixel, and the warp writes
//   its run of each map in one store instruction. Towers larger than the
//   L2 cache are loaded evict-first (ld.global.cs): they stream through
//   it, and the cache stays with the slots and the maps.
// - One pass. At the end of a chunk the block folds its warps' partials
//   (shuffles, then shared memory sized to C) into the chunk's slot, and
//   takes a ticket from its image's arrival counter. The block that draws
//   the image's last ticket adds the image's per_image slots and writes
//   ch_sum / ch_max: thread (g, v) adds float4 v of the slots g, g + G,
//   g + 2G, ... in turn (G = 256 / C), then the G sums are added in order
//   g = 0, 1, ... (kernels/cac.py `StatsPlan.reduce_groups`). This is the
//   single-pass pattern, a __threadfence() between a block's partials and
//   its ticket; no float atomics.
//
// Bits. Every sum is added in an order fixed by (N, H, W, C) alone: the
// same inputs give the same bits on every run and on any number of SMs.
// Up to 4 images a call the order does not depend on N, so an image of
// the b4 eval gives the same bits alone or in any part of its batch (a
// data-parallel split changes nothing). A spatial shard of an image is an
// image of its own rows: its sums are added in its own order, and the
// mesh adds the shards' sums after that, so a sharded image's sums differ
// from the whole image's in the last bits (as with the two-pass kernel).
// The pooled maps and every max do not depend on any order.
//
// Tickets. The arrival counters are a __device__ array of this module,
// one counter an image of the call (so at most kStatsTicketSlots images):
// the loader zeroes it once on each device, when the module is loaded
// there, and the block that draws an image's last ticket sets that
// counter back to zero before the launch ends. So every launch starts
// from zeros, which makes the counters safe
// - back to back, and in a CUDA graph captured once and replayed any
//   number of times: the launches of one stream run one after another,
//   and each leaves the counters as it found them;
// - in a torch.export artifact, which calls the same op and so the same
//   kernel;
// - in each rank of the mesh, and each device of a process: every process
//   and every device has its own copy of the array.
// Two launches that run at the same time on one device, from two streams,
// would share the counters: every caller of the port launches its CAC
// kernels on one stream a device.
// ---------------------------------------------------------------------------

constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kStatsUnroll = 4;           // pixel steps a thread loads at once
constexpr int kStatsMinBlocks = 2;        // blocks an SM: <= 128 registers
constexpr int kStatsTicketSlots = 65536;  // images a call at most
constexpr int kMaxDevices = 64;

__device__ unsigned int g_stats_tickets[kStatsTicketSlots];

// VPP = C * sizeof(T) / 16: the lanes that share a pixel; EVICT_FIRST:
// the towers' loads evict-first in L1 and L2
template <typename T, int VPP, bool EVICT_FIRST>
__global__ void __launch_bounds__(kStatsThreads, kStatsMinBlocks)
cac_stats_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ mask, float* __restrict__ part,
                 float* __restrict__ ch_sum, float* __restrict__ ch_max,
                 T* __restrict__ cmax, T* __restrict__ cmean, int H, int W,
                 int pitch, int rows, int per_image, int chunks) {
  constexpr int V = Pack<T>::N;             // channels a lane
  constexpr int C = VPP * V;
  constexpr int U = kStatsUnroll;
  constexpr int PG = 32 / VPP;              // pixels of a warp a step
  constexpr int RUN = U * PG;               // pixels of a warp an iteration
  constexpr int STEP = kStatsWarps * RUN;   // pixels of the block an iteration
  constexpr int Q = (U + VPP - 1) / VPP;    // steps of a lane's mask / maps
  constexpr int G = kStatsThreads / C;      // groups of the last block's sum
  extern __shared__ float4 smem[];   // max(warps x 4C floats, 256 float4s)
  float* const red = reinterpret_cast<float*>(smem);
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = lane % VPP;                 // channel slice [s*V, s*V+V)
  const int j = lane / VPP;                 // pixel of the step
  const int lead = lane - s;                // the pixel's first lane
  const float denom = (float)(2 * C);

  for (int i = blockIdx.x; i < chunks; i += gridDim.x) {
    const int n = i / per_image;
    const int row0 = (i - n * per_image) * rows;
    const int npix = min(rows, H - row0) * W;
    const long long base = ((long long)n * H + row0) * W;   // first pixel
    const T* const xs = x + base * pitch + s * V;
    const T* const ys = y + base * pitch + s * V;

    float sx[V], sy[V], mx[V], my[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sx[e] = 0.f; sy[e] = 0.f; mx[e] = kNeg; my[e] = kNeg;
    }

    // p0: the warp's first pixel; warp-uniform, so every lane of a warp
    // runs every shuffle below
    for (int p0 = warp * RUN; p0 < npix; p0 += STEP) {
      Pack<T> a[U], b[U];
      float mq[Q];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * PG + j;
        a[u].raw = make_uint4(0u, 0u, 0u, 0u);
        b[u].raw = make_uint4(0u, 0u, 0u, 0u);
        if (p < npix) {
          a[u] = EVICT_FIRST ? load16_stream(xs + (long long)p * pitch)
                             : load16(xs + (long long)p * pitch);
          b[u] = EVICT_FIRST ? load16_stream(ys + (long long)p * pitch)
                             : load16(ys + (long long)p * pitch);
        }
      }
      if (mask != nullptr) {
        // lane s holds the mask of steps s, s + VPP, ...
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int u = s + q * VPP;
          const int p = p0 + u * PG + j;
          mq[q] = u < U && p < npix ? Cvt<T>::to_f(mask[base + p]) : 0.f;
        }
      }
      float ps[U], pm[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        bool valid = p0 + u * PG + j < npix;
        if (mask != nullptr)
          valid = __shfl_sync(kFull, mq[u / VPP], lead + u % VPP) > 0.f;
        float px = 0.f, py = 0.f, pmax = kNeg;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float av = Cvt<T>::to_f(a[u].get(e));
          const float bv = Cvt<T>::to_f(b[u].get(e));
          sx[e] += av;
          sy[e] += bv;
          if (valid) {
            mx[e] = fmaxf(mx[e], av);
            my[e] = fmaxf(my[e], bv);
          }
          px += av;
          py += bv;
          pmax = fmaxf(pmax, fmaxf(av, bv));
        }
        ps[u] = px + py;
        pm[u] = pmax;
      }
#pragma unroll
      for (int off = VPP / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          ps[u] += __shfl_xor_sync(kFull, ps[u], off);
          pm[u] = fmaxf(pm[u], __shfl_xor_sync(kFull, pm[u], off));
        }
      }
      // lane s writes steps s, s + VPP, ... of its pixel: the warp's run
      // of each map in one store instruction where VPP >= U
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int u = s + q * VPP;
        const int p = p0 + u * PG + j;
        if (u < U && p < npix) {
          float vs = ps[0], vm = pm[0];
#pragma unroll
          for (int t = 1; t < U; ++t) {
            if (u == t) {
              vs = ps[t];
              vm = pm[t];
            }
          }
          cmax[base + p] = Cvt<T>::from_f(vm);
          cmean[base + p] = Cvt<T>::from_f(vs / denom);
        }
      }
    }

    // lanes that share a channel slice: fold the warp onto lanes 0..VPP-1
#pragma unroll
    for (int off = VPP; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sx[e] += __shfl_xor_sync(kFull, sx[e], off);
        sy[e] += __shfl_xor_sync(kFull, sy[e], off);
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], off));
        my[e] = fmaxf(my[e], __shfl_xor_sync(kFull, my[e], off));
      }
    }
    if (lane < VPP) {
      // the warp's 4C values: Fcat's sums (color first), then its maxes
      float4* const w4 = reinterpret_cast<float4*>(red + warp * 4 * C + s * V);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        w4[e / 4] = make_float4(sy[e], sy[e + 1], sy[e + 2], sy[e + 3]);
        w4[(C + e) / 4] = make_float4(sx[e], sx[e + 1], sx[e + 2], sx[e + 3]);
        w4[(2 * C + e) / 4] = make_float4(my[e], my[e + 1], my[e + 2],
                                          my[e + 3]);
        w4[(3 * C + e) / 4] = make_float4(mx[e], mx[e + 1], mx[e + 2],
                                          mx[e + 3]);
      }
    }
    __syncthreads();
    float* const slot = part + (long long)i * 4 * C;
    for (int v = tid; v < 4 * C; v += kStatsThreads) {
      float acc = v < 2 * C ? 0.f : kNeg;
#pragma unroll
      for (int w = 0; w < kStatsWarps; ++w) {
        const float r = red[w * 4 * C + v];
        acc = v < 2 * C ? acc + r : fmaxf(acc, r);
      }
      slot[v] = acc;
    }
    // the block's slot is visible to every block before its ticket is
    // (the barrier, then one thread's fence: the pattern of the
    // cooperative-groups grid barrier), and the last ticket's holder sees
    // every other block's slot after its own fence and the barrier
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(&g_stats_tickets[n], 1u) == (unsigned)per_image - 1u;
      if (last) {
        g_stats_tickets[n] = 0u;    // for the next launch
        __threadfence();
      }
    }
    __syncthreads();
    if (last) {
      // every slot of image n is written: add them in the fixed order
      const float4* const slots =
          reinterpret_cast<const float4*>(part) + (long long)n * per_image * C;
      const int v = tid % C, g = tid / C;
      const bool sum = v < C / 2;           // float4s 0..C/2-1: the sums
      float4 acc = sum ? make_float4(0.f, 0.f, 0.f, 0.f)
                       : make_float4(kNeg, kNeg, kNeg, kNeg);
#pragma unroll 16
      for (int k = g; k < per_image; k += G) {
        const float4 r = __ldcg(slots + (long long)k * C + v);
        if (sum) {
          acc.x += r.x; acc.y += r.y; acc.z += r.z; acc.w += r.w;
        } else {
          acc.x = fmaxf(acc.x, r.x); acc.y = fmaxf(acc.y, r.y);
          acc.z = fmaxf(acc.z, r.z); acc.w = fmaxf(acc.w, r.w);
        }
      }
      smem[g * C + v] = acc;
      __syncthreads();
      if (tid < C) {
        float4 t = smem[v];
        for (int q = 1; q < G; ++q) {
          const float4 r = smem[q * C + v];
          if (sum) {
            t.x += r.x; t.y += r.y; t.z += r.z; t.w += r.w;
          } else {
            t.x = fmaxf(t.x, r.x); t.y = fmaxf(t.y, r.y);
            t.z = fmaxf(t.z, r.z); t.w = fmaxf(t.w, r.w);
          }
        }
        float4* const dst = sum
            ? reinterpret_cast<float4*>(ch_sum) + (long long)n * (C / 2) + v
            : reinterpret_cast<float4*>(ch_max) + (long long)n * (C / 2) +
                  (v - C / 2);
        *dst = t;
      }
      // shared memory is the next chunk's again
      __syncthreads();
    }
  }
}

// Blocks of cac_stats_kernel<T, VPP, EF> the current device holds at
// once: its SMs times the blocks an SM holds, found once a device.
template <typename T, int VPP, bool EF>
cudaError_t stats_grid(size_t smem, int* grid) {
  static std::atomic<int> grids[kMaxDevices];
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*grid = grids[dev].load()) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cac_stats_kernel<T, VPP, EF>, kStatsThreads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here: clear it for the next launch
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  if (dev < kMaxDevices) grids[dev].store(*grid);
  return cudaSuccess;
}

// The current device's L2 cache, in bytes, found once a device.
cudaError_t device_l2(long long* bytes) {
  static std::atomic<int> l2s[kMaxDevices];
  int dev, l2;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (l2 = l2s[dev].load()) > 0) {
    *bytes = l2;
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  *bytes = l2;
  if (dev < kMaxDevices) l2s[dev].store(l2);
  return cudaSuccess;
}

template <typename T, int VPP, bool EF>
cudaError_t launch_stats_ef(const void* x, const void* y, const void* mask,
                            void* part, void* ch_sum, void* ch_max,
                            void* cmax, void* cmean, int n, int h, int w,
                            int pitch, int rows, size_t smem,
                            cudaStream_t st) {
  const int per_image = (h + rows - 1) / rows;
  const int chunks = n * per_image;
  int grid;
  cudaError_t e = stats_grid<T, VPP, EF>(smem, &grid);
  if (e != cudaSuccess) return e;
  cac_stats_kernel<T, VPP, EF><<<grid < chunks ? grid : chunks,
                                 kStatsThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(mask), static_cast<float*>(part),
      static_cast<float*>(ch_sum), static_cast<float*>(ch_max),
      static_cast<T*>(cmax), static_cast<T*>(cmean), h, w, pitch, rows,
      per_image, chunks);
  return cudaGetLastError();
}

template <typename T, int VPP>
cudaError_t launch_stats_vpp(const void* x, const void* y, const void* mask,
                             void* part, void* ch_sum, void* ch_max,
                             void* cmax, void* cmean, int n, int h, int w,
                             int c, int pitch, int rows, cudaStream_t st) {
  constexpr int C = VPP * Pack<T>::N;
  if (c != C) return cudaErrorInvalidValue;
  const size_t smem = kStatsWarps * 4 * C * sizeof(float) >
                              kStatsThreads * sizeof(float4)
                          ? kStatsWarps * 4 * C * sizeof(float)
                          : kStatsThreads * sizeof(float4);
  long long l2;
  cudaError_t e = device_l2(&l2);
  if (e != cudaSuccess) return e;
  // towers larger than L2 stream through it: evict-first loads leave the
  // cache to the slots and maps (perf_stats_probe on an H100: the b4 eval
  // 70.7 -> 67.5 us); smaller ones may stay for the stage's next read
  const bool evict_first = 2LL * n * h * w * C * (long long)sizeof(T) > l2;
  return evict_first
             ? launch_stats_ef<T, VPP, true>(x, y, mask, part, ch_sum, ch_max,
                                             cmax, cmean, n, h, w, pitch,
                                             rows, smem, st)
             : launch_stats_ef<T, VPP, false>(x, y, mask, part, ch_sum,
                                              ch_max, cmax, cmean, n, h, w,
                                              pitch, rows, smem, st);
}

template <typename T>
cudaError_t launch_stats(const void* x, const void* y, const void* mask,
                         void* part, void* ch_sum, void* ch_max, void* cmax,
                         void* cmean, int n, int h, int w, int c, int pitch,
                         int rows, cudaStream_t st) {
  if (n < 1 || h < 1 || w < 1 || rows < 1 || n > kStatsTicketSlots)
    return cudaErrorInvalidValue;
#define CODON_STATS_VPP(VPP)                                              \
  case VPP:                                                               \
    return launch_stats_vpp<T, VPP>(x, y, mask, part, ch_sum, ch_max,     \
                                    cmax, cmean, n, h, w, c, pitch, rows, st);
  switch (c * (int)sizeof(T) / 16) {
    CODON_STATS_VPP(1)
    CODON_STATS_VPP(2)
    CODON_STATS_VPP(4)
    CODON_STATS_VPP(8)
    CODON_STATS_VPP(16)
    CODON_STATS_VPP(32)
    default: return cudaErrorInvalidValue;
  }
#undef CODON_STATS_VPP
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
// (cached) and its sigmoid recomputed per thread. The inputs share one
// pitch and the outputs another, so the merged-tower forward reads the
// halves of T and of its stem output in place and writes the next T, both
// halves, in this one pass: no split before it and no concat after.
// ---------------------------------------------------------------------------

constexpr int kApplyThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
cac_apply_kernel(const T* __restrict__ out, const T* __restrict__ outc,
                 const T* __restrict__ in, const T* __restrict__ inc,
                 const float* __restrict__ gate, const T* __restrict__ logits,
                 T* __restrict__ new_out, T* __restrict__ new_outc,
                 long long hw, int C, int in_pitch, int out_pitch) {
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
  const long long off = pix * in_pitch + c0;
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
  const long long dst = pix * out_pitch + c0;
  store16(new_out + dst, ra);
  store16(new_outc + dst, rb);
}

template <typename T>
cudaError_t launch_apply(const void* out, const void* outc, const void* in,
                         const void* inc, const void* gate, const void* logits,
                         void* new_out, void* new_outc, int n, int h, int w,
                         int c, int in_pitch, int out_pitch, cudaStream_t st) {
  const long long hw = (long long)h * w;
  const long long nvec = hw * (c / Pack<T>::N);
  const dim3 grid((unsigned)((nvec + kApplyThreads - 1) / kApplyThreads), n);
  cac_apply_kernel<T><<<grid, kApplyThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(outc),
      static_cast<const T*>(in), static_cast<const T*>(inc),
      static_cast<const float*>(gate), static_cast<const T*>(logits),
      static_cast<T*>(new_out), static_cast<T*>(new_outc), hw, c, in_pitch,
      out_pitch);
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

// x, y: towers of pitch `pitch` (>= c), the others contiguous; part:
// n * ceil(h / rows) slots of 4c floats, one a chunk of `rows` rows
int codon_cac_stats(int dtype, const void* x, const void* y, const void* mask,
                    void* part, void* ch_sum, void* ch_max, void* cmax,
                    void* cmean, int n, int h, int w, int c, int pitch,
                    int rows, void* stream) {
  CODON_DISPATCH(dtype, launch_stats, x, y, mask, part, ch_sum, ch_max, cmax,
                 cmean, n, h, w, c, pitch, rows,
                 static_cast<cudaStream_t>(stream));
}

int codon_spatial_logits(int dtype, const void* cmax, const void* cmean,
                         const void* wgt, void* out, int n, int h, int w,
                         int k, void* stream) {
  CODON_DISPATCH(dtype, launch_logits, cmax, cmean, wgt, out, n, h, w, k,
                 static_cast<cudaStream_t>(stream));
}

// out, outc, in, inc: towers of pitch in_pitch; new_out, new_outc of pitch
// out_pitch (both >= c); gate and logits contiguous
int codon_cac_apply(int dtype, const void* out, const void* outc,
                    const void* in, const void* inc, const void* gate,
                    const void* logits, void* new_out, void* new_outc, int n,
                    int h, int w, int c, int in_pitch, int out_pitch,
                    void* stream) {
  CODON_DISPATCH(dtype, launch_apply, out, outc, in, inc, gate, logits,
                 new_out, new_outc, n, h, w, c, in_pitch, out_pitch,
                 static_cast<cudaStream_t>(stream));
}

const char* codon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
