// Copy kernels of the HBM copy probe for Hopper (sm_90a), with a plain C
// interface.
//
// Replace the three Pallas copies of scripts/perf_pallas_probe.py:
//   codon_copy4d    copy4d(th)    pallas_call at :65, (1, th, W, C) tiles
//                                 over grid (B, ceil(H / th))
//   codon_copyflat  copyflat(th)  pallas_call at :75, (1, th, W*C) tiles
//                                 over grid (B, ceil(H / th))
//   codon_copy3d    copy3d(tr)    pallas_call at :85, (tr, W, C) tiles
//                                 over grid (ceil(B*H / tr),)
// Each computes the identity. What the probe varies is how the work is cut
// into blocks: here one thread block does the work of one TPU tile. A tile
// of a contiguous tensor is one byte range whichever view it is cut from
// (image rows for 4D and flat, rows of the B*H stack for 3D), so the three
// differ only in the tile -> byte range map and in the grid; on the TPU the
// views also differed in VMEM layout (C = 64 fills half of a 128-lane tile
// in the 4D view), which has no counterpart here.
//
// Bound: bytes. The probe's shape (32, 370, 463, 64) bf16 is 701.69 MB read
// and 701.69 MB written, 0.419 ms at 3.35 TB/s (H100 SXM). Design: a block
// of kThreads threads walks its range in 16-byte vectors, neighbouring
// threads on neighbouring addresses; each thread issues kUnroll loads
// before it stores, so a block keeps kThreads * kUnroll * 16 B = 32 KB in
// flight. The grid is the TPU's: 192 blocks for 4D th = 64 on 132 SMs, 24
// for 3D tr = 512. That decomposition, and the ragged last tile (370 % 64 =
// 50 rows, 11840 % 512 = 64 rows), is what the probe measures; it is not
// tuned away. The wrapper (codon_tpu_torch/kernels/copy.py) plans the grid,
// checks that rows are a multiple of 16 bytes and that both pointers are
// 16-byte aligned, and passes PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// Copy n 16-byte vectors from src to dst with the whole block.
__device__ __forceinline__ void copy_vectors(const uint4* __restrict__ src,
                                             uint4* __restrict__ dst,
                                             long long n) {
  long long i = threadIdx.x;
  const long long step = (long long)kThreads * kUnroll;
  for (; i + (long long)(kUnroll - 1) * kThreads < n; i += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + (long long)u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + (long long)u * kThreads] = v[u];
  }
  for (; i < n; i += kThreads) dst[i] = src[i];
}

// 4D: blockIdx.y = image b, blockIdx.x = tile j of th image rows; a row is
// W pixels of pixel_vecs vectors.
__global__ void __launch_bounds__(kThreads)
copy4d_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int H,
              int W, int pixel_vecs, int th) {
  const int r0 = blockIdx.x * th;
  const int rows = min(th, H - r0);
  if (rows <= 0) return;
  const long long row_vecs = (long long)W * pixel_vecs;
  const long long off = ((long long)blockIdx.y * H + r0) * row_vecs;
  copy_vectors(src + off, dst + off, rows * row_vecs);
}

// flat: the (B, H, W*C) view; blockIdx.y = image, blockIdx.x = tile of th
// rows of row_vecs vectors.
__global__ void __launch_bounds__(kThreads)
copyflat_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int H,
                long long row_vecs, int th) {
  const int r0 = blockIdx.x * th;
  const int rows = min(th, H - r0);
  if (rows <= 0) return;
  const long long off = ((long long)blockIdx.y * H + r0) * row_vecs;
  copy_vectors(src + off, dst + off, rows * row_vecs);
}

// 3D: the (B*H, W, C) view; blockIdx.x = tile of tr of the R = B*H rows.
__global__ void __launch_bounds__(kThreads)
copy3d_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int R,
              long long row_vecs, int tr) {
  const long long r0 = (long long)blockIdx.x * tr;
  const long long rows = min((long long)tr, R - r0);
  if (rows <= 0) return;
  const long long off = r0 * row_vecs;
  copy_vectors(src + off, dst + off, rows * row_vecs);
}

}  // namespace

extern "C" {

// pixel_bytes = C * element size; grid = (tiles, B) as the wrapper planned.
int codon_copy4d(const void* src, void* dst, int B, int H, int W,
                 int pixel_bytes, int th, int tiles, void* stream) {
  copy4d_kernel<<<dim3(tiles, B), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), H, W,
      pixel_bytes / 16, th);
  return static_cast<int>(cudaGetLastError());
}

// row_bytes = W * C * element size; grid = (tiles, B).
int codon_copyflat(const void* src, void* dst, int B, int H,
                   long long row_bytes, int th, int tiles, void* stream) {
  copyflat_kernel<<<dim3(tiles, B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), H,
      row_bytes / 16, th);
  return static_cast<int>(cudaGetLastError());
}

// R = B * H rows of row_bytes; grid = (tiles,).
int codon_copy3d(const void* src, void* dst, int R, long long row_bytes,
                 int tr, int tiles, void* stream) {
  copy3d_kernel<<<dim3(tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), R,
      row_bytes / 16, tr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
