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
// Each computes the identity. A tile of a contiguous tensor is one byte
// range whichever view it is cut from (image rows for 4D and flat, rows of
// the B*H stack for 3D), so the three differ only in the tile -> byte range
// map; on the TPU the views also differed in VMEM layout (C = 64 fills half
// of a 128-lane tile in the 4D view), which has no counterpart here.
//
// Bound: bytes. The probe's shape (32, 370, 463, 64) bf16 is 701.69 MB read
// and 701.69 MB written, 0.419 ms at 3.35 TB/s (H100 SXM).
//
// One design for all three: a ring of bulk copies over a persistent grid
// (ring_copy_kernel), so the tile does not decide how many SMs move bytes;
// the three entry points differ only in the chunk map they pass. The wrapper
// (codon_tpu_torch/kernels/copy.py) checks that rows are a multiple of 16
// bytes and that both pointers are 16-byte aligned, and passes PyTorch's
// current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// A ring of bulk copies over a persistent grid.
//
// The TPU tile stays the unit of the plan: `images` runs of `tiles` tiles,
// each tile_bytes long but the last of a run, last_bytes long (4D and
// flat: the images, the last tile of each cut to H % th rows; 3D: one run,
// the last tile cut to (B*H) % tr rows). Each tile is cut into chunks of
// kChunk bytes, the last chunk of a tile shorter, none crossing a tile's
// end.
// Chunk i is found by integer division (chunk_at, mirrored by
// codon_tpu_torch.kernels.copy.ChunkMap.chunk). The grid is as many blocks
// as the ring's shared memory lets an SM hold, on every SM, whatever the
// tile; block b walks chunks b, b + gridDim.x, ...
//
// A block is one warp, of which one thread works. It keeps kStages stages
// of kChunk bytes in dynamic shared memory, each with an mbarrier: chunk k
// goes to stage k % kStages by cp.async.bulk (global -> shared, completing
// on the stage's mbarrier with its byte count) and back out by
// cp.async.bulk (shared -> global, one bulk group a chunk). A stage is
// loaded again only after the store that read it has finished reading
// (wait_group.read), one chunk behind, so kStages - 1 loads stay in flight.
// No thread touches the staged bytes: the bulk copies alone move them.
// Bulk copies need 16-byte-aligned addresses and sizes that are multiples
// of 16: tiles, chunks and both pointers are (the wrapper checks), and a
// chunk's byte count is below the mbarrier's 2^20 transaction limit.
//
// The ring is fixed at compile time, 4 stages of 32 KB (mirrored by
// CHUNK_BYTES and STAGES in copy.py): on an H100 no ring of 8-64 KB chunks
// and 2-6 stages tried was faster than this one by more than 1%.
// ---------------------------------------------------------------------------

constexpr int kRingThreads = 32;
constexpr int kChunk = 32 * 1024;    // bytes a bulk chunk
constexpr int kStages = 4;           // shared-memory stages a block
constexpr size_t kRingBytes = (size_t)kStages * kChunk + 8 * kStages;
static_assert(kChunk % 16 == 0 && kChunk < (1 << 20),
              "a chunk is whole 16-byte vectors, under an mbarrier's "
              "2^20 transaction count");
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` on the stage's mbarrier
__device__ __forceinline__ void bulk_load(uint32_t stage, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(stage),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, as one bulk group
__device__ __forceinline__ void bulk_store(char* dst, uint32_t stage,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(stage), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

struct ChunkMap {
  long long tile_bytes, last_bytes, tiles, run_bytes, per_tile, per_run;
};

// chunk i -> its byte offset and size
__device__ __forceinline__ void chunk_at(const ChunkMap& m, long long i,
                                         long long* off, uint32_t* bytes) {
  const long long run = i / m.per_run;
  const long long r = i - run * m.per_run;
  const long long t = r / m.per_tile;
  const long long c = r - t * m.per_tile;
  const long long tb = t == m.tiles - 1 ? m.last_bytes : m.tile_bytes;
  const long long start = c * kChunk;
  *off = run * m.run_bytes + t * m.tile_bytes + start;
  *bytes = static_cast<uint32_t>(min((long long)kChunk, tb - start));
}

__global__ void __launch_bounds__(kRingThreads)
ring_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                 ChunkMap m, long long total) {
  extern __shared__ __align__(128) unsigned char ring[];
  const uint32_t stage0 = smem_addr(ring);
  const uint32_t bar0 = stage0 + kStages * kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(bar0 + 8u * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0 || blockIdx.x >= total) return;

  const long long n = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto load = [&](long long k) {
    const uint32_t s = (uint32_t)(k % kStages);
    long long off;
    uint32_t bytes;
    chunk_at(m, blockIdx.x + k * gridDim.x, &off, &bytes);
    bulk_load(stage0 + s * kChunk, src + off, bytes, bar0 + 8u * s);
  };
  for (long long k = 0; k < n && k < kStages; ++k) load(k);
  for (long long k = 0; k < n; ++k) {
    const uint32_t s = (uint32_t)(k % kStages);
    bar_wait(bar0 + 8u * s, (uint32_t)((k / kStages) & 1));
    long long off;
    uint32_t bytes;
    chunk_at(m, blockIdx.x + k * gridDim.x, &off, &bytes);
    bulk_store(dst + off, stage0 + s * kChunk, bytes);
    // refill the stage of chunk k - 1 once its store has read it; the
    // store of chunk k may still be reading
    if (k >= 1 && k - 1 + kStages < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k - 1 + kStages);
    }
  }
  // every store done before the block's shared memory is handed on
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The persistent grid: blocks of the ring an SM holds, times the SMs. Asked
// of the current device once; the kernel's shared-memory opt-in is set on
// that device in the same step.
cudaError_t ring_grid(int* grid) {
  static std::atomic<int> grids[kMaxDevices];
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*grid = grids[dev].load()) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // above 48 KB a launch is refused unless the kernel opts in
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ring_copy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRingBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_copy_kernel, kRingThreads, kRingBytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here: clear it for the next launch
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  if (dev < kMaxDevices) grids[dev].store(*grid);
  return cudaSuccess;
}

cudaError_t launch_ring(const void* src, void* dst, long long tile_bytes,
                        long long last_bytes, long long tiles,
                        long long runs, cudaStream_t st) {
  if (tile_bytes < 16 || tile_bytes % 16 || last_bytes < 16 ||
      last_bytes % 16 || last_bytes > tile_bytes || tiles < 1 || runs < 1)
    return cudaErrorInvalidValue;
  int grid;
  cudaError_t e = ring_grid(&grid);
  if (e != cudaSuccess) return e;
  ChunkMap m;
  m.tile_bytes = tile_bytes;
  m.last_bytes = last_bytes;
  m.tiles = tiles;
  m.run_bytes = (tiles - 1) * tile_bytes + last_bytes;
  m.per_tile = (tile_bytes + kChunk - 1) / kChunk;
  m.per_run = (tiles - 1) * m.per_tile + (last_bytes + kChunk - 1) / kChunk;
  ring_copy_kernel<<<grid, kRingThreads, kRingBytes, st>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), m,
      runs * m.per_run);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tile_bytes = th * W * C * element size; last_bytes = the last tile of an
// image (H - (tiles - 1) * th rows); tiles = ceil(H / th) an image.
int codon_copy4d(const void* src, void* dst, long long tile_bytes,
                 long long last_bytes, long long tiles, long long images,
                 void* stream) {
  return (int)launch_ring(src, dst, tile_bytes, last_bytes, tiles, images,
                          static_cast<cudaStream_t>(stream));
}

// The (B, H, W*C) view: a (1, th, W*C) tile is the same byte range as
// copy4d's (1, th, W, C) tile, so the arguments are copy4d's.
int codon_copyflat(const void* src, void* dst, long long tile_bytes,
                   long long last_bytes, long long tiles, long long images,
                   void* stream) {
  return (int)launch_ring(src, dst, tile_bytes, last_bytes, tiles, images,
                          static_cast<cudaStream_t>(stream));
}

// tile_bytes = tr * W * C * element size; last_bytes = the last tile of the
// R = B * H rows; tiles = ceil(R / tr); one run.
int codon_copy3d(const void* src, void* dst, long long tile_bytes,
                 long long last_bytes, long long tiles, void* stream) {
  return (int)launch_ring(src, dst, tile_bytes, last_bytes, tiles, 1,
                          static_cast<cudaStream_t>(stream));
}

// The persistent grid the three copies launch on the current device, into
// *grid.
int codon_copy_ring_grid(int* grid) { return (int)ring_grid(grid); }

}  // extern "C"
