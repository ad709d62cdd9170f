// The TMA ring and int8 tensor-core scoring of the MSB-nibble plane, shared
// by the plane scan (stage1_mma.cu, `plane_mma_kernel`) and the fused
// score + per-block top-k (fused_topk.cu, `fused_mma_kernel`). The block
// gather (stage1_gather.cu, `gather_tma_kernel`) uses the plane map, the
// barriers, the loads, the product (`mma_kstep`, with its B fragments in
// registers) and the grid, with a ring of its own.
//
// - The product: mma.sync m16n8k32 s8 x s8 -> s32, M = plane rows, N =
//   query lanes (8 per n-tile, up to 4 n-tiles), K = 32 bytes of a packed
//   row. A fragment register w of plane bytes gives (w << 4) & 0xF0F0F0F0
//   (16 * the even-dim nibbles) to the even k-step and w & 0xF0F0F0F0 (16
//   * the odd-dim nibbles) to the odd one, so each 32-byte chunk feeds two
//   MMAs, against q_even and q_odd, and no nibble is unpacked. The sums are
//   16x the score; >> 4 is exact (16 * sext4 lies in [-128, 112]).
// - Plane tiles reach shared memory by TMA: a 2-D tensor map over the
//   (N, D/2) plane with a 128-byte swizzle, boxes of up to 256 rows x 128
//   bytes (rows past N and bytes past D/2 arrive as zeros), a ring of
//   kStages boxes with a full and an empty mbarrier each. The map is
//   encoded on the host through cudaGetDriverEntryPoint, so a library
//   needs no -lcuda. A fragment comes out of a swizzled box by ldmatrix.x4
//   without bank conflicts.
// - A block: ROWS / 64 consumer warps (64 plane rows = 4 m-tiles each,
//   against the whole lane tile) and one producer warp whose lane 0 keeps
//   the ring full (`produce_tiles`). A tile of ROWS rows is loaded as
//   ROWS / 256 row chunks (one box each) times ceil(D/2 / 128) slabs; the
//   warps of a chunk consume its boxes (`consume_tile`), which cycle
//   through the chunk's own share of the ring (so no warp skips a phase
//   of a barrier it waits on). The query panels of the block's lane tile
//   sit in shared memory (`fill_panels`; the plane scan stages them its
//   own way, stage1_mma.cu), each lane's row padded by 32
//   bytes and its words ordered so that one 8-byte load gives a thread
//   both B-fragment registers of a k-step, without bank conflicts.
// - A persistent grid: blocks walk row tiles (grid.x) for one lane tile
//   (grid.y), so the producer loads the next tile's boxes while the
//   consumers finish the current tile's epilogue (`grid_blocks`).
// - The launch path asks the CUDA runtime as little as it can:
//   `grid_blocks` opts a kernel into its shared memory and reads its
//   occupancy once per (kernel, device, threads, bytes), and
//   `cached_plane_map` keeps the plane maps of recent (plane, N, D2, box
//   rows) launches, so a launch over a plane it has seen encodes nothing.
//   Both tables sit behind one mutex: launchers may run on several host
//   threads.
#pragma once

#include <cuda.h>

#include <mutex>

#include "nibble.cuh"

namespace {

constexpr int kSlab = 128;      // row bytes per box: the 128-byte swizzle span
constexpr int kBoxRows = 256;   // TMA's largest box dimension
constexpr int kStages = 4;      // boxes in flight per block
constexpr int kWarpRows = 64;   // plane rows per consumer warp (4 m-tiles)
constexpr int kPanelPad = 32;   // bytes added to each lane's panel row

// The ring's layout for tiles of ROWS plane rows.
template <int ROWS>
struct Ring {
  static constexpr int kBox = ROWS < kBoxRows ? ROWS : kBoxRows;  // box rows
  static constexpr int kChunks = ROWS / kBox;
  static constexpr int kConsumers = ROWS / kWarpRows;
  static constexpr int kBoxWarps = kBox / kWarpRows;
  static constexpr int kRing = kStages / kChunks;  // boxes per chunk's ring
};

// Bytes of one lane's panel row at d2 bytes per plane row.
inline long long panel_pitch(long long d2) {
  return round_up(d2, kSlab) + kPanelPad;
}

// Bytes of shared memory of the ring (with room to align it to 1 KiB), the
// [even; odd] panels of `lanes` lanes and the full and empty barriers.
inline long long ring_smem(int rows, int lanes, long long d2) {
  const long long box_rows = rows < kBoxRows ? rows : kBoxRows;
  return 1024 + kStages * box_rows * kSlab + 2LL * lanes * panel_pitch(d2)
         + 2LL * kStages * 8;
}

// The fewest query lanes the tensor-core kernels take: the plane scan beat
// dp4a from B = 2 on an H100 (PERF.md); B = 1 keeps the dp4a kernels'
// one-lane instances.
constexpr int kMinBatch = 2;

// The lane tile (query lanes per block) for B lanes of d2 bytes at `rows`
// plane rows per tile: the smallest of 8, 16, 32 that covers B (32 past
// it; 16 at most for the 1024-row tile, whose 17 warps leave a thread 96
// registers, below what 32 lanes' accumulators need without spilling),
// halved while smem(lanes), one block's bytes, exceeds what a block may
// hold. 0 when the shape has no instance: B < kMinBatch, d2 % 16 != 0 (the
// 16-byte row stride TMA needs), a `rows` other than 128, 256, 512, 1024,
// or not even 8 lanes fit.
template <typename Smem>
int mma_lane_tile(int B, long long d2, int rows, Smem smem) {
  if (B < kMinBatch || d2 <= 0 || d2 % 16 != 0) return 0;
  if (rows != 128 && rows != 256 && rows != 512 && rows != 1024) return 0;
  const int widest = rows == 1024 ? 16 : 32;
  int lanes = 8;
  while (lanes < B && lanes < widest) lanes *= 2;
  while (lanes >= 8 && smem(lanes) > kMaxSmem) lanes /= 2;
  return lanes >= 8 ? lanes : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A wait
// of more than about ten seconds (2^34 cycles) traps, so a broken pipeline
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// One box of the plane (column x bytes, row y) into shared memory; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += the warp's 64 rows (from row0 of a swizzled box) . lane
// n-tile nt over k-step kk of the box's slab: be[nt] / bo[nt] are the
// thread's B-fragment registers of the even and odd panel (words
// 8 kk + t and 8 kk + t + 4 of the slab, t = lane % 4).
template <int NT>
__device__ __forceinline__ void mma_kstep(uint32_t box, int row0, int kk,
                                          int lane, const uint2 (&be)[NT],
                                          const uint2 (&bo)[NT],
                                          int (&acc)[4][NT][4]) {
  const int mat = lane >> 3, r = lane & 7;   // ldmatrix: matrix, its row
  const int chunk = 2 * kk + (mat >> 1);     // 16-byte chunk in the row
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = row0 + mt * 16 + r + 8 * (mat & 1);
    uint32_t a[4];
    ldmatrix_x4(a, box + row * kSlab + ((chunk ^ (row & 7)) << 4));
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (a[i] << 4) & 0xF0F0F0F0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], v, be[nt].x, be[nt].y);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = a[i] & 0xF0F0F0F0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], v, bo[nt].x, bo[nt].y);
  }
}

// acc[mt][nt] += the warp's 64 rows (from row0 of a swizzled box) . lane
// n-tile nt, over k-steps [0, ksteps) of slab s, the B fragments read from
// the lane tile's panels.
template <int NT>
__device__ __forceinline__ void mma_box(uint32_t box, int row0,
                                        const uint8_t* panel, int pitch,
                                        int s, int ksteps, int lane,
                                        int (&acc)[4][NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* pe = panel + g * pitch + s * kSlab + 8 * t;
  const uint8_t* po = pe + NT * 8 * pitch;
#pragma unroll
  for (int kk = 0; kk < kSlab / 32; ++kk) {
    if (kk >= ksteps) break;
    uint2 be[NT], bo[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      be[nt] = *reinterpret_cast<const uint2*>(pe + nt * 8 * pitch + kk * 32);
      bo[nt] = *reinterpret_cast<const uint2*>(po + nt * 8 * pitch + kk * 32);
    }
    mma_kstep<NT>(box, row0, kk, lane, be, bo, acc);
  }
}

// Thread 0 initialises the barriers; the block fills the lane tile's
// panels, [half][lane][pitch] bytes: within each 32-byte chunk, physical
// word 2i holds word i and 2i + 1 word i + 4, so thread t of a k-step reads
// its B fragment (words t, t + 4) as one 8 bytes. Words past D2 and lanes
// past B are zero. Lane b's half h is row h * half_rows + b * lane_rows of
// the (rows, D2) int8 query operand q. Ends with __syncthreads.
template <int LANES>
__device__ __forceinline__ void fill_panels(uint8_t* panel, int pitch,
                                            uint64_t* full, uint64_t* empty,
                                            int box_warps, const int8_t* q,
                                            int half_rows, int lane_rows,
                                            int B, int D2, int b0) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], box_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int words = pitch / 4;
  uint32_t* panel_w = reinterpret_cast<uint32_t*>(panel);
  const uint32_t* q_w = reinterpret_cast<const uint32_t*>(q);
  for (int i = threadIdx.x; i < 2 * LANES * words; i += blockDim.x) {
    const int half = i / (LANES * words);
    const int l = (i / words) % LANES;
    const int p = i % words;
    const int w = (p & ~7) + ((p & 1) ? 4 + ((p & 7) >> 1) : (p & 7) >> 1);
    uint32_t v = 0;
    if (b0 + l < B && 4 * w < D2) {
      v = q_w[(static_cast<size_t>(half) * half_rows
               + static_cast<size_t>(b0 + l) * lane_rows) * (D2 / 4) + w];
    }
    panel_w[i] = v;
  }
  __syncthreads();
}

// Chunk c's boxes cycle through its own kRing stages, c * kRing on: the
// k-th box of chunk c (k = the block's tile iteration * slabs + the slab)
// sits in stage c * kRing + k % kRing, in that stage's phase k / kRing.
// Only the warps of chunk c wait on those stages, and each of them waits
// on every phase in turn, so a parity wait never passes on an older phase.
// A chunk that starts past N (in the last tile only) is neither loaded nor
// waited for.
//
// The producer (lane 0 of the producer warp): the block's tiles' boxes
// slab by slab, each slab's chunks in turn, so every chunk's warps get
// work while another chunk's ring is full.
template <int ROWS>
__device__ __forceinline__ void produce_tiles(uint8_t* ring, uint64_t* full,
                                              uint64_t* empty,
                                              const CUtensorMap* map,
                                              long long N, int slabs) {
  using R = Ring<ROWS>;
  const long long tiles = (N + ROWS - 1) / ROWS;
  long long i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    for (int s = 0; s < slabs; ++s) {
      const long long k = i * slabs + s;
      for (int c = 0; c < R::kChunks; ++c) {
        const long long y = t * ROWS + static_cast<long long>(c) * R::kBox;
        if (y >= N) break;
        const int st = c * R::kRing + static_cast<int>(k % R::kRing);
        mbar_wait(&empty[st], static_cast<uint32_t>((k / R::kRing) & 1) ^ 1u);
        mbar_expect_tx(&full[st], R::kBox * kSlab);
        tma_load(ring + st * R::kBox * kSlab, map, &full[st], s * kSlab,
                 static_cast<int>(y));
      }
    }
  }
}

// A consumer warp's share of the block's i-th tile: acc += its 64 rows
// (row0 within chunk `chunk`'s box) . the lane tile, over every slab; each
// box is released to the producer right after the warp's last MMA on it.
template <int ROWS, int NT>
__device__ __forceinline__ void consume_tile(uint32_t ring_s, uint64_t* full,
                                             uint64_t* empty,
                                             const uint8_t* panel, int pitch,
                                             long long i, int slabs, int D2,
                                             int chunk, int row0, int lane,
                                             int (&acc)[4][NT][4]) {
  using R = Ring<ROWS>;
  for (int s = 0; s < slabs; ++s) {
    const long long k = i * slabs + s;
    const int st = chunk * R::kRing + static_cast<int>(k % R::kRing);
    mbar_wait(&full[st], static_cast<uint32_t>((k / R::kRing) & 1));
    mma_box<NT>(ring_s + st * R::kBox * kSlab, row0, panel, pitch, s,
                min(kSlab, D2 - s * kSlab + 31) / 32, lane, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The tensor map of an (N, D2) uint8 plane (16-byte aligned, D2 % 16 ==
// 0) in boxes of min(rows, 256) rows x 128 bytes, 128-byte swizzled.
cudaError_t encode_plane_map(CUtensorMap* map, const void* plane,
                             long long N, int D2, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D2),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D2)};
  const cuuint32_t box[2] = {kSlab, static_cast<cuuint32_t>(
                                        rows < kBoxRows ? rows : kBoxRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(plane), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The lock of the launch path's two tables (plane maps, occupancy).
std::mutex& launch_tables_lock() {
  static std::mutex lock;
  return lock;
}

constexpr int kPlaneMaps = 64;   // plane maps kept, the oldest replaced

// encode_plane_map's map for (plane, N, D2, rows), from a table of the
// last kPlaneMaps distinct (plane address, N, D2, box rows): a map is a
// pure function of those four, so an address reused for another shape
// misses, and one reused for the same shape gets a map equal to a new one.
cudaError_t cached_plane_map(CUtensorMap* map, const void* plane,
                             long long N, int D2, int rows) {
  struct Entry {
    CUtensorMap map;
    const void* plane;
    long long N;
    int D2, box;
  };
  static Entry table[kPlaneMaps];
  static int used = 0, next = 0;
  const int box = rows < kBoxRows ? rows : kBoxRows;
  std::lock_guard<std::mutex> hold(launch_tables_lock());
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.plane == plane && e.N == N && e.D2 == D2 && e.box == box) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode_plane_map(map, plane, N, D2, rows);
  if (err != cudaSuccess) return err;
  Entry& e = table[next];
  e.map = *map;
  e.plane = plane;
  e.N = N;
  e.D2 = D2;
  e.box = box;
  next = (next + 1) % kPlaneMaps;
  if (used < kPlaneMaps) ++used;
  return cudaSuccess;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev];
}

constexpr int kOccupancies = 256;   // (kernel, device, threads, bytes) kept

// Blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that fit on one SM of the current device, asked of the runtime
// once per (kernel, device, threads, bytes). The kernel is opted into the
// largest `smem` it was ever asked at on that device, so an answer kept
// for a larger launch stays true after a smaller one. 0 with an error
// when the runtime refuses.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem,
                          int* per_sm) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int per_sm;
  };
  static Entry table[kOccupancies];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(launch_tables_lock());
  size_t opted = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.kernel != key || e.dev != dev) continue;
    if (e.threads == threads && e.smem == smem) {
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
    if (e.smem > opted) opted = e.smem;
  }
  if (smem > opted) {
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (used < kOccupancies) table[used++] = Entry{key, dev, threads, smem,
                                                 *per_sm};
  return cudaSuccess;
}

// The persistent grid.x of `kernel` (one block of `threads` threads and
// `smem` bytes) over `tiles` row tiles for `lane_tiles` lane tiles: as
// many blocks as fit on the card, shared among the lane tiles, at most one
// per tile.
template <typename Kernel>
cudaError_t grid_blocks(Kernel kernel, int threads, size_t smem,
                        long long tiles, unsigned lane_tiles,
                        unsigned* blocks_out) {
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm(kernel, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = static_cast<long long>(sm_count()) * per_sm / lane_tiles;
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  *blocks_out = static_cast<unsigned>(blocks);
  return cudaSuccess;
}

}  // namespace
