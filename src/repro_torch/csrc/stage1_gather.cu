// Stage-1 MSB-nibble (INT4) block gather on Hopper: whole 64-row pieces of
// the gathered plane blocks by TMA, scored on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stage1_gather.py  stage1_int4_gather_pallas
// for the shapes it takes (`stage1_gather_tma_takes` decides, and the
// wrapper in `kernels/stage1_gather.py` asks it): D/2 % 16 == 0 (the
// 16-byte row stride TMA needs), block_rows a multiple of 64, and
// 0 < N < 2^31 (the tensor map's int32 row coordinate). Every other shape
// stays on the dp4a `gather_kernel` of stage1_rows.cu. Both give the same
// bits:
//
//   out[b, r] = sum_j q_even[b, j] * sext4(lo(plane[row, j]))
//             + q_odd[b, j]  * sext4(hi(plane[row, j])),
//   row = ids[b, r / BR] * BR + r % BR; 0 where row >= N (never read).
//
// What bounds it on an H100 at the cluster path's shape (B = 32 lanes x
// J = 128 blocks of BR = 64 rows, D = 512, N = 2^20): the distinct plane
// rows the lanes' tables name (8 probes of 32 lanes hit about 227 of the
// 1024 clusters: about 59 MB) and the 1 MiB of scores, 17.8 us at
// 3.35 TB/s, if lanes that probe the same cluster share its reads in L2;
// every gathered row read once from device memory is 68 MB, 20.3 us. Its
// 0.27 G int8 operations take 0.14 us on the tensor cores: bytes bound it.
//
// Design:
// - A work item is one 64-row piece of one lane's block: lane b, slot j,
//   piece h < BR / 64, at plane row ids[b, j] * BR + 64 h. It arrives as
//   ceil(D2 / 128) TMA boxes of 64 rows x 128 bytes, 128-byte swizzled
//   (mma_ring.cuh's plane map). Rows past N (the ragged last block) or
//   below 0 arrive as zeros and score 0 with no branch.
// - A persistent grid (`grid_blocks`: one block per SM) walks the items
//   slot by slot across lanes, so lanes whose tables name the same block
//   at the same slot read it close together in time (an L2 hit for all
//   but the first; lane-by-lane order measured 2-3 % slower, PERF.md).
//   One producer warp keeps kRingPerWarp boxes in flight for each of the
//   block's kGatherWarps consumer warps: 16 boxes, 128 KiB per SM (the
//   plane scan's ring of 4 boxes holds as many bytes, but its boxes are
//   32 KiB). Each consumer warp has its own share of the ring, so no wait
//   on a barrier skips a phase. The producer warp reads the block ids of
//   its next 32 items with one load per lane while it requests the
//   current 32 items' boxes, so no id load stands between two boxes.
//   Where a block's items all fit in the ring's first fill (8 items at D
//   = 512, as in a resident launch), one lane per box requests them all
//   at once; elsewhere lane 0 requests every box in turn.
// - A consumer warp takes every kGatherWarps-th item of its block: per
//   box, two mma.sync m16n8k32 s8 per 32-byte chunk on the nibble masks of
//   each fragment register (mma_ring.cuh's `mma_kstep`), against its
//   lane's even and odd query words, read from device memory (L1) straight
//   into B-fragment registers. Every column of the n-tile holds the same
//   lane, so no panel sits in shared memory: any B and any D/2 % 16 == 0
//   take the kernel, and the first box is requested before any panel is
//   read. The sums leave
//   as `acc >> 4`, each of a quad's four threads storing one m-tile's
//   rows: two stores of four full 32-byte sectors per item.
// - The kernel reads the (B, D) int8 nibble query as the engine holds
//   it: the 8 bytes of dims 8w ... 8w + 7 are one 8-byte load, and
//   `__byte_perm` turns them into even word w (selector 0x6420) and odd
//   word w (0x7531). So no kernel packs the query per call; a call was
//   61-115 us of host work around a 6.9 us kernel, and the pack was one
//   launch of it (PERF.md).
// - The launcher takes its plane map from mma_ring.cuh's table of recent
//   maps and its grid from the kept occupancy: the serving cache's
//   combined plane is one allocation for the cache's life, so its map is
//   encoded once.
//
// Limits: B and J reach the launcher as int (B, J < 2^31); the tensor
// map's row coordinate is an int32 (N < 2^31).

#include "mma_ring.cuh"

namespace {

constexpr int kGatherWarps = 4;     // consumer warps per block
constexpr int kRingPerWarp = 4;     // boxes in flight per consumer warp
constexpr int kGatherStages = kGatherWarps * kRingPerWarp;
constexpr int kItemRows = kWarpRows;            // plane rows per item
constexpr int kBoxBytes = kItemRows * kSlab;    // 8 KiB

constexpr size_t gather_smem() {
  return 1024 + static_cast<size_t>(kGatherStages) * kBoxBytes
         + 2 * kGatherStages * 8;
}

// The shapes the TMA gather takes; every other one goes to dp4a.
bool tma_takes(long long N, long long d2, int br) {
  return d2 > 0 && d2 % 16 == 0 && br > 0 && br % kItemRows == 0 && N > 0
         && N < (1LL << 31);
}

// Item `item` of (B, J, pieces), slot by slot across lanes, as (lane,
// slot, piece).
__device__ __forceinline__ void decode_item(long long item, int B,
                                            int pieces, int& b, int& j,
                                            int& h) {
  h = static_cast<int>(item % pieces);
  const long long rest = item / pieces;
  b = static_cast<int>(rest % B);
  j = static_cast<int>(rest / B);
}

// q (B, 2 * D2) int8 nibble query; the map covers the (N, D2) uint8 plane
// in boxes of 64 rows; ids (B, J) int32; out (B, J * BR) int32.
__global__ void __launch_bounds__((kGatherWarps + 1) * 32, 1)
gather_tma_kernel(const __grid_constant__ CUtensorMap plane_map,
                  const int8_t* __restrict__ q,
                  const int32_t* __restrict__ ids,
                  int32_t* __restrict__ out, int B, long long N, int J,
                  int BR, int D2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGatherStages
                                               * kBoxBytes);
  uint64_t* empty = full + kGatherStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slabs = (D2 + kSlab - 1) / kSlab;
  const int pieces = BR / kItemRows;
  const long long items = static_cast<long long>(B) * J * pieces;

  // The producer's box row of its local item i (item blockIdx.x + i *
  // gridDim.x, for consumer warp i % kGatherWarps), clamped to [-64, N]:
  // a box there reads no plane row. Lane l of the producer warp holds
  // the row of local item i0 + l; the first 32 rows are read before the
  // barriers are ready.
  auto box_row = [&](long long i) {
    const long long item = blockIdx.x + i * gridDim.x;
    if (item >= items) return 0;
    int b, j, h;
    decode_item(item, B, pieces, b, j, h);
    const long long row =
        static_cast<long long>(ids[static_cast<size_t>(b) * J + j]) * BR
        + static_cast<long long>(h) * kItemRows;
    return static_cast<int>(row < -kItemRows ? -kItemRows
                            : (row > N ? N : row));
  };
  int y = warp == kGatherWarps ? box_row(lane) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGatherStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kGatherWarps) {
    // Box s of local item i: once its stage is released, expect its bytes
    // and request it (`row`: the item's box row).
    auto request = [&](long long i, int s, int row) {
      const int w = static_cast<int>(i % kGatherWarps);
      const long long k = i / kGatherWarps * slabs + s;
      const int st = w * kRingPerWarp + static_cast<int>(k % kRingPerWarp);
      mbar_wait(&empty[st],
                static_cast<uint32_t>((k / kRingPerWarp) & 1) ^ 1u);
      mbar_expect_tx(&full[st], kBoxBytes);
      tma_load(ring + st * kBoxBytes, &plane_map, &full[st], s * kSlab, row);
    };
    // Lane 0 requests each item's boxes in turn, as stages are released.
    // Where the ring's first fill (at most kRingPerWarp boxes of each
    // consumer warp, so none waits on a barrier) holds every item of the
    // block, as in a resident launch, lane t requests box t % slabs of
    // item t / slabs instead, all at once. Where more items follow, the
    // parallel fill measured slower (PERF.md, the cluster shape), and
    // lane 0 requests them all.
    const int fill = slabs > kRingPerWarp
                     ? 0 : kGatherWarps * (kRingPerWarp / slabs);
    const int first = (items - blockIdx.x + gridDim.x - 1) / gridDim.x <= fill
                      ? fill : 0;
    const int mine = lane / slabs;
    const int row0 = __shfl_sync(0xFFFFFFFFu, y, mine);
    if (mine < first && blockIdx.x + mine * gridDim.x < items) {
      request(mine, lane % slabs, row0);
    }
    __syncwarp();
    for (long long i0 = 0;; i0 += 32) {
      const int y_next = box_row(i0 + 32 + lane);
      for (int l = i0 == 0 ? first : 0; l < 32; ++l) {
        const long long i = i0 + l;
        if (blockIdx.x + i * gridDim.x >= items) return;
        const int row = __shfl_sync(0xFFFFFFFFu, y, l);
        if (lane == 0) {
          for (int s = 0; s < slabs; ++s) request(i, s, row);
        }
        __syncwarp();
      }
      y = y_next;
    }
  }

  const int words = D2 / 4;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_s = smem_u32(ring);
  const long long R = static_cast<long long>(J) * BR;
  for (long long i = warp;; i += kGatherWarps) {
    const long long item = blockIdx.x + i * gridDim.x;
    if (item >= items) break;
    int b, j, h;
    decode_item(item, B, pieces, b, j, h);
    // Lane b's query row as 8-byte units, unit w holding dims 8w ... 8w + 7.
    const uint2* q2 = reinterpret_cast<const uint2*>(q)
                      + static_cast<size_t>(b) * words;
    int acc[4][1][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][0][e] = 0;
    for (int s = 0; s < slabs; ++s) {
      const long long k = i / kGatherWarps * slabs + s;
      const int st = warp * kRingPerWarp + static_cast<int>(k % kRingPerWarp);
      uint2 be[kSlab / 32][1], bo[kSlab / 32][1];
#pragma unroll
      for (int kk = 0; kk < kSlab / 32; ++kk) {
        const int w0 = s * (kSlab / 4) + kk * 8 + t;   // words w0, w0 + 4
        const uint2 zero = make_uint2(0u, 0u);
        const uint2 x = w0 < words ? __ldg(q2 + w0) : zero;
        const uint2 y = w0 + 4 < words ? __ldg(q2 + w0 + 4) : zero;
        be[kk][0].x = __byte_perm(x.x, x.y, 0x6420);
        bo[kk][0].x = __byte_perm(x.x, x.y, 0x7531);
        be[kk][0].y = __byte_perm(y.x, y.y, 0x6420);
        bo[kk][0].y = __byte_perm(y.x, y.y, 0x7531);
      }
      const int ksteps = min(kSlab, D2 - s * kSlab + 31) / 32;
      mbar_wait(&full[st], static_cast<uint32_t>((k / kRingPerWarp) & 1));
#pragma unroll
      for (int kk = 0; kk < kSlab / 32; ++kk) {
        if (kk >= ksteps) break;
        mma_kstep<1>(ring_s + st * kBoxBytes, 0, kk, lane, be[kk], bo[kk],
                     acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // Column 2t of the accumulators is lane b's score, as is every column:
    // thread t of each quad stores m-tile t's rows g and g + 8.
    int lo = acc[0][0][0], hi = acc[0][0][2];
#pragma unroll
    for (int mt = 1; mt < 4; ++mt) {
      if (t == mt) {
        lo = acc[mt][0][0];
        hi = acc[mt][0][2];
      }
    }
    int32_t* dst = out + static_cast<size_t>(b) * R
                   + static_cast<long long>(j) * BR + h * kItemRows + t * 16
                   + g;
    dst[0] = lo >> 4;
    dst[8] = hi >> 4;
  }
}

}  // namespace

// 1 when stage1_gather_tma_launch takes this shape, else 0 (the dp4a
// gather_kernel of stage1_rows.cu takes it).
extern "C" int stage1_gather_tma_takes(long long N, int D2, int BR) {
  return tma_takes(N, D2, BR) ? 1 : 0;
}

// q (B, 2 * D2) int8 MSB nibbles and plane (N, D2) uint8, both 16-byte
// aligned; block_ids (B, J) int32, out (B, J * BR) int32. Refuses
// (cudaErrorInvalidValue) a shape stage1_gather_tma_takes gives 0.
extern "C" int stage1_gather_tma_launch(const void* q, const void* plane,
                                        const void* block_ids, void* out,
                                        int B, long long N, int J, int BR,
                                        int D2, void* stream) {
  if (!tma_takes(N, D2, BR) || B <= 0 || J <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  cudaError_t err = cached_plane_map(&map, plane, N, D2, kItemRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = gather_tma_kernel;
  const int threads = (kGatherWarps + 1) * 32;
  const size_t smem = gather_smem();
  const long long items = static_cast<long long>(B) * J * (BR / kItemRows);
  unsigned blocks = 0;
  err = grid_blocks(kernel, threads, smem, items, 1, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int8_t*>(q),
      static_cast<const int32_t*>(block_ids), static_cast<int32_t*>(out), B, N,
      J, BR, D2);
  return static_cast<int>(cudaGetLastError());
}
