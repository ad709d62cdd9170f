// Stage-1 MSB-nibble (INT4) shared-plane scan on Hopper's int8 tensor
// cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stage1_int4.py  stage1_int4_batched_pallas
// for the shapes it takes (`stage1_mma_lanes` decides, and the batched
// wrapper in `kernels/stage1_int4.py` asks it): D/2 % 16 == 0 (the 16-byte
// row stride TMA needs), at least kMinBatch = 2 query lanes, and a lane
// tile whose query panels fit in shared memory beside the ring. Every
// other shape, and the single-query form, stays on the dp4a `plane_kernel`
// of stage1_plane.cuh. Both return the same bits.
//
//   out[b, n] = sum_j q_even[b, j] * sext4(lo(plane[n, j]))
//             + q_odd[b, j]  * sext4(hi(plane[n, j]))
//
// What bounds it on an H100 at N = 2^20, D = 512, B = 32: it reads the
// 256 MiB plane once and writes the (B, N) int32 scores (128 MiB), about
// 120 us at 3.35 TB/s; its 2*B*N*D = 34 G int8 operations take 17 us on
// the int8 tensor cores. The dp4a kernel spends 4.3 G dp4a on the integer
// pipe (0.45 ms); here the product goes to mma.sync, so bytes bound it.
//
// Design: the shared TMA ring and tensor-core product of mma_ring.cuh
// (boxes of up to 256 rows x 128 bytes, 128-byte swizzled, a ring of 4
// boxes per block, one producer warp and ROWS / 64 consumer warps, two
// mma.sync m16n8k32 s8 per 32-byte chunk on the nibble masks of each
// fragment register, a persistent grid over row tiles), and:
// - Prologue: the producer asks for its first boxes as soon as the
//   barriers are set, while the consumer warps stage the panels
//   (`stage_panels`: 16-byte loads, several in flight per thread). Staged
//   word by word before the first box was asked for (mma_ring.cuh's
//   `fill_panels`, 16-48 load-and-store rounds a thread), they cost a
//   fixed 8-21 us a launch: half of the time at one shard's 131,072 rows
//   (PERF.md, #1 at shard rows).
// - Epilogue: each warp stages an (8 lanes x 64 rows) int32 tile in shared
//   memory and writes each lane's run of rows with 16-byte stores (scalar
//   stores when N % 4 != 0 or at the ragged row edge; lanes past B are not
//   stored), while the producer already loads the next tile's boxes.
//
// `ROWS` (128, 256, 512, 1024) is the schedule knob the autotuner picks,
// as for the dp4a kernel: plane rows per tile (and ROWS / 64 consumer
// warps). It never changes a result. The 1024-row tile takes at most 16
// lanes a block (32 lanes' accumulators would spill).

#include "mma_ring.cuh"

namespace {

constexpr int kEpiPitch = 68;   // int32 per staged lane row (64 + 4)

// Bytes of dynamic shared memory one block of the (rows, lanes) instance
// takes at d2 bytes per row: the ring, panels and barriers, and the
// epilogue's staging.
inline long long mma_smem(int rows, int lanes, long long d2) {
  return ring_smem(rows, lanes, d2)
         + (rows / kWarpRows) * 8LL * kEpiPitch * 4;
}

// The lane tile for this shape (mma_lane_tile on this kernel's plan); 0
// when the dp4a plane kernel keeps it.
int mma_lanes(int B, long long d2, int rows) {
  return mma_lane_tile(B, d2, rows, [rows, d2](int lanes) {
    return mma_smem(rows, lanes, d2);
  });
}

// The lane tile's [even; odd] panels in fill_panels' layout (mma_ring.cuh:
// [half][lane][pitch] bytes, each 32-byte chunk's words ordered 0 4 1 5 2
// 6 3 7, zeros past D2 and past B), staged by the `consumers` consumer
// warps alone while the producer warp already streams the first boxes.
// Each thread moves whole 32-byte chunks, two 16-byte loads and two
// 16-byte stores each, with kStageBatch chunks' loads in flight before
// their stores, so the panels cost a few load latencies and not one per
// word. Ends with a barrier of the consumer warps only (named barrier 1).
constexpr int kStageBatch = 4;

template <int LANES>
__device__ __forceinline__ void stage_panels(uint8_t* panel, int pitch,
                                             const int8_t* __restrict__ q,
                                             int B, int D2, int b0,
                                             int consumers) {
  const int row_chunks = pitch / 32;
  const int total = 2 * LANES * row_chunks;
  const int threads = consumers * 32;
  for (int base = threadIdx.x; base < total;
       base += kStageBatch * threads) {
    uint4 lo[kStageBatch], hi[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int c = base + k * threads;
      lo[k] = hi[k] = make_uint4(0u, 0u, 0u, 0u);
      const int row = c / row_chunks;            // half * LANES + lane
      const int byte = (c - row * row_chunks) * 32;
      const int l = row % LANES;
      if (c < total && b0 + l < B) {
        const uint4* src = reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(row / LANES) * B + b0 + l) * D2 + byte);
        if (byte < D2) lo[k] = __ldg(src);
        if (byte + 16 < D2) hi[k] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int c = base + k * threads;
      if (c < total) {
        uint4* dst = reinterpret_cast<uint4*>(panel + static_cast<size_t>(c)
                                              * 32);
        dst[0] = make_uint4(lo[k].x, hi[k].x, lo[k].y, hi[k].y);
        dst[1] = make_uint4(lo[k].z, hi[k].z, lo[k].w, hi[k].w);
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// q_panel (2, B, D2) int8; the map covers the (N, D2) uint8 plane; out
// (B, N) int32. blockIdx.y is the lane tile (NT * 8 lanes).
template <int ROWS, int NT>
__global__ void __launch_bounds__((ROWS / kWarpRows + 1) * 32, 1)
plane_mma_kernel(const __grid_constant__ CUtensorMap plane_map,
                 const int8_t* __restrict__ q_panel,
                 int32_t* __restrict__ out, int B, long long N, int D2) {
  using R = Ring<ROWS>;
  constexpr int kLanes = NT * 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int slabs = (D2 + kSlab - 1) / kSlab;
  const int pitch = slabs * kSlab + kPanelPad;
  uint8_t* panel = ring + kStages * R::kBox * kSlab;
  int32_t* epi = reinterpret_cast<int32_t*>(panel + 2 * kLanes * pitch);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      epi + R::kConsumers * 8 * kEpiPitch);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * kLanes;
  const long long tiles = (N + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R::kBoxWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == R::kConsumers) {
    if (lane == 0) {
      produce_tiles<ROWS>(ring, full, empty, &plane_map, N, slabs);
    }
    return;
  }
  stage_panels<kLanes>(panel, pitch, q_panel, B, D2, b0, R::kConsumers);

  const int chunk = warp / R::kBoxWarps;
  const int row0 = (warp % R::kBoxWarps) * kWarpRows;   // within the box
  int32_t* stage = epi + warp * 8 * kEpiPitch;
  const uint32_t ring_s = smem_u32(ring);
  const bool vec = N % 4 == 0;
  long long i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const long long base = t * ROWS + static_cast<long long>(chunk) * R::kBox
                           + row0;
    if (t * ROWS + static_cast<long long>(chunk) * R::kBox >= N) continue;
    int acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    consume_tile<ROWS, NT>(ring_s, full, empty, panel, pitch, i, slabs, D2,
                           chunk, row0, lane, acc);

    if (base >= N) continue;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (b0 + nt * 8 >= B) break;
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = mt * 16 + g;
        stage[(2 * q) * kEpiPitch + r] = acc[mt][nt][0] >> 4;
        stage[(2 * q + 1) * kEpiPitch + r] = acc[mt][nt][1] >> 4;
        stage[(2 * q) * kEpiPitch + r + 8] = acc[mt][nt][2] >> 4;
        stage[(2 * q + 1) * kEpiPitch + r + 8] = acc[mt][nt][3] >> 4;
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int idx = it * 32 + lane;
        const int l = idx >> 4;             // lane of the n-tile
        const int r = (idx & 15) * 4;       // first of 4 rows
        const int b = b0 + nt * 8 + l;
        const long long row = base + r;
        if (b >= B || row >= N) continue;
        const int4 v = *reinterpret_cast<const int4*>(stage + l * kEpiPitch + r);
        int32_t* dst = out + static_cast<size_t>(b) * N + row;
        if (vec && row + 4 <= N) {
          *reinterpret_cast<int4*>(dst) = v;
        } else {
          dst[0] = v.x;
          if (row + 1 < N) dst[1] = v.y;
          if (row + 2 < N) dst[2] = v.z;
          if (row + 3 < N) dst[3] = v.w;
        }
      }
    }
  }
}

struct MmaArgs {
  const CUtensorMap* map;
  const int8_t* q;
  int32_t* out;
  int B;
  long long N;
  int D2;
  cudaStream_t stream;
};

template <int ROWS, int NT>
cudaError_t launch_mma(const MmaArgs& a) {
  auto kernel = plane_mma_kernel<ROWS, NT>;
  const int threads = (ROWS / kWarpRows + 1) * 32;
  const size_t smem = static_cast<size_t>(mma_smem(ROWS, NT * 8, a.D2));
  const unsigned lane_tiles = static_cast<unsigned>((a.B + NT * 8 - 1)
                                                    / (NT * 8));
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(kernel, threads, smem,
                                      (a.N + ROWS - 1) / ROWS, lane_tiles,
                                      &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, lane_tiles), threads, smem, a.stream>>>(
      *a.map, a.q, a.out, a.B, a.N, a.D2);
  return cudaGetLastError();
}

// mma_lanes gives the 1024-row tile at most 16 lanes.
template <int ROWS>
cudaError_t launch_mma_lanes(int lanes, const MmaArgs& a) {
  switch (lanes) {
    case 8: return launch_mma<ROWS, 1>(a);
    case 16: return launch_mma<ROWS, 2>(a);
    case 32:
      if constexpr (ROWS < 1024) return launch_mma<ROWS, 4>(a);
      [[fallthrough]];
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The lane tile stage1_mma_launch takes for this shape (mma_lanes); 0
// when the shape goes to the dp4a plane kernel instead.
extern "C" int stage1_mma_lanes(int B, long long D2, int rows) {
  return mma_lanes(B, D2, rows);
}

// q_panel (2, B, D2) int8, plane (N, D2) uint8 (16-byte aligned), out
// (B, N) int32. rows: plane rows per tile, one of 128, 256, 512, 1024.
// Refuses (cudaErrorInvalidValue) a shape stage1_mma_lanes gives 0 and
// N >= 2^31 (the tensor map's int32 row coordinate).
extern "C" int stage1_mma_launch(const void* q_panel, const void* plane,
                                 void* out, int B, long long N, int D2,
                                 int rows, void* stream) {
  const int lanes = mma_lanes(B, D2, rows);
  if (lanes == 0 || N <= 0 || N >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  cudaError_t err = cached_plane_map(&map, plane, N, D2, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MmaArgs a{&map, static_cast<const int8_t*>(q_panel),
                  static_cast<int32_t*>(out), B, N, D2,
                  static_cast<cudaStream_t>(stream)};
  switch (rows) {
    case 128: err = launch_mma_lanes<128>(lanes, a); break;
    case 256: err = launch_mma_lanes<256>(lanes, a); break;
    case 512: err = launch_mma_lanes<512>(lanes, a); break;
    case 1024: err = launch_mma_lanes<1024>(lanes, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
