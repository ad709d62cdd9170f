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
// of stage1_int4.cu. Both return the same bits.
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
// Design.
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
//   encoded on the host through cudaGetDriverEntryPoint, so the library
//   needs no -lcuda. A fragment comes out of a swizzled box by ldmatrix.x4
//   without bank conflicts.
// - The block: ROWS / 64 consumer warps (64 plane rows = 4 m-tiles each,
//   against the whole lane tile) and one producer warp whose lane 0 keeps
//   the ring full. A tile of ROWS rows is loaded as ROWS / 256 row chunks
//   (one box each) times ceil(D/2 / 128) slabs; the warps of a chunk
//   consume its boxes, which cycle through the chunk's own share of the
//   ring (so no warp skips a phase of a barrier it waits on). The query
//   panels of the block's lane tile sit in shared memory, each lane's row
//   padded by 32 bytes and its words ordered so that one 8-byte load gives
//   a thread both B-fragment registers of a k-step, without bank
//   conflicts.
// - Epilogue: each warp stages an (8 lanes x 64 rows) int32 tile in shared
//   memory and writes each lane's run of rows with 16-byte stores (scalar
//   stores when N % 4 != 0 or at the ragged row edge; lanes past B are not
//   stored).
// - A persistent grid: as many blocks as fit on the card per lane tile
//   (grid.y), each walking row tiles, so the producer loads the next
//   tile's boxes while the consumers finish the current tile's epilogue.
//
// `ROWS` (128, 256, 512, 1024) is the schedule knob the autotuner picks,
// as for the dp4a kernel: plane rows per tile (and ROWS / 64 consumer
// warps). It never changes a result. The 1024-row tile takes at most 16
// lanes a block (32 lanes' accumulators would spill).

#include <cuda.h>

#include "nibble.cuh"

namespace {

constexpr int kSlab = 128;      // row bytes per box: the 128-byte swizzle span
constexpr int kBoxRows = 256;   // TMA's largest box dimension
constexpr int kStages = 4;      // boxes in flight per block
constexpr int kWarpRows = 64;   // plane rows per consumer warp (4 m-tiles)
constexpr int kPanelPad = 32;   // bytes added to each lane's panel row
constexpr int kEpiPitch = 68;   // int32 per staged lane row (64 + 4)
// The fewest query lanes this kernel takes: it beat dp4a from B = 2 on an
// H100 (PERF.md); B = 1 keeps the dp4a kernel's one-lane instance.
constexpr int kMinBatch = 2;

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

// Bytes of dynamic shared memory one block of the (rows, lanes) instance
// takes at d2 bytes per row.
inline long long mma_smem(int rows, int lanes, long long d2) {
  const long long box_rows = rows < kBoxRows ? rows : kBoxRows;
  const long long pitch = round_up(d2, kSlab) + kPanelPad;
  return 1024                                   // room to align the ring
         + kStages * box_rows * kSlab           // the ring
         + 2LL * lanes * pitch                  // [even; odd] panels
         + (rows / kWarpRows) * 8LL * kEpiPitch * 4  // epilogue staging
         + 2LL * kStages * 8;                   // full and empty barriers
}

// The lane tile (query lanes per block) for B lanes of d2 bytes at `rows`
// plane rows per tile: the smallest of 8, 16, 32 that covers B (32 past
// it; 16 at most for the 1024-row tile, whose 17 warps leave a thread 96
// registers, below what 32 lanes' accumulators need without spilling),
// halved while one block would not fit in shared memory. 0 when this
// kernel does not take the shape: B < kMinBatch, d2 % 16 != 0, a `rows`
// with no instance, or not even 8 lanes' panels fit.
int mma_lanes(int B, long long d2, int rows) {
  if (B < kMinBatch || d2 <= 0 || d2 % 16 != 0) return 0;
  if (rows != 128 && rows != 256 && rows != 512 && rows != 1024) return 0;
  const int widest = rows == 1024 ? 16 : 32;
  int lanes = 8;
  while (lanes < B && lanes < widest) lanes *= 2;
  while (lanes >= 8 && mma_smem(rows, lanes, d2) > kMaxSmem) lanes /= 2;
  return lanes >= 8 ? lanes : 0;
}

// acc[mt][nt] += the warp's 64 rows (from row0 of a swizzled box) . lane
// n-tile nt, over k-steps [0, ksteps) of slab s.
template <int NT>
__device__ __forceinline__ void mma_box(uint32_t box, int row0,
                                        const uint8_t* panel, int pitch,
                                        int s, int ksteps, int lane,
                                        int (&acc)[4][NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, r = lane & 7;   // ldmatrix: matrix, its row
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
    const int chunk = 2 * kk + (mat >> 1);   // 16-byte chunk in the row
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
}

// q_panel (2, B, D2) int8; the map covers the (N, D2) uint8 plane; out
// (B, N) int32. blockIdx.y is the lane tile (NT * 8 lanes).
template <int ROWS, int NT>
__global__ void __launch_bounds__((ROWS / kWarpRows + 1) * 32, 1)
plane_mma_kernel(const __grid_constant__ CUtensorMap plane_map,
                 const int8_t* __restrict__ q_panel,
                 int32_t* __restrict__ out, int B, long long N, int D2) {
  constexpr int kBox = ROWS < kBoxRows ? ROWS : kBoxRows;  // rows per box
  constexpr int kChunks = ROWS / kBox;
  constexpr int kConsumers = ROWS / kWarpRows;
  constexpr int kBoxWarps = kBox / kWarpRows;
  constexpr int kLanes = NT * 8;
  constexpr int kRing = kStages / kChunks;   // boxes per chunk's sub-ring
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int slabs = (D2 + kSlab - 1) / kSlab;
  const int pitch = slabs * kSlab + kPanelPad;
  uint8_t* panel = ring + kStages * kBox * kSlab;
  int32_t* epi = reinterpret_cast<int32_t*>(panel + 2 * kLanes * pitch);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      epi + kConsumers * 8 * kEpiPitch);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * kLanes;
  const long long tiles = (N + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBoxWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The lane tile's panels, [half][lane][pitch] bytes; within each 32-byte
  // chunk, physical word 2i holds word i and 2i + 1 word i + 4, so thread
  // t of a k-step reads its B fragment (words t, t + 4) as one 8 bytes.
  // Words past D2 and lanes past B are zero.
  const int words = pitch / 4;
  uint32_t* panel_w = reinterpret_cast<uint32_t*>(panel);
  const uint32_t* q_w = reinterpret_cast<const uint32_t*>(q_panel);
  for (int i = threadIdx.x; i < 2 * kLanes * words; i += blockDim.x) {
    const int half = i / (kLanes * words);
    const int l = (i / words) % kLanes;
    const int p = i % words;
    const int w = (p & ~7) + ((p & 1) ? 4 + ((p & 7) >> 1) : (p & 7) >> 1);
    uint32_t v = 0;
    if (b0 + l < B && 4 * w < D2) {
      v = q_w[(static_cast<size_t>(half) * B + b0 + l) * (D2 / 4) + w];
    }
    panel_w[i] = v;
  }
  __syncthreads();

  // Chunk c's boxes cycle through its own kRing stages, c * kRing on:
  // the k-th box of chunk c (k = the block's tile iteration * slabs + the
  // slab) sits in stage c * kRing + k % kRing, in that stage's phase
  // k / kRing. Only the warps of chunk c wait on those stages, and each of
  // them waits on every phase in turn, so a parity wait never passes on an
  // older phase. A chunk that starts past N (in the last tile only) is
  // neither loaded nor waited for.
  if (warp == kConsumers) {
    // The producer: a tile's boxes slab by slab, each slab's chunks in
    // turn, so every chunk's warps get work while another chunk's ring is
    // full.
    if (lane == 0) {
      long long i = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        for (int s = 0; s < slabs; ++s) {
          const long long k = i * slabs + s;
          for (int c = 0; c < kChunks; ++c) {
            const long long y = t * ROWS + static_cast<long long>(c) * kBox;
            if (y >= N) break;
            const int st = c * kRing + static_cast<int>(k % kRing);
            mbar_wait(&empty[st], static_cast<uint32_t>((k / kRing) & 1) ^ 1u);
            mbar_expect_tx(&full[st], kBox * kSlab);
            tma_load(ring + st * kBox * kSlab, &plane_map, &full[st],
                     s * kSlab, static_cast<int>(y));
          }
        }
      }
    }
    return;
  }

  const int chunk = warp / kBoxWarps;
  const int row0 = (warp % kBoxWarps) * kWarpRows;   // within the box
  int32_t* stage = epi + warp * 8 * kEpiPitch;
  const uint32_t ring_s = smem_u32(ring);
  const bool vec = N % 4 == 0;
  long long i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const long long base = t * ROWS + static_cast<long long>(chunk) * kBox
                           + row0;
    if (t * ROWS + static_cast<long long>(chunk) * kBox >= N) continue;
    int acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    for (int s = 0; s < slabs; ++s) {
      const long long k = i * slabs + s;
      const int st = chunk * kRing + static_cast<int>(k % kRing);
      mbar_wait(&full[st], static_cast<uint32_t>((k / kRing) & 1));
      mma_box<NT>(ring_s + st * kBox * kSlab, row0, panel, pitch, s,
                  min(kSlab, D2 - s * kSlab + 31) / 32, lane, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

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

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev];
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
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (a.N + ROWS - 1) / ROWS;
  const unsigned lane_tiles = static_cast<unsigned>((a.B + NT * 8 - 1)
                                                    / (NT * 8));
  long long blocks = static_cast<long long>(sm_count()) * per_sm / lane_tiles;
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  kernel<<<dim3(static_cast<unsigned>(blocks), lane_tiles), threads, smem,
           a.stream>>>(*a.map, a.q, a.out, a.B, a.N, a.D2);
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
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D2),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D2)};
  const cuuint32_t box[2] = {kSlab, static_cast<cuuint32_t>(
                                        rows < kBoxRows ? rows : kBoxRows)};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap map;
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(plane), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const MmaArgs a{&map, static_cast<const int8_t*>(q_panel),
                  static_cast<int32_t*>(out), B, N, D2,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (rows) {
    case 128: err = launch_mma_lanes<128>(lanes, a); break;
    case 256: err = launch_mma_lanes<256>(lanes, a); break;
    case 512: err = launch_mma_lanes<512>(lanes, a); break;
    case 1024: err = launch_mma_lanes<1024>(lanes, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
