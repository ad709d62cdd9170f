// Stage-0 dense sign scan on Hopper's int8 tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stage0_sign.py  stage0_sign_batched_pallas
// for the shapes it takes (`stage0_sign_mma_lanes` decides, and the wrapper
// in `kernels/stage0_sign.py` asks it): B >= 2 query lanes, D/8 % 16 == 0
// (D % 128 == 0: the 16-byte row stride TMA needs), 0 < N < 2^31 (the
// tensor map's int32 row coordinate) and a lane tile whose query panels
// fit in shared memory beside the ring. Every other shape stays on the
// popcount `sign_plane_kernel` of stage0_sign.cu. Both return the same
// bits:
//
//   out[b, n] = sum_k q_sign[b, k] * (1 - 2 * bit_k(plane[n]))
//
// (bit k % 8 of byte k / 8 of the row, set when dim k is negative).
//
// What bounds it on an H100 at N = 2^20, D = 512, B = 32: it reads the
// 64 MiB sign plane once and writes the (B, N) int32 scores (128 MiB),
// 60 us at 3.35 TB/s; its 2 * B * N * D = 34 G int8 operations take 17 us
// on the int8 tensor cores. The popcount kernel spends 537 M XOR + popc
// pairs on the integer pipe (0.175 ms); here the product goes to mma.sync,
// so bytes bound it, and the score write is two thirds of them.
//
// The product: the sign bits as mma.sync masks. For a fragment register w
// of plane bytes (bit j of byte c is dim 8c + j), (w << (7 - j)) &
// 0x80808080 moves bit j of each byte to that byte's top bit, so read as
// s8 each byte is -128 * bit_{8c+j}: two ALU operations per register and
// mask, and nothing is unpacked to memory. The eight masks j = 0..7 of
// one 32-byte chunk feed eight m16n8k32 s8 k-steps, k-step j against the
// query's sub-panel j (byte c of lane b's sub-panel j is q_sign[b, 8c +
// j]). The sums are acc = -128 * sum_k q_k * bit_k, so
//   out = qsum + (acc >> 6),   qsum[b] = sum_k q_sign[b, k],
// exact: acc is a multiple of 128 and |acc| <= 2^14 * D fits an int32 for
// every D whose panels fit. Any int8 query gives its dot with the +-1
// row; the wrapper's +-1 contract is the popcount kernel's.
//
// Design: the TMA ring of mma_ring.cuh over the (N, D/8) plane (boxes of
// up to 256 rows x 128 bytes, 128-byte swizzled; at D = 512 a row is 64
// bytes and TMA fills the rest of each box with zeros, which costs shared
// memory but no device-memory bytes; the consumers run only the live
// 32-byte chunks), its producer warp and persistent grid, and:
// - The sub-panels: [j][lane][pitch] bytes in shared memory, ordered as
//   mma_ring.cuh's `fill_panels` orders its panels, so one 8-byte load
//   gives a thread both B-fragment registers of a k-step without bank
//   conflicts. The consumer warps fill them from q_sign (each thread reads
//   32 query bytes with two 16-byte loads and writes one word of each of
//   the eight sub-panels) and sum qsum, while the producer warp already
//   loads the first tile's boxes.
// - Consumer warps of 32 plane rows (2 m-tiles; 64 rows at ROWS = 1024,
//   where 32 warps and the producer would exceed 1024 threads), so the
//   default 256-row tile has two consumer warps per scheduler: with one
//   (64-row warps), each warp's own latencies (its masks, loads and
//   dependent MMAs) bounded the 256-row tile well above the 512-row one.
// - A k-step: a warp's rows of a 32-byte chunk come out of the swizzled
//   box once by ldmatrix.x4 and stay in registers for the chunk's eight
//   masks, each mask against every n-tile of the lane tile.
// - Epilogue: as `plane_mma_kernel` (stage1_mma.cu): each warp stages an
//   (8 lanes x its rows) int32 tile of qsum + (acc >> 6) in shared memory
//   and writes each lane's run of rows with 16-byte stores, while the
//   producer loads the next tile's boxes.
//
// `ROWS` (128, 256, 512, 1024) is the autotuner's "stage0_sign" knob, as
// for the popcount kernel: plane rows per tile. It never changes a
// result. The 512-row tile takes at most 16 lanes a block and the
// 1024-row tile 8 (sign_widest), so that no instance spills.

#include "mma_ring.cuh"

namespace {

constexpr int kMasks = 8;       // bits per sign byte: one sub-panel each

// m-tiles (16 plane rows each) per consumer warp at `rows` rows per tile:
// 2, so the 256-row tile has 8 consumer warps (two per scheduler); 4 at
// 1024 rows, where 32 warps of 32 rows and the producer would exceed a
// block's 1024 threads.
constexpr int sign_mt(int rows) { return rows == 1024 ? 4 : 2; }

// A block's warps for tiles of ROWS plane rows.
template <int ROWS>
struct SignPlan {
  static constexpr int kMt = sign_mt(ROWS);
  static constexpr int kRows = 16 * kMt;                    // per warp
  static constexpr int kConsumers = ROWS / kRows;
  static constexpr int kBoxWarps = Ring<ROWS>::kBox / kRows;
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kEpiPitch = kRows + 4;   // int32 per staged lane row
};

// Bytes of dynamic shared memory one block of the (rows, lanes) instance
// takes at d8 bytes per sign row: the ring (with room to align it to
// 1 KiB), the eight sub-panels, the epilogue's staging (8 lanes x a
// warp's rows per consumer warp), the lanes' qsum and the full and empty
// barriers.
inline long long sign_smem(int rows, int lanes, long long d8) {
  const long long box_rows = rows < kBoxRows ? rows : kBoxRows;
  const int warp_rows = 16 * sign_mt(rows);
  return 1024 + kStages * box_rows * kSlab
         + static_cast<long long>(kMasks) * lanes * panel_pitch(d8)
         + (rows / warp_rows) * 8LL * (warp_rows + 4) * 4 + 4LL * lanes
         + 2LL * kStages * 8;
}

// The widest lane tile at `rows` rows per tile: the 17 warps of the 512-
// and 1024-row tiles leave a thread 96 registers, fewer than 32 lanes'
// accumulators need at 2 m-tiles a warp or 16 lanes' at 4, so those
// instances would spill.
constexpr int sign_widest(int rows) {
  return rows == 1024 ? 8 : (rows == 512 ? 16 : 32);
}

// The lane tile for this shape (mma_lane_tile on this kernel's plan, at
// most sign_widest); 0 when the popcount kernel keeps it.
int sign_lanes(int B, long long N, long long d8, int rows) {
  if (N <= 0 || N >= (1LL << 31)) return 0;
  const int lanes = mma_lane_tile(B, d8, rows, [rows, d8](int lanes) {
    return sign_smem(rows, lanes, d8);
  });
  return lanes < sign_widest(rows) ? lanes : sign_widest(rows);
}

// Byte s of x and of y, as the low two bytes.
__device__ __forceinline__ uint32_t pair_bytes(uint32_t x, uint32_t y,
                                               int s) {
  return __byte_perm(x, y, s | ((s + 4) << 4));
}

// The consumer warps (`threads` threads) fill the lane tile's sub-panels,
// [j][lane][pitch] bytes: byte c of lane l's sub-panel j is q_sign[b0 + l,
// 8c + j], and within each 32-byte chunk physical word 2i holds word i and
// 2i + 1 word i + 4 (fill_panels' order). Words past D8 / 4, to the end of
// the last 32-byte chunk, and lanes past B are zero. qsum[l] += sum_k
// q_sign[b0 + l, k] (zeroed by the caller). Item (l, w): the 32 query
// bytes 32w .. 32w + 31 give word w of every sub-panel.
template <int LANES>
__device__ __forceinline__ void fill_sign_panels(uint8_t* panel, int pitch,
                                                 int32_t* qsum,
                                                 const int8_t* q, int B,
                                                 int D8, int b0,
                                                 int threads) {
  const int words = (D8 + 31) / 32 * 8;
  const int live = D8 / 4;
  const int lane_words = pitch / 4;
  uint32_t* panel_w = reinterpret_cast<uint32_t*>(panel);
  for (int i = threadIdx.x; i < LANES * words; i += threads) {
    const int l = i / words, w = i % words;
    uint32_t x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (b0 + l < B && w < live) {
      const uint4* src = reinterpret_cast<const uint4*>(
          q + static_cast<size_t>(b0 + l) * 8 * D8 + 32 * w);
      const uint4 lo = __ldg(src), hi = __ldg(src + 1);
      x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
      x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
      int s = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        s = __dp4a(static_cast<int>(x[m]), 0x01010101, s);
      }
      atomicAdd(&qsum[l], s);
    }
    const int c = w & 7;
    const int p = (w & ~7) + (c < 4 ? 2 * c : 2 * (c - 4) + 1);
#pragma unroll
    for (int j = 0; j < kMasks; ++j) {
      // Byte i of the word is q[32w + 8i + j]: byte j % 4 of x[2i + j / 4].
      const int a = j >> 2, s = j & 3;
      const uint32_t v = __byte_perm(pair_bytes(x[a], x[a + 2], s),
                                     pair_bytes(x[a + 4], x[a + 6], s),
                                     0x5410);
      panel_w[(j * LANES + l) * lane_words + p] = v;
    }
  }
}

// acc[mt][nt] += the warp's MT m-tiles (from row0 of a swizzled box) .
// lane n-tile nt, over the chunks [0, ksteps) of slab s: per chunk, the
// rows' fragments once by ldmatrix.x4, then for each mask j one k-step
// against sub-panel j (thread t's B fragment: words 8 kk + t and 8 kk +
// t + 4).
template <int MT, int NT>
__device__ __forceinline__ void sign_box(uint32_t box, int row0,
                                         const uint8_t* panel, int pitch,
                                         int s, int ksteps, int lane,
                                         int (&acc)[MT][NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, r = lane & 7;   // ldmatrix: matrix, its row
  const uint8_t* pb = panel + g * pitch + s * kSlab + 8 * t;
  const int sub = NT * 8 * pitch;            // bytes of one sub-panel
#pragma unroll
  for (int kk = 0; kk < kSlab / 32; ++kk) {
    if (kk >= ksteps) break;
    const int chunk = 2 * kk + (mat >> 1);   // 16-byte chunk in the row
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = row0 + mt * 16 + r + 8 * (mat & 1);
      ldmatrix_x4(a[mt], box + row * kSlab + ((chunk ^ (row & 7)) << 4));
    }
#pragma unroll
    for (int j = 0; j < kMasks; ++j) {
      uint2 bq[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bq[nt] = *reinterpret_cast<const uint2*>(pb + j * sub
                                                 + nt * 8 * pitch + kk * 32);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = (a[mt][i] << (7 - j)) & 0x80808080u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_s8(acc[mt][nt], v, bq[nt].x, bq[nt].y);
        }
      }
    }
  }
}

// q_sign (B, D8 * 8) int8; the map covers the (N, D8) uint8 sign plane;
// out (B, N) int32. blockIdx.y is the lane tile (NT * 8 lanes).
template <int ROWS, int NT>
__global__ void __launch_bounds__(SignPlan<ROWS>::kThreads, 1)
sign_mma_kernel(const __grid_constant__ CUtensorMap plane_map,
                const int8_t* __restrict__ q_sign,
                int32_t* __restrict__ out, int B, long long N, int D8) {
  using R = Ring<ROWS>;
  using P = SignPlan<ROWS>;
  constexpr int MT = P::kMt;
  constexpr int kLanes = NT * 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int slabs = (D8 + kSlab - 1) / kSlab;
  const int pitch = slabs * kSlab + kPanelPad;
  uint8_t* panel = ring + kStages * R::kBox * kSlab;
  int32_t* epi = reinterpret_cast<int32_t*>(panel + kMasks * kLanes * pitch);
  int32_t* qsum = epi + P::kConsumers * 8 * P::kEpiPitch;
  uint64_t* full = reinterpret_cast<uint64_t*>(qsum + kLanes);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * kLanes;
  const long long tiles = (N + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kBoxWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < kLanes) qsum[threadIdx.x] = 0;
  __syncthreads();
  if (warp == P::kConsumers) {
    if (lane == 0) {
      produce_tiles<ROWS>(ring, full, empty, &plane_map, N, slabs);
    }
    return;
  }
  fill_sign_panels<kLanes>(panel, pitch, qsum, q_sign, B, D8, b0,
                           P::kConsumers * 32);
  // The consumer warps only: the producer warp has left.
  asm volatile("bar.sync 1, %0;\n" :: "r"(P::kConsumers * 32) : "memory");

  const int chunk = warp / P::kBoxWarps;
  const int row0 = (warp % P::kBoxWarps) * P::kRows;    // within the box
  int32_t* stage = epi + warp * 8 * P::kEpiPitch;
  const uint32_t ring_s = smem_u32(ring);
  const bool vec = N % 4 == 0;
  long long i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const long long base = t * ROWS + static_cast<long long>(chunk) * R::kBox
                           + row0;
    if (t * ROWS + static_cast<long long>(chunk) * R::kBox >= N) continue;
    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    // consume_tile of mma_ring.cuh, with the sign product.
    for (int s = 0; s < slabs; ++s) {
      const long long k = i * slabs + s;
      const int st = chunk * R::kRing + static_cast<int>(k % R::kRing);
      mbar_wait(&full[st], static_cast<uint32_t>((k / R::kRing) & 1));
      sign_box<MT, NT>(ring_s + st * R::kBox * kSlab, row0, panel, pitch, s,
                   min(kSlab, D8 - s * kSlab + 31) / 32, lane, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    if (base >= N) continue;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (b0 + nt * 8 >= B) break;
      const int s0 = qsum[nt * 8 + 2 * q], s1 = qsum[nt * 8 + 2 * q + 1];
      __syncwarp();
      constexpr int kPitch = P::kEpiPitch;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + g;
        stage[(2 * q) * kPitch + r] = s0 + (acc[mt][nt][0] >> 6);
        stage[(2 * q + 1) * kPitch + r] = s1 + (acc[mt][nt][1] >> 6);
        stage[(2 * q) * kPitch + r + 8] = s0 + (acc[mt][nt][2] >> 6);
        stage[(2 * q + 1) * kPitch + r + 8] = s1 + (acc[mt][nt][3] >> 6);
      }
      __syncwarp();
      // 8 lanes x kRows rows: kRows / 4 16-byte pieces per lane.
#pragma unroll
      for (int it = 0; it < MT; ++it) {
        const int idx = it * 32 + lane;
        const int l = idx / (P::kRows / 4);          // lane of the n-tile
        const int r = (idx % (P::kRows / 4)) * 4;    // first of 4 rows
        const int b = b0 + nt * 8 + l;
        const long long row = base + r;
        if (b >= B || row >= N) continue;
        const int4 v =
            *reinterpret_cast<const int4*>(stage + l * kPitch + r);
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

struct SignArgs {
  const CUtensorMap* map;
  const int8_t* q;
  int32_t* out;
  int B;
  long long N;
  int D8;
  cudaStream_t stream;
};

template <int ROWS, int NT>
cudaError_t launch_sign(const SignArgs& a) {
  auto kernel = sign_mma_kernel<ROWS, NT>;
  const int threads = SignPlan<ROWS>::kThreads;
  const size_t smem = static_cast<size_t>(sign_smem(ROWS, NT * 8, a.D8));
  const unsigned lane_tiles = static_cast<unsigned>((a.B + NT * 8 - 1)
                                                    / (NT * 8));
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(kernel, threads, smem,
                                      (a.N + ROWS - 1) / ROWS, lane_tiles,
                                      &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, lane_tiles), threads, smem, a.stream>>>(
      *a.map, a.q, a.out, a.B, a.N, a.D8);
  return cudaGetLastError();
}

// sign_lanes gives at most sign_widest(ROWS) lanes: no other instance is
// built.
template <int ROWS>
cudaError_t launch_sign_lanes(int lanes, const SignArgs& a) {
  switch (lanes) {
    case 8: return launch_sign<ROWS, 1>(a);
    case 16:
      if constexpr (sign_widest(ROWS) >= 16) return launch_sign<ROWS, 2>(a);
      break;
    case 32:
      if constexpr (sign_widest(ROWS) >= 32) return launch_sign<ROWS, 4>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The lane tile stage0_sign_mma_launch takes for B lanes over an N-row
// plane of D8 bytes per row at `rows` rows per tile (sign_lanes); 0 when
// the shape goes to the popcount sign_plane_kernel instead.
extern "C" int stage0_sign_mma_lanes(int B, long long N, long long D8,
                                     int rows) {
  return sign_lanes(B, N, D8, rows);
}

// q_sign (B, D) int8, sign_plane (N, D/8) uint8 (16-byte aligned), out
// (B, N) int32. rows: plane rows per tile, one of 128, 256, 512, 1024.
// Refuses (cudaErrorInvalidValue) D % 8 != 0 and a shape
// stage0_sign_mma_lanes gives 0.
extern "C" int stage0_sign_mma_launch(const void* q_sign,
                                      const void* sign_plane, void* out,
                                      int B, long long N, int D, int rows,
                                      void* stream) {
  const int lanes = D % 8 ? 0 : sign_lanes(B, N, D / 8, rows);
  if (lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  cudaError_t err = encode_plane_map(&map, sign_plane, N, D / 8, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SignArgs a{&map, static_cast<const int8_t*>(q_sign),
                   static_cast<int32_t*>(out), B, N, D / 8,
                   static_cast<cudaStream_t>(stream)};
  switch (rows) {
    case 128: err = launch_sign_lanes<128>(lanes, a); break;
    case 256: err = launch_sign_lanes<256>(lanes, a); break;
    case 512: err = launch_sign_lanes<512>(lanes, a); break;
    case 1024: err = launch_sign_lanes<1024>(lanes, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
