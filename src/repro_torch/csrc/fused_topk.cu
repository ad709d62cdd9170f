// Stage-1 INT4 scoring fused with a per-block top-k on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fused_topk.py  fused_topk_batched_pallas
//   and, at B = 1, fused_topk_pallas (the single-query, unmasked form)
//
// For each block of block_n plane rows and each query lane the kernels
// score the rows exactly as the plane scan does, keep the block's (lanes x
// block_n) scores in shared memory, never in device memory, optionally
// mask them with the lane's tenant (owner[row] == tid && tid >= 0, else
// INT32_MIN), and emit the block's top-k (score, global row id) per lane.
//
// Selection reproduces the reference's iterative argmax bit for bit: each
// pick is the largest score, ties toward the lower row, and the picked
// entry becomes INT32_MIN. Once a block has no live (non-INT32_MIN) entry
// left, argmax over an all-INT32_MIN block returns index 0, so every
// further pick is (INT32_MIN, block base) and the same id repeats (a fully
// masked block, a padding lane with tid < 0, k above the live rows or
// above block_n). In closed form: the first L = min(k, live) picks are the
// live entries in descending (score, -row) order, the rest (INT32_MIN,
// base). Each pick is the warp maximum of keys that order rows by (score
// desc, row asc) and are unique per row, below the previous pick; once a
// lane's block has no live key left, its remaining picks are written
// without another round.
//
// Ragged N: the reference wrapper pads the plane with zero rows to a
// block multiple. Here a row at or past N is such a zero row without a
// read: it scores 0 (owner -1 when masked), carries its padded id >= N,
// and may take a slot from a real row with a negative score. The output
// (B, ceil(N / block_n), k) therefore equals the Pallas kernel's on the
// padded plane, and nothing is padded or copied.
//
// What bounds it on an H100 at N = 2^20, D = 512, B = 32, block_n = 512,
// k = 8: it reads the 256 MiB plane once and writes 2 x (32 x 2048 x 8)
// int32 (4 MiB), about 81 us at 3.35 TB/s; its 2*B*N*D = 34 G int8
// operations take 17 us on the int8 tensor cores. Two kernels, one
// contract (`fused_mma_lanes` picks, and the wrapper in
// `kernels/fused_topk.py` asks it):
//
// - `fused_mma_kernel`, for B >= 2, D/2 % 16 == 0 and block_n one of 128,
//   256, 512, 1024 (and a lane tile that fits in shared memory): the plane
//   scan's TMA ring and mma.sync product (mma_ring.cuh), with one tile of
//   ROWS = block_n rows per row block. Each consumer warp releases its
//   boxes right after its last MMA, so the producer loads the next tile
//   while the block selects; then it writes its 64 rows x lanes of
//   `acc >> 4`, masked (each thread reads owner for its 8 rows once per
//   tile, not once per lane), into a shared (lanes x block_n) tile as
//   32-bit keys score * block_n + (block_n - 1 - row): |score| <= 64 * D,
//   so the key fits in an int32 while 64 * D * block_n <= 2^30 (D = 512,
//   block_n = 512: 2^24), and a masked row's key is INT32_MIN, below
//   every live one. Selection spreads the tile's lanes over all consumer
//   warps, each taking up to four of its lanes round by round together so
//   that their reductions overlap: each thread holds block_n / 32 keys of
//   a lane in registers and its two largest below the last pick; a pick is
//   one __reduce_max_sync, after which the thread that held it moves its
//   second key up and rescans its keys only when it is picked again before
//   a rescan. Once no lane of the group has a live key, its remaining
//   picks are written without another round.
// - `fused_kernel` (dp4a) for every other shape: B = 1 (the single-query
//   form), odd widths (every even D: nibble.cuh's read modes, the lanes'
//   panels walked through shared memory kSpanWords words per half at a
//   time), and any block_n. A block of 256 threads owns one row block for
//   a tile of up to BT = 32 lanes (grid.x walks row blocks, grid.y lane
//   tiles); each thread scores block_n / 256 rows against every lane of
//   the tile on dp4a, reusing each 64-byte row chunk in registers, and one
//   warp selects for one lane at a time with 64-bit keys
//   (score << 32 | ~row).
#include "mma_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanWords = 128;  // panel words per lane half per pass
constexpr int kInt32Min = -2147483647 - 1;
constexpr int kInt32Max = 2147483647;
constexpr long long kNoKey = -9223372036854775807LL - 1;  // below every key

// q_eo (B, 2, D2) int8 lane panels; plane (N, D2) uint8; owner (N,) int32
// and tids (B,) int32, or owner null for no mask; out_s, out_i (B, nb, k)
// int32 with nb = gridDim.x. span: panel words per half held at a time (a
// multiple of 16). Shared memory: the panels [2][BT][span] words, then the
// scores [BT][block_n].
template <int BT, int MODE, bool TAIL>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const int8_t* __restrict__ q_eo,
             const uint8_t* __restrict__ plane,
             const int32_t* __restrict__ owner,
             const int32_t* __restrict__ tids,
             int32_t* __restrict__ out_s, int32_t* __restrict__ out_i, int B,
             long long N, int D2, int block_n, int k, int span) {
  extern __shared__ uint4 smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(smem);
  int32_t* s_s = reinterpret_cast<int32_t*>(q_s + 2 * BT * span);
  const int words = (D2 + 3) / 4;
  const int full = D2 / 4 / kChunkWords * kChunkWords;
  const int b0 = blockIdx.y * BT;
  const long long base = static_cast<long long>(blockIdx.x) * block_n;

  for (int i = threadIdx.x; i < BT * block_n; i += kThreads) s_s[i] = 0;
  for (int c0 = 0; c0 < words; c0 += span) {
    __syncthreads();  // scores zeroed, previous span consumed
    for (int i = threadIdx.x; i < 2 * BT * span; i += kThreads) {
      const int half = i / (BT * span);
      const int b = (i / span) % BT;
      const int w = c0 + i % span;
      q_s[i] = (b0 + b < B && w < words)
          ? operand_word<MODE>(q_eo, 2 * static_cast<size_t>(b0 + b) + half,
                               w, D2)
          : 0u;
    }
    __syncthreads();
    const int end = min(c0 + span, full);
    for (int r = threadIdx.x; r < block_n; r += kThreads) {
      const long long row = base + r;
      if (row >= N) continue;  // a padding row: zero bytes, score 0
      const uint8_t* rowp = plane + static_cast<size_t>(row) * D2;
      int acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0;
      for (int c = c0; c < end; c += kChunkWords) {
        int lo[kChunkWords], hi[kChunkWords];
        load_chunk<MODE, false>(rowp, c, D2, lo, hi);
        dot_chunk<BT>(q_s, span, c - c0, lo, hi, acc);
      }
      if constexpr (TAIL) {
        if (full >= c0 && full < c0 + span) {
          int lo[kChunkWords], hi[kChunkWords];
          load_chunk<MODE, true>(rowp, full, D2, lo, hi);
          dot_chunk<BT>(q_s, span, full - c0, lo, hi, acc);
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) s_s[b * block_n + r] += acc[b];
    }
  }
  __syncthreads();

  // Exact scores, with the lane's tenant mask applied in shared memory.
  for (int i = threadIdx.x; i < BT * block_n; i += kThreads) {
    const int b = i / block_n;
    const long long row = base + i % block_n;
    int v = s_s[i] >> 4;
    if (owner != nullptr) {
      const int t = b0 + b < B ? tids[b0 + b] : -1;
      const int own = row < N ? owner[row] : -1;
      if (own != t || t < 0) v = kInt32Min;
    }
    s_s[i] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int b = warp; b < BT && b0 + b < B; b += kWarps) {
    const int32_t* sc = s_s + b * block_n;
    const size_t o = (static_cast<size_t>(b0 + b) * gridDim.x + blockIdx.x)
                     * k;
    long long last = 9223372036854775807LL;
    for (int j = 0; j < k; ++j) {
      long long best = kNoKey;
      if (last != kNoKey) {
        for (int r = lane; r < block_n; r += 32) {
          const int v = sc[r];
          if (v == kInt32Min) continue;
          const long long key = static_cast<long long>(v) * 4294967296LL
                                + static_cast<unsigned int>(~r);
          if (key < last && key > best) best = key;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const long long other = __shfl_xor_sync(0xffffffffu, best, off);
          best = other > best ? other : best;
        }
      }
      if (lane == 0) {
        if (best == kNoKey) {
          out_s[o + j] = kInt32Min;
          out_i[o + j] = static_cast<int32_t>(base);
        } else {
          out_s[o + j] = static_cast<int32_t>(best >> 32);
          out_i[o + j] = static_cast<int32_t>(
              base + ~static_cast<unsigned int>(best));
        }
      }
      last = best;
    }
  }
}

struct FusedArgs {
  const int8_t* q;
  const uint8_t* plane;
  const int32_t* owner;
  const int32_t* tids;
  int32_t* out_s;
  int32_t* out_i;
  int B;
  long long N;
  int D2;
  int block_n;
  int k;
  int span;
  cudaStream_t stream;
};

size_t fused_smem(int bt, const FusedArgs& a) {
  return static_cast<size_t>(bt) * (2 * a.span + a.block_n) * 4;
}

template <int BT, int MODE, bool TAIL>
cudaError_t launch_fused(const FusedArgs& a) {
  const size_t smem = fused_smem(BT, a);
  const cudaError_t err = allow_smem(fused_kernel<BT, MODE, TAIL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.N + a.block_n - 1) / a.block_n),
                  static_cast<unsigned>((a.B + BT - 1) / BT));
  fused_kernel<BT, MODE, TAIL><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.plane, a.owner, a.tids, a.out_s, a.out_i, a.B, a.N, a.D2,
      a.block_n, a.k, a.span);
  return cudaGetLastError();
}

template <int MODE, bool TAIL>
cudaError_t launch_fused_tile(int bt, const FusedArgs& a) {
  switch (bt) {
    case 1: return launch_fused<1, MODE, TAIL>(a);
    case 2: return launch_fused<2, MODE, TAIL>(a);
    case 4: return launch_fused<4, MODE, TAIL>(a);
    case 8: return launch_fused<8, MODE, TAIL>(a);
    case 16: return launch_fused<16, MODE, TAIL>(a);
    default: return launch_fused<32, MODE, TAIL>(a);
  }
}

// --- the tensor-core form -------------------------------------------------

constexpr int kTilePad = 4;   // int32 past block_n per lane's key row

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// Bytes of dynamic shared memory one block of the (rows, lanes) instance
// of fused_mma_kernel takes at d2 bytes per row: the ring, panels and
// barriers, and the (lanes x rows) key tile.
inline long long fused_mma_smem(int rows, int lanes, long long d2) {
  return ring_smem(rows, lanes, d2) + 4LL * lanes * (rows + kTilePad);
}

// The lane tile of fused_mma_kernel for this shape (mma_lane_tile on its
// plan, block_n rows per tile); 0 when the dp4a kernel keeps the shape,
// which includes k < 1 and a width whose 32-bit keys could overflow
// (64 * D * block_n > 2^30; no shape whose panels fit comes near it).
int fused_lanes(int B, long long d2, int block_n, int k) {
  if (k < 1 || 128LL * d2 * block_n > (1LL << 30)) return 0;
  return mma_lane_tile(B, d2, block_n, [block_n, d2](int lanes) {
    return fused_mma_smem(block_n, lanes, d2);
  });
}

// t1, t2: the largest and second largest of kv[] below `bound`
// (INT32_MIN where there are none), from four independent partial top-2s.
template <int P>
__device__ __forceinline__ void top2_below(const int (&kv)[P], int bound,
                                           int& t1, int& t2) {
  int a1[4], a2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) a1[q] = a2[q] = kInt32Min;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int v = kv[j] < bound ? kv[j] : kInt32Min;
    a2[j % 4] = max(a2[j % 4], min(a1[j % 4], v));
    a1[j % 4] = max(a1[j % 4], v);
  }
#pragma unroll
  for (int w = 2; w > 0; w /= 2)
#pragma unroll
    for (int q = 0; q < w; ++q) {
      a2[q] = max(min(a1[q], a1[q + w]), max(a2[q], a2[q + w]));
      a1[q] = max(a1[q], a1[q + w]);
    }
  t1 = a1[0];
  t2 = a2[0];
}

// Syncs the consumer warps (named barrier 1; the producer warp has left).
template <int ROWS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "r"(ROWS / kWarpRows * 32) : "memory");
}

// q_eo (B, 2, D2) int8; the map covers the (N, D2) uint8 plane; owner (N,)
// and tids (B,) int32, or owner null (unmasked); out_s, out_i (B, tiles, k)
// int32 with tiles = ceil(N / ROWS). ROWS = block_n; blockIdx.y is the
// lane tile (NT * 8 lanes).
template <int ROWS, int NT>
__global__ void __launch_bounds__((ROWS / kWarpRows + 1) * 32, 1)
fused_mma_kernel(const __grid_constant__ CUtensorMap plane_map,
                 const int8_t* __restrict__ q_eo,
                 const int32_t* __restrict__ owner,
                 const int32_t* __restrict__ tids,
                 int32_t* __restrict__ out_s, int32_t* __restrict__ out_i,
                 int B, long long N, int D2, int k) {
  using R = Ring<ROWS>;
  constexpr int kLanes = NT * 8;
  constexpr int kPitch = ROWS + kTilePad;   // keeps key writes conflict-free
  constexpr int kPer = ROWS / 32;           // keys per thread in selection
  constexpr int kShift = ilog2(ROWS);
  // Lanes each consumer warp selects for, and how many at a time.
  constexpr int kLpw = kLanes > R::kConsumers ? kLanes / R::kConsumers : 1;
  constexpr int kGroup = kLpw < 4 ? kLpw : 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int slabs = (D2 + kSlab - 1) / kSlab;
  const int pitch = slabs * kSlab + kPanelPad;
  uint8_t* panel = ring + kStages * R::kBox * kSlab;
  int32_t* keys = reinterpret_cast<int32_t*>(panel + 2 * kLanes * pitch);
  uint64_t* full = reinterpret_cast<uint64_t*>(keys + kLanes * kPitch);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * kLanes;
  const long long tiles = (N + ROWS - 1) / ROWS;

  fill_panels<kLanes>(panel, pitch, full, empty, R::kBoxWarps, q_eo, 1, 2,
                      B, D2, b0);
  if (warp == R::kConsumers) {
    if (lane == 0) {
      produce_tiles<ROWS>(ring, full, empty, &plane_map, N, slabs);
    }
    return;
  }

  const int chunk = warp / R::kBoxWarps;
  const int row0 = (warp % R::kBoxWarps) * kWarpRows;   // within the box
  const int trow = chunk * R::kBox + row0;              // within the tile
  const int g = lane >> 2, q = lane & 3;
  const bool masked = owner != nullptr;
  // The tenants of this thread's accumulator lanes nt * 8 + 2q + e (-1
  // past B), and of its accumulator rows mt * 16 + g + 8h in each tile.
  int tid[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = b0 + nt * 8 + 2 * q + e;
      tid[nt][e] = masked && b < B ? tids[b] : -1;
    }
  const uint32_t ring_s = smem_u32(ring);
  long long i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const long long base = t * ROWS;
    int own[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = base + trow + mt * 16 + g + 8 * h;
        own[mt][h] = masked && row < N ? __ldg(owner + row) : -1;
      }
    int acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    // A chunk past N (last tile only) is not loaded: its rows score 0.
    if (base + static_cast<long long>(chunk) * R::kBox < N) {
      consume_tile<ROWS, NT>(ring_s, full, empty, panel, pitch, i, slabs, D2,
                             chunk, row0, lane, acc);
    }

    consumers_sync<ROWS>();   // the last tile's selection is done with keys
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = trow + mt * 16 + g + 8 * h;
            int key = (acc[mt][nt][2 * h + e] >> 4) * ROWS + (ROWS - 1 - r);
            if (masked && (own[mt][h] != tid[nt][e] || tid[nt][e] < 0)) {
              key = kInt32Min;
            }
            keys[(nt * 8 + 2 * q + e) * kPitch + r] = key;
          }
    consumers_sync<ROWS>();   // the tile's keys are complete

    // Warp w selects for lanes w, w + kConsumers, ..., kGroup of them at a
    // time, round by round, so their reductions overlap.
    for (int g0 = 0; g0 < kLpw; g0 += kGroup) {
      int kv[kGroup][kPer];
      // Per lane: this thread's largest key below the last pick (t1) and,
      // while `second` holds, its next largest (t2).
      int t1[kGroup], t2[kGroup];
      bool second[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int l = warp + (g0 + g) * R::kConsumers;
        const bool valid = l < kLanes && b0 + l < B;
        const int32_t* kl = keys + (valid ? l : 0) * kPitch;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          kv[g][j] = valid ? kl[j * 32 + lane] : kInt32Min;
        }
        top2_below(kv[g], kInt32Max, t1[g], t2[g]);
        second[g] = true;
      }
      bool any = true;   // some lane of the group has a live key left
      // Picks j0 .. j0 + 31 are kept by threads 0 .. 31 and stored at once.
      for (int j0 = 0; j0 < k; j0 += 32) {
        int ps[kGroup], pi[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          ps[g] = kInt32Min;
          pi[g] = static_cast<int>(base);
        }
        const int n = min(32, k - j0);
        for (int jj = 0; jj < n && any; ++jj) {
          int best[kGroup];
          bool need[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            best[g] = __reduce_max_sync(0xffffffffu, t1[g]);
          }
          any = false;
          bool rescan = false;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const bool hit = best[g] != kInt32Min;
            any |= hit;
            if (hit && lane == jj) {
              ps[g] = best[g] >> kShift;
              pi[g] = static_cast<int>(base) + ROWS - 1
                      - (best[g] & (ROWS - 1));
            }
            // Keys are unique: one thread held the pick.
            const bool mine = hit && t1[g] == best[g];
            need[g] = mine && !second[g];
            rescan |= need[g];
            if (mine && second[g]) {
              t1[g] = t2[g];
              second[g] = false;
            }
          }
          if (__any_sync(0xffffffffu, rescan)) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              if (need[g]) {
                top2_below(kv[g], best[g], t1[g], t2[g]);
                second[g] = true;
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int l = warp + (g0 + g) * R::kConsumers;
          if (l < kLanes && b0 + l < B && lane < n) {
            const size_t o = (static_cast<size_t>(b0 + l) * tiles + t) * k;
            out_s[o + j0 + lane] = ps[g];
            out_i[o + j0 + lane] = pi[g];
          }
        }
      }
    }
  }
}

struct FusedMmaArgs {
  const CUtensorMap* map;
  const int8_t* q;
  const int32_t* owner;
  const int32_t* tids;
  int32_t* out_s;
  int32_t* out_i;
  int B;
  long long N;
  int D2;
  int k;
  cudaStream_t stream;
};

template <int ROWS, int NT>
cudaError_t launch_fused_mma(const FusedMmaArgs& a) {
  auto kernel = fused_mma_kernel<ROWS, NT>;
  const int threads = (ROWS / kWarpRows + 1) * 32;
  const size_t smem = static_cast<size_t>(fused_mma_smem(ROWS, NT * 8, a.D2));
  const unsigned lane_tiles = static_cast<unsigned>((a.B + NT * 8 - 1)
                                                    / (NT * 8));
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(kernel, threads, smem,
                                      (a.N + ROWS - 1) / ROWS, lane_tiles,
                                      &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, lane_tiles), threads, smem, a.stream>>>(
      *a.map, a.q, a.owner, a.tids, a.out_s, a.out_i, a.B, a.N, a.D2, a.k);
  return cudaGetLastError();
}

// fused_lanes gives the 1024-row tile at most 16 lanes.
template <int ROWS>
cudaError_t launch_fused_mma_lanes(int lanes, const FusedMmaArgs& a) {
  switch (lanes) {
    case 8: return launch_fused_mma<ROWS, 1>(a);
    case 16: return launch_fused_mma<ROWS, 2>(a);
    case 32:
      if constexpr (ROWS < 1024) return launch_fused_mma<ROWS, 4>(a);
      [[fallthrough]];
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core form; refuses (cudaErrorInvalidValue) a shape
// fused_lanes gives 0 and N >= 2^31 (the tensor map's int32 row
// coordinate).
cudaError_t launch_fused_mma_shape(const void* plane, FusedMmaArgs a,
                                   int block_n) {
  const int lanes = fused_lanes(a.B, a.D2, block_n, a.k);
  if (lanes == 0 || a.N <= 0 || a.N >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const cudaError_t err = encode_plane_map(&map, plane, a.N, a.D2, block_n);
  if (err != cudaSuccess) return err;
  a.map = &map;
  switch (block_n) {
    case 128: return launch_fused_mma_lanes<128>(lanes, a);
    case 256: return launch_fused_mma_lanes<256>(lanes, a);
    case 512: return launch_fused_mma_lanes<512>(lanes, a);
    case 1024: return launch_fused_mma_lanes<1024>(lanes, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The lane tile fused_topk_launch's tensor-core kernel takes for this
// shape (fused_lanes); 0 when the shape goes to the dp4a kernel instead.
extern "C" int fused_mma_lanes(int B, long long D2, int block_n, int k) {
  return fused_lanes(B, D2, block_n, k);
}

// q_eo (B, 2, D2) int8; plane (N, D2) uint8 (16-byte aligned); owner (N,)
// / tids (B,) int32 or owner null (unmasked); out_s, out_i (B, ceil(N /
// block_n), k) int32. mma != 0 launches fused_mma_kernel, which refuses a
// shape fused_mma_lanes gives 0; mma == 0 the dp4a fused_kernel.
extern "C" int fused_topk_launch(const void* q_eo, const void* plane,
                                 const void* owner, const void* tids,
                                 void* out_s, void* out_i, int B, long long N,
                                 int D2, int block_n, int k, int mma,
                                 void* stream) {
  if (block_n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mma) {
    const FusedMmaArgs m{nullptr, static_cast<const int8_t*>(q_eo),
                         static_cast<const int32_t*>(owner),
                         static_cast<const int32_t*>(tids),
                         static_cast<int32_t*>(out_s),
                         static_cast<int32_t*>(out_i), B, N, D2, k,
                         static_cast<cudaStream_t>(stream)};
    return static_cast<int>(launch_fused_mma_shape(plane, m, block_n));
  }
  FusedArgs a{static_cast<const int8_t*>(q_eo),
              static_cast<const uint8_t*>(plane),
              static_cast<const int32_t*>(owner),
              static_cast<const int32_t*>(tids),
              static_cast<int32_t*>(out_s), static_cast<int32_t*>(out_i),
              B, N, D2, block_n, k, 0, static_cast<cudaStream_t>(stream)};
  const long long words_pad = round_up((D2 + 3) / 4, kChunkWords);
  a.span = static_cast<int>(words_pad < kSpanWords ? words_pad : kSpanWords);
  // The smallest power-of-two lane tile that covers B (at most 32), halved
  // while its panels and scores exceed the shared memory of one block.
  int bt = 1;
  while (bt < B && bt < 32) bt *= 2;
  while (bt > 1 && fused_smem(bt, a) > static_cast<size_t>(kMaxSmem)) bt /= 2;
  if (fused_smem(bt, a) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mode = mode_for(D2);
  cudaError_t err;
  if (D2 % 64 == 0) err = launch_fused_tile<kVec, false>(bt, a);
  else if (mode == kVec) err = launch_fused_tile<kVec, true>(bt, a);
  else if (mode == kWord) err = launch_fused_tile<kWord, true>(bt, a);
  else err = launch_fused_tile<kByte, true>(bt, a);
  return static_cast<int>(err);
}
