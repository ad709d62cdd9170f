// Stage-0 sign-agreement block gather on Hopper: whole plane blocks by 1D
// bulk async copy into a shared-memory ring, each block read once for all
// the query lanes that share its block table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stage0_sign.py  stage0_sign_gather_pallas
// for the shapes it takes and the route chooses it for
// (`stage0_sign_bulk_takes` decides, and the wrapper in
// `kernels/stage0_sign.py` asks it: the decode widths); every other shape
// stays on the popcount `sign_gather_kernel` of stage0_sign.cu. Both give
// the same bits:
//
//   out[b, r] = sum_k q_sign[b, k] * (1 - 2 * bit_k(plane[row])),
//   row = ids[b / G, r / BR] * BR + r % BR;  sum_k q_sign[b, k] where row
//   is at or past N or negative (never read),
//
// with G the group: G consecutive lanes share one block table (the G query
// heads of a KV head in the decode prescreen), so ids is (B / G, J). As in
// stage0_sign.cu each lane's signs are packed into bits (set where
// q_sign < 0) and a row scores D - 2 * popc(qbits ^ dbits).
//
// What bounds it on an H100: bytes, and below a few MiB the latency of a
// launch. The work is at most a few million XOR + popcount word pairs
// (4.2 M at the cluster path's 32 lanes x 8192 rows x 16 words), about
// 1 us on the integer pipe; the rows read and the int32 scores written
// take 0.7-4.7 us at 3.35 TB/s at the three shapes the port gives it (the
// decode prescreen's 112 lanes x 256 pages of 16 rows x 8 bytes in groups
// of 7, the serving path's resident 32 x 32 blocks of 64 rows x 64 bytes,
// the cluster prescreen's 32 x 128 such blocks). A launch of one CTA that
// copies one block and scores it takes about 2.5 us on an H100 (PERF.md):
// every row sits behind its block id, one dependent read, then the copy,
// so the decode and resident shapes are bound by that floor, not bytes.
//
// Design:
// - A CTA owns one block table and a chunk of its blocks. The grid fills
//   the card's resident slots once, at most kMaxPerSm CTAs per SM
//   (`launch_bulk`): all CTAs start together, and with fewer, longer CTAs
//   the ring overlaps one stage's scoring with the next stages' copies
//   (more CTAs per SM were slower in exploratory builds).
// - The last warp is the producer. It reads the chunk's block ids in one
//   coalesced read (kIdsWindow at a time, eight loads in flight per lane)
//   into shared memory. Per ring stage (kStageTarget bytes, at least one
//   block) lane 0 posts the stage's bytes on the stage's full mbarrier and
//   each lane issues one
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes per
//   block, beside each block's count of valid rows for the consumers. No
//   tensor map is encoded: the copy is a plain address and size. A block
//   wholly past N is not copied; a block that straddles N copies its
//   (N % BR) * D/8 valid bytes, which the route's shape rule keeps a
//   multiple of 16.
// - The other warps are the consumers. While the first copies fly they
//   pack the group's query signs into shared memory, a thread per 32-dim
//   word from two 16-byte loads (the sign bits gathered by a multiply, in
//   `sign_bits`; one __ballot_sync per word over byte loads was slower at
//   the decode shape in an exploratory build), and each lane's
//   sum(q_sign) = D - 2 * popc(qbits). Then per stage each warp scores
//   its rows against every lane of the group (`score_stage`):
//   - rows of 4, 8 or 16 bytes (the decode widths hd 32, 64, 128; BR % 4
//     == 0): four rows per thread, read as 16-byte loads, each lane's four
//     scores stored as one 16-byte store;
//   - rows of 32, 64 or 128 bytes (D = 256, 512, 1024): one row per
//     thread, a warp's 32 rows at a time, one int32 store per row (128
//     contiguous bytes per warp), read 16 bytes at a time from segment
//     `row_rot` on so the 8 threads of a quarter warp hit 8 distinct bank
//     groups, against the group lane's query segments held in registers
//     for the stage, which halves the shared-memory reads (PERF.md: 7.03
//     against 5.48 us at the cluster shape). A row split over lanes and
//     reduced by shuffles was slower in an exploratory build.
//
// Limits (`bulk_takes`): rows of 4, 8, 16 bytes with BR % 4 == 0, or of
// 32, 64, 128 bytes; BR * D/8 % 16 == 0 and (N % BR) * D/8 % 16 == 0 (the
// bulk copy's size unit); a 16-byte aligned plane; 0 < N < 2^31; the ring
// and the group's packed signs within one block's shared memory.

#include "mma_ring.cuh"   // mbarriers, smem_u32, sm_count, allow_smem

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kBulkThreads = (kConsumerWarps + 1) * 32;
constexpr int kRingStages = 4;
constexpr long long kStageTarget = 8192;   // bytes per ring stage
constexpr int kIdsWindow = 256;            // block ids read at once
constexpr int kMaxPerSm = 4;               // CTAs per SM in the grid

// Block ids the producer holds in shared memory: a whole number of stages,
// kIdsWindow or one stage when a stage holds more blocks.
__host__ __device__ inline int ids_window(int stage_blocks) {
  return stage_blocks >= kIdsWindow
      ? stage_blocks : kIdsWindow / stage_blocks * stage_blocks;
}

struct BulkShape {
  long long block_bytes;   // BR * D/8
  int stage_blocks;        // blocks per ring stage
  long long stage_bytes;
  int nwp;                 // packed query words per lane, a multiple of 4
  long long smem;          // bytes of shared memory per CTA
};

inline BulkShape bulk_shape(long long d8, int br, long long group) {
  BulkShape s;
  s.block_bytes = br * d8;
  const long long fit = kStageTarget / s.block_bytes;
  s.stage_blocks = static_cast<int>(fit > 1 ? fit : 1);
  s.stage_bytes = s.stage_blocks * s.block_bytes;
  s.nwp = static_cast<int>(round_up((d8 + 3) / 4, 4));
  // 128 bytes to align the ring, the ring, its full and empty barriers,
  // the packed signs, one sum per lane, the valid rows of each ring
  // block and the ids window.
  s.smem = 128 + kRingStages * s.stage_bytes + 2LL * kRingStages * 8
           + group * s.nwp * 4 + group * 4
           + 4LL * (kRingStages * s.stage_blocks
                    + ids_window(s.stage_blocks));
  return s;
}

// Rows of 4, 8, 16 bytes need BR % 4 == 0 (four rows per thread), rows of
// 32, 64, 128 bytes any BR; every other width stays on the popcount
// kernel.
bool row_width_takes(long long d8, int br) {
  if (d8 == 4 || d8 == 8 || d8 == 16) return br % 4 == 0;
  return d8 == 32 || d8 == 64 || d8 == 128;
}

bool bulk_takes(const void* plane, long long N, long long d8, int br,
                long long group) {
  if (br <= 0 || group <= 0 || N <= 0 || N >= (1LL << 31)
      || !row_width_takes(d8, br)) {
    return false;
  }
  if (reinterpret_cast<uintptr_t>(plane) % 16) return false;
  if ((br * d8) % 16 || ((N % br) * d8) % 16) return false;
  return bulk_shape(d8, br, group).smem <= kMaxSmem;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bit i set where byte i of the 16 int8 values is negative: each word's
// four sign bits moved to bit 0 of its bytes, then gathered into the top
// byte by one multiply (no carries).
__device__ __forceinline__ uint32_t sign_bits(uint4 v) {
  auto four = [](uint32_t x) {
    return (((x >> 7) & 0x01010101u) * 0x01020408u) >> 24;
  };
  return four(v.x) | four(v.y) << 4 | four(v.z) << 8 | four(v.w) << 12;
}

// The bytes of block `id` that lie in the plane: none past N or below 0.
__device__ __forceinline__ uint32_t valid_bytes(long long id, long long N,
                                                int BR, int D8) {
  if (id < 0) return 0u;
  const long long rows = N - id * BR;
  return static_cast<uint32_t>((rows <= 0 ? 0 : (rows < BR ? rows : BR))
                               * D8);
}

// The first 16-byte segment thread `lane` reads of a row of c = 2, 4, 8
// segments: rows of 2 or 4 segments sit 8 / c to a 128-byte bank line, so
// threads that share a line start at distinct segments; rows of 8 each
// fill a line, and thread l starts at segment l. The 8 threads of a
// quarter warp so hit 8 distinct bank groups.
__device__ __forceinline__ int row_rot(int c, int lane) {
  return c >= 8 ? lane : lane / (8 / c);
}

// The rows of one landed stage: `rows` rows of SW bytes at `buf`, their
// blocks' valid row counts at `vr`, scores to ob[g * R + row] for lane g
// of the group.
// - SW = 4, 8, 16 (BR % 4 == 0): thread l of a warp takes rows rb + 4 l
//   ... rb + 4 l + 3 of each 128-row batch (of one block, as BR % 4 ==
//   0) as SW / 4 16-byte loads, and stores each group lane's four scores
//   as one 16-byte store.
// - SW = 32, 64, 128: thread l takes row rb + l of each 32-row batch,
//   its segments from `row_rot` on, against the group lane's query
//   segments held in registers for the stage; one int32 store per row,
//   128 contiguous bytes per warp.
template <int SW>
__device__ __forceinline__ void score_stage(
    const uint8_t* buf, const int* vr, int32_t* ob, long long R, int rows,
    int BR, int D, int G, const uint32_t* qbits, int nwp, const int* qsum,
    int warp, int lane) {
  const int br_shift = BR & (BR - 1) ? -1 : __ffs(BR) - 1;
  auto block_of = [&](int r) { return br_shift >= 0 ? r >> br_shift
                                                    : r / BR; };
  if constexpr (SW <= 16) {
    constexpr int W = SW / 4;
    for (int rb = warp * 128; rb < rows; rb += kConsumerWarps * 128) {
      const int r0 = rb + 4 * lane;
      if (r0 >= rows) continue;
      uint32_t x[4 * W];
      const uint4* src = reinterpret_cast<const uint4*>(buf + r0 * SW);
#pragma unroll
      for (int v = 0; v < W; ++v) {
        const uint4 a = src[v];
        x[4 * v] = a.x;
        x[4 * v + 1] = a.y;
        x[4 * v + 2] = a.z;
        x[4 * v + 3] = a.w;
      }
      const int bi = block_of(r0);
      const int valid = vr[bi] - (r0 - bi * BR);   // rows r0 + i, i < valid
      for (int g = 0; g < G; ++g) {
        uint32_t q[W];
#pragma unroll
        for (int w = 0; w < W; ++w) q[w] = qbits[g * nwp + w];
        int sc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int pop = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) pop += __popc(x[i * W + w] ^ q[w]);
          sc[i] = i < valid ? D - 2 * pop : qsum[g];
        }
        *reinterpret_cast<int4*>(ob + g * R + r0) =
            make_int4(sc[0], sc[1], sc[2], sc[3]);
      }
    }
  } else {
    constexpr int C = SW / 16;
    const int rot = row_rot(C, lane);
    for (int g = 0; g < G; ++g) {
      const uint4* qv = reinterpret_cast<const uint4*>(qbits + g * nwp);
      uint4 q[C];
#pragma unroll
      for (int s = 0; s < C; ++s) q[s] = qv[(s + rot) & (C - 1)];
      for (int rb = warp * 32; rb < rows; rb += kConsumerWarps * 32) {
        const int r = rb + lane;
        if (r >= rows) continue;
        const int bi = block_of(r);
        const uint4* x = reinterpret_cast<const uint4*>(buf + r * SW);
        int pop = 0;
#pragma unroll
        for (int s = 0; s < C; ++s) {
          const uint4 a = x[(s + rot) & (C - 1)];
          pop += __popc(a.x ^ q[s].x) + __popc(a.y ^ q[s].y)
               + __popc(a.z ^ q[s].z) + __popc(a.w ^ q[s].w);
        }
        ob[g * R + r] = r - bi * BR < vr[bi] ? D - 2 * pop : qsum[g];
      }
    }
  }
}

// q_sign (B, D) int8 +-1; plane (N, D/8) uint8; ids (B / G, J) int32;
// out (B, J * BR) int32. CTA blockIdx.x is chunk blockIdx.x % chunks (of
// `chunk` blocks) of table blockIdx.x / chunks.
template <int SW>
__global__ void __launch_bounds__(kBulkThreads)
sign_bulk_kernel(const int8_t* __restrict__ q_sign,
                 const uint8_t* __restrict__ plane,
                 const int32_t* __restrict__ ids, int32_t* __restrict__ out,
                 long long N, int J, int BR, int D, int G, int chunk,
                 int chunks, int stage_blocks, int nwp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  const int D8 = D / 8;
  const long long block_bytes = static_cast<long long>(BR) * D8;
  const long long stage_bytes = stage_blocks * block_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingStages
                                               * stage_bytes);
  uint64_t* empty = full + kRingStages;
  uint32_t* qbits = reinterpret_cast<uint32_t*>(empty + kRingStages);
  int* qsum = reinterpret_cast<int*>(qbits + G * nwp);
  int* vrows = qsum + G;   // [kRingStages][stage_blocks] valid rows
  int* sids = vrows + kRingStages * stage_blocks;   // [ids_window] ids

  const int t = blockIdx.x / chunks;
  const int j0 = (blockIdx.x % chunks) * chunk;
  const int nblk = min(chunk, J - j0);
  const int stages = (nblk + stage_blocks - 1) / stage_blocks;
  const int32_t* tids = ids + static_cast<size_t>(t) * J + j0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // The producer: the chunk's block ids a window at a time, then stage
    // k's blocks [k * stage_blocks, ...) into ring slot k % kRingStages
    // once the consumers have released it, each block's valid rows beside
    // the ring (written before lane 0's arrive, which releases them).
    const int window = ids_window(stage_blocks);
    for (int k = 0; k < stages; ++k) {
      const int slot = k % kRingStages;
      const int b0 = k * stage_blocks;
      const int nb = min(stage_blocks, nblk - b0);
      const int w0 = b0 % window;
      if (w0 == 0) {
        const int nw = min(window, nblk - b0);
        for (int base = lane; base < nw; base += 8 * 32) {
          int v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            v[u] = base + 32 * u < nw ? tids[b0 + base + 32 * u] : 0;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (base + 32 * u < nw) sids[base + 32 * u] = v[u];
          }
        }
      }
      if (lane == 0) {
        mbar_wait(&empty[slot],
                  static_cast<uint32_t>((k / kRingStages) & 1) ^ 1u);
      }
      __syncwarp();
      uint32_t bytes = 0;
      for (int i = lane; i < nb; i += 32) {
        const uint32_t vb = valid_bytes(sids[w0 + i], N, BR, D8);
        bytes += vb;
        vrows[slot * stage_blocks + i] = static_cast<int>(vb / D8);
      }
      bytes = __reduce_add_sync(0xFFFFFFFFu, bytes);
      if (lane == 0) mbar_expect_tx(&full[slot], bytes);
      __syncwarp();
      uint8_t* dst = ring + slot * stage_bytes;
      for (int i = lane; i < nb; i += 32) {
        const long long id = sids[w0 + i];
        const uint32_t vb = valid_bytes(id, N, BR, D8);
        if (vb) {
          bulk_load(dst + i * block_bytes, plane + id * block_bytes, vb,
                    &full[slot]);
        }
      }
      __syncwarp();
    }
    return;
  }

  // The consumers: pack the group's signs (word i of lane g at
  // qbits[g * nwp + i], zero past D), then each lane's sum(q_sign).
  const int8_t* qg = q_sign + static_cast<size_t>(t) * G * D;
  const int words = G * nwp;
  for (int i = threadIdx.x; i < words; i += kConsumerWarps * 32) {
    const int w = i % nwp;
    const int8_t* qw = qg + static_cast<size_t>(i / nwp) * D + 32 * w;
    uint32_t bits = 0;
    if (32 * w < D) {   // D % 32 == 0 at every width the kernel takes
      const uint4* v = reinterpret_cast<const uint4*>(qw);
      bits = sign_bits(__ldg(v)) | sign_bits(__ldg(v + 1)) << 16;
    }
    qbits[i] = bits;
  }
  asm volatile("bar.sync 1, %0;\n" :: "r"(kConsumerWarps * 32) : "memory");
  for (int g = threadIdx.x; g < G; g += kConsumerWarps * 32) {
    int pop = 0;
    for (int w = 0; w < nwp; ++w) pop += __popc(qbits[g * nwp + w]);
    qsum[g] = D - 2 * pop;
  }
  asm volatile("bar.sync 1, %0;\n" :: "r"(kConsumerWarps * 32) : "memory");

  const long long R = static_cast<long long>(J) * BR;
  for (int k = 0; k < stages; ++k) {
    const int slot = k % kRingStages;
    const int b0 = k * stage_blocks;
    mbar_wait(&full[slot], static_cast<uint32_t>((k / kRingStages) & 1));
    score_stage<SW>(
        ring + slot * stage_bytes, vrows + slot * stage_blocks,
        out + static_cast<size_t>(t) * G * R
            + static_cast<long long>(j0 + b0) * BR,
        R, min(stage_blocks, nblk - b0) * BR, BR, D, G, qbits, nwp, qsum,
        warp, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

template <int SW>
cudaError_t launch_bulk(const int8_t* q, const uint8_t* p,
                        const int32_t* ids, int32_t* o, int B, long long N,
                        int J, int BR, int D, int G, cudaStream_t stream) {
  const BulkShape s = bulk_shape(D / 8, BR, G);
  auto kernel = sign_bulk_kernel<SW>;
  const size_t smem = static_cast<size_t>(s.smem);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // The occupancy query costs host microseconds per call: kept per
  // instance for the last device and shared-memory size (a stale value
  // could only change the grid's chunking, never a result).
  static int last_dev = -1, last_per_sm = 0;
  static size_t last_smem = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int per_sm = last_per_sm;
  if (dev != last_dev || smem != last_smem || per_sm < 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBulkThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
    last_per_sm = per_sm;
  }
  if (per_sm > kMaxPerSm) per_sm = kMaxPerSm;
  // Chunks per table so that all the tables' CTAs fit the card's resident
  // slots once (one chunk per table at the least, one block per chunk at
  // the most).
  const long long tables = B / G;
  const long long slots = static_cast<long long>(sm_count()) * per_sm;
  long long chunks = slots / tables;
  if (chunks > J) chunks = J;
  if (chunks < 1) chunks = 1;
  const long long chunk = (J + chunks - 1) / chunks;
  chunks = (J + chunk - 1) / chunk;
  if (tables * chunks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tables * chunks), kBulkThreads, smem,
           stream>>>(q, p, ids, o, N, J, BR, D, G,
                     static_cast<int>(chunk), static_cast<int>(chunks),
                     s.stage_blocks, s.nwp);
  return cudaGetLastError();
}

}  // namespace

// 2 when stage0_sign_bulk_launch takes this shape (plane: the sign plane's
// base address) and the route should take it: rows of 4, 8 or 16 bytes,
// the decode widths, where it beat the popcount kernel in every H100 run
// (PERF.md). 1 when it takes the shape but the popcount kernel was as
// fast or faster: rows of 32-128 bytes, the cluster and resident shapes.
// 0 when it does not take it. The popcount sign_gather_kernel of
// stage0_sign.cu takes every shape.
extern "C" int stage0_sign_bulk_takes(const void* plane, long long N, int D8,
                                      int BR, int G) {
  if (!bulk_takes(plane, N, D8, BR, G)) return 0;
  return D8 <= 16 ? 2 : 1;
}

// q_sign (B, D) int8, sign_plane (N, D/8) uint8, block_ids (B / G, J)
// int32, out (B, J * BR) int32. Refuses (cudaErrorInvalidValue) a shape
// stage0_sign_bulk_takes gives 0, D % 8 != 0, or a G that does not divide
// B.
extern "C" int stage0_sign_bulk_launch(const void* q_sign,
                                       const void* sign_plane,
                                       const void* block_ids, void* out,
                                       int B, long long N, int J, int BR,
                                       int D, int G, void* stream) {
  if (D <= 0 || D % 8 || B <= 0 || J <= 0 || G <= 0 || B % G
      || !bulk_takes(sign_plane, N, D / 8, BR, G)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* q = static_cast<const int8_t*>(q_sign);
  const auto* p = static_cast<const uint8_t*>(sign_plane);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D / 8) {
    case 4: err = launch_bulk<4>(q, p, ids, o, B, N, J, BR, D, G, s); break;
    case 8: err = launch_bulk<8>(q, p, ids, o, B, N, J, BR, D, G, s); break;
    case 16: err = launch_bulk<16>(q, p, ids, o, B, N, J, BR, D, G, s); break;
    case 32: err = launch_bulk<32>(q, p, ids, o, B, N, J, BR, D, G, s); break;
    case 64: err = launch_bulk<64>(q, p, ids, o, B, N, J, BR, D, G, s); break;
    default: err = launch_bulk<128>(q, p, ids, o, B, N, J, BR, D, G, s);
  }
  return static_cast<int>(err);
}
