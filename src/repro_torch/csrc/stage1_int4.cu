// Stage-1 MSB-nibble (INT4) scoring on Hopper: the shared-plane scan, the
// per-lane rows scan and the per-lane block-gather scan.
//
// Replaces four Pallas TPU kernels of the reference package:
//   plane:  src/repro/kernels/stage1_int4.py    stage1_int4_batched_pallas
//           and, at B = 1, stage1_int4_pallas (the single-query form)
//   rows:   src/repro/kernels/stage1_int4.py    stage1_int4_rows_pallas
//   gather: src/repro/kernels/stage1_gather.py  stage1_int4_gather_pallas
//
// All compute  score = sum_j q_even[j] * sext4(lo(byte j))
//                    + q_odd[j]  * sext4(hi(byte j))
// over packed MSB-nibble rows with __dp4a on pre-shifted words, without
// unpacking a nibble (nibble.cuh).
//
// Widths: every even D. Rows are read 16 bytes at a time when D/2 % 16 ==
// 0, word by word when D/2 % 4 == 0 and byte by byte otherwise (rows of
// D/2 bytes are then not word aligned); the last partial 64-byte chunk is
// masked. The query panels sit in dynamic shared memory, raised above the
// default 48 KiB with cudaFuncSetAttribute when a width needs it (Hopper
// allows 227 KiB per block). A D whose one-lane panels do not fit (D/2
// above ~116 K bytes) walks the panels through shared memory kPanelSpan
// words at a time; that loop is compiled only into the `wide` instances,
// so the D = 512 code is untouched.
//
// Rows per thread block (ROWS: 128, 256, 512 or 1024, one row per thread)
// is the plane and rows kernels' schedule knob, which the measured
// autotuner (kernels/autotune.py) picks per batch bucket; 256 is the
// default and the code every caller gets without a tuned table. Each
// instance is compiled with __launch_bounds__(ROWS), so the compiler fits
// its registers to the block; a choice that still cannot launch is
// refused by the launch and left out by the tuner.
//
// What bounds the plane scan on an H100 at N = 2^20, D = 512, B = 32: it
// reads the 256 MiB plane once and writes the (B, N) int32 scores
// (128 MiB), about 120 us at 3.35 TB/s; its 2*B*N*D = 34 G int8 operations
// would take 17 us on the int8 tensor cores. On dp4a (4 MACs per
// instruction, integer pipe) it is compute-bound above the byte bound
// (0.45 ms), so the batched scan runs on the tensor cores instead
// (stage1_mma.cu) wherever that kernel's launcher takes the shape (B >= 2,
// D/2 % 16 == 0, its panels fit); this kernel serves the single query and
// every shape stage1_mma_lanes refuses.
// Design: a block of ROWS threads owns ROWS consecutive plane rows (one per
// thread) and a tile of up to BT = 32 query lanes, whose even/odd nibble
// panel sits in shared memory and is read by broadcast. Each thread turns
// 64 bytes of its row at a time into 32 pre-shifted words held in registers
// and reuses them for every lane of the tile, so the row is read from
// device memory once per tile of lanes and the (B, N) stores are coalesced
// across the warp (consecutive rows). At large D the lane tile shrinks
// until 2 * BT * D/2 bytes of panels fit in shared memory. The kernel masks
// its own ragged row edge: the plane is never padded or copied. The
// single-query form is the BT = 1 instance.
//
// The rows scan is the same arithmetic over per-lane row blocks (B, W, D/2):
// grid.y walks lanes, a block scores ROWS of that lane's rows against the
// lane's query held in shared memory. At W = 2048 it moves 32 MiB and is
// bound by launch latency rather than bytes.
//
// The gather scan is the rows scan with one change: view row r of lane b is
// plane row ids[b, r / BR] * BR + r % BR, read in place (the Pallas kernel
// streams the same blocks through scalar prefetch). View rows at or past N
// score 0 and are never read, so a ragged plane is not padded. This dp4a
// `gather_kernel` serves the shapes the TMA gather of stage1_gather.cu
// (`gather_tma_kernel`, which the cluster path takes at D = 512, BR = 64)
// refuses: D/2 % 16 != 0, block_rows not a multiple of 64, N >= 2^31.
// Each thread block owns a run of 256 view rows of one lane, after it
// copies the lane's panels to shared memory; thread t reads its own row,
// so a warp's 16-byte load touches 32 rows. The bound counts the distinct
// plane rows (17.8 us at the cluster shape, stage1_gather.cu).

#include "nibble.cuh"

namespace {

constexpr int kGatherThreads = 256;  // the gather's rows per block
constexpr int kPanelSpan = 4096;     // panel words per half in a wide pass

// q_panel (2, B, D2) int8; plane (N, D2) uint8; out (B, N) int32.
// VEC needs D2 % 16 == 0; TAIL when D2 % 64 != 0 (a last, partial chunk).
// BT query lanes per block (blockIdx.y walks lane tiles); each lane's
// panel is zero-padded in shared memory to words_pad, a multiple of 16
// words.
template <int BT, int ROWS, int MODE, bool TAIL>
__global__ void __launch_bounds__(ROWS)
plane_kernel(const int8_t* __restrict__ q_panel,
             const uint8_t* __restrict__ plane,
             int32_t* __restrict__ out, int B, long long N, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][BT][words_pad]
  const int words = (D2 + 3) / 4;
  const int words_pad = (words + kChunkWords - 1) / kChunkWords * kChunkWords;
  const int b0 = blockIdx.y * BT;
  for (int i = threadIdx.x; i < 2 * BT * words_pad; i += ROWS) {
    const int half = i / (BT * words_pad);
    const int b = (i / words_pad) % BT;
    const int w = i % words_pad;
    q_s[i] = (b0 + b < B && w < words)
        ? operand_word<MODE>(q_panel, static_cast<size_t>(half) * B + b0 + b,
                             w, D2)
        : 0u;
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * ROWS
                        + threadIdx.x;
  if (row >= N) return;

  int acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0;

  const uint8_t* rowp = plane + static_cast<size_t>(row) * D2;
  // The masked tail is compiled only into the TAIL instances: in the same
  // body as the whole-chunk loop it raised the 32-lane tile from 126 to 154
  // registers and slowed the D = 512 scan by a fifth on an H100.
  const int full = TAIL ? D2 / 4 / kChunkWords * kChunkWords : words;
  for (int c = 0; c < full; c += kChunkWords) {
    int lo[kChunkWords], hi[kChunkWords];
    load_chunk<MODE, false>(rowp, c, D2, lo, hi);
    dot_chunk<BT>(q_s, words_pad, c, lo, hi, acc);
  }
  if constexpr (TAIL) {
    int lo[kChunkWords], hi[kChunkWords];
    load_chunk<MODE, true>(rowp, full, D2, lo, hi);
    dot_chunk<BT>(q_s, words_pad, full, lo, hi, acc);
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      out[static_cast<size_t>(b0 + b) * N + row] = acc[b] >> 4;
    }
  }
}

// The plane scan for a D whose one-lane panels do not fit in shared
// memory: one lane per block (blockIdx.y), its panels walked through
// shared memory kPanelSpan words per half at a time.
template <int ROWS, int MODE>
__global__ void __launch_bounds__(ROWS)
plane_wide_kernel(const int8_t* __restrict__ q_panel,
                  const uint8_t* __restrict__ plane,
                  int32_t* __restrict__ out, int B, long long N, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][kPanelSpan]
  const int words = (D2 + 3) / 4;
  const int full = D2 / 4 / kChunkWords * kChunkWords;
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS
                        + threadIdx.x;
  const uint8_t* rowp = plane + static_cast<size_t>(row) * D2;
  int acc[1] = {0};
  for (int c0 = 0; c0 < words; c0 += kPanelSpan) {
    __syncthreads();  // every thread is done with the previous span
    for (int i = threadIdx.x; i < 2 * kPanelSpan; i += ROWS) {
      const int w = c0 + i % kPanelSpan;
      q_s[i] = w < words
          ? operand_word<MODE>(q_panel,
                               static_cast<size_t>(i / kPanelSpan) * B + b,
                               w, D2)
          : 0u;
    }
    __syncthreads();
    if (row >= N) continue;
    const int end = min(c0 + kPanelSpan, full);
    for (int c = c0; c < end; c += kChunkWords) {
      int lo[kChunkWords], hi[kChunkWords];
      load_chunk<MODE, false>(rowp, c, D2, lo, hi);
      dot_chunk<1>(q_s, kPanelSpan, c - c0, lo, hi, acc);
    }
    if (full < words && full >= c0 && full < c0 + kPanelSpan) {
      int lo[kChunkWords], hi[kChunkWords];
      load_chunk<MODE, true>(rowp, full, D2, lo, hi);
      dot_chunk<1>(q_s, kPanelSpan, full - c0, lo, hi, acc);
    }
  }
  if (row < N) out[static_cast<size_t>(b) * N + row] = acc[0] >> 4;
}

// 16 * (words [c0, c0 + span) of one packed row . an [even; odd] panel of
// span words each in shared memory), added to s. kVec needs span % 4 == 0
// and c0 % 4 == 0 (16-byte aligned reads).
template <int MODE>
__device__ __forceinline__ int row_dot(const uint8_t* __restrict__ row,
                                       const uint32_t* q_s, int c0, int span,
                                       int d2, int s) {
  if constexpr (MODE == kVec) {
    const uint4* rowp = reinterpret_cast<const uint4*>(row) + c0 / 4;
    const uint4* qe = reinterpret_cast<const uint4*>(q_s);
    const uint4* qo = reinterpret_cast<const uint4*>(q_s + span);
    for (int v = 0; v < span / 4; ++v) {
      const uint4 x = __ldg(rowp + v);
      const uint4 e = qe[v];
      const uint4 o = qo[v];
      s = __dp4a(lo16(x.x), static_cast<int>(e.x), s);
      s = __dp4a(lo16(x.y), static_cast<int>(e.y), s);
      s = __dp4a(lo16(x.z), static_cast<int>(e.z), s);
      s = __dp4a(lo16(x.w), static_cast<int>(e.w), s);
      s = __dp4a(hi16(x.x), static_cast<int>(o.x), s);
      s = __dp4a(hi16(x.y), static_cast<int>(o.y), s);
      s = __dp4a(hi16(x.z), static_cast<int>(o.z), s);
      s = __dp4a(hi16(x.w), static_cast<int>(o.w), s);
    }
  } else {
    const uint32_t* rowp = reinterpret_cast<const uint32_t*>(row);
    for (int w = 0; w < span; ++w) {
      const uint32_t x = MODE == kWord ? __ldg(rowp + c0 + w)
                                       : byte_word(row, c0 + w, d2);
      s = __dp4a(lo16(x), static_cast<int>(q_s[w]), s);
      s = __dp4a(hi16(x), static_cast<int>(q_s[span + w]), s);
    }
  }
  return s;
}

// Copies lane b's [even; odd] panel (rows 2b and 2b + 1 of q_eo, D2 bytes
// each) to shared memory as 2 x ceil(D2 / 4) words.
template <int ROWS, int MODE>
__device__ __forceinline__ void load_lane_panel(const int8_t* __restrict__ q_eo,
                                                uint32_t* q_s, int b, int d2) {
  const int words = (d2 + 3) / 4;
  if constexpr (MODE == kByte) {
    for (int i = threadIdx.x; i < 2 * words; i += ROWS) {
      q_s[i] = operand_word<MODE>(q_eo, 2 * b + i / words, i % words, d2);
    }
  } else {
    const uint32_t* qg = reinterpret_cast<const uint32_t*>(
        q_eo + static_cast<size_t>(b) * 8 * words);
    for (int i = threadIdx.x; i < 2 * words; i += ROWS) q_s[i] = qg[i];
  }
  __syncthreads();
}

// 16 * (row . lane b's panel) for a D too wide for the whole panel: the
// panel walks through shared memory kPanelSpan words per half at a time.
// Every thread of the block calls it (it synchronises); `row` is null for
// a thread that scores no row.
template <int ROWS, int MODE>
__device__ int wide_row_dot(const int8_t* __restrict__ q_eo, uint32_t* q_s,
                            int b, const uint8_t* __restrict__ row, int d2) {
  const int words = (d2 + 3) / 4;
  int s = 0;
  for (int c0 = 0; c0 < words; c0 += kPanelSpan) {
    const int span = min(kPanelSpan, words - c0);
    __syncthreads();  // every thread is done with the previous span
    for (int i = threadIdx.x; i < 2 * span; i += ROWS) {
      q_s[i] = operand_word<MODE>(q_eo, 2 * b + i / span, c0 + i % span, d2);
    }
    __syncthreads();
    if (row != nullptr) s = row_dot<MODE>(row, q_s, c0, span, d2, s);
  }
  return s;
}

// q_eo (B, 2, D2) int8; rows (B, W, D2) uint8; out (B, W) int32;
// blockIdx.y is the lane.
template <int ROWS, int MODE, bool WIDE>
__global__ void __launch_bounds__(ROWS)
rows_kernel(const int8_t* __restrict__ q_eo,
            const uint8_t* __restrict__ rows,
            int32_t* __restrict__ out, long long W, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][words]
  const int b = blockIdx.y;
  const long long r = static_cast<long long>(blockIdx.x) * ROWS
                      + threadIdx.x;
  if constexpr (WIDE) {
    const uint8_t* row = r < W
        ? rows + (static_cast<size_t>(b) * W + r) * D2 : nullptr;
    const int s = wide_row_dot<ROWS, MODE>(q_eo, q_s, b, row, D2);
    if (row != nullptr) out[static_cast<size_t>(b) * W + r] = s >> 4;
  } else {
    load_lane_panel<ROWS, MODE>(q_eo, q_s, b, D2);
    if (r >= W) return;
    const int s = row_dot<MODE>(rows + (static_cast<size_t>(b) * W + r) * D2,
                                q_s, 0, (D2 + 3) / 4, D2, 0);
    out[static_cast<size_t>(b) * W + r] = s >> 4;
  }
}

// q_eo (B, 2, D2) int8; plane (N, D2) uint8; ids (B, J) int32 block ids;
// out (B, J * BR) int32. View rows at or past N (or before 0) score 0.
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const int8_t* __restrict__ q_eo,
              const uint8_t* __restrict__ plane,
              const int32_t* __restrict__ ids,
              int32_t* __restrict__ out, long long N, int J, int BR, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][words]
  const int b = blockIdx.y;
  const long long R = static_cast<long long>(J) * BR;
  const long long r = static_cast<long long>(blockIdx.x) * kGatherThreads
                      + threadIdx.x;
  if constexpr (WIDE) {
    const uint8_t* rowp = nullptr;
    if (r < R) {
      const long long id = ids[static_cast<size_t>(b) * J + r / BR];
      const long long row = id * BR + r % BR;
      if (row >= 0 && row < N) rowp = plane + static_cast<size_t>(row) * D2;
    }
    const int s = wide_row_dot<kGatherThreads, MODE>(q_eo, q_s, b, rowp, D2);
    if (r < R) out[static_cast<size_t>(b) * R + r] = s >> 4;
  } else {
    load_lane_panel<kGatherThreads, MODE>(q_eo, q_s, b, D2);
    if (r >= R) return;
    const long long id = ids[static_cast<size_t>(b) * J + r / BR];
    const long long row = id * BR + r % BR;
    int s = 0;
    if (row >= 0 && row < N) {
      s = row_dot<MODE>(plane + static_cast<size_t>(row) * D2, q_s, 0,
                        (D2 + 3) / 4, D2, 0);
    }
    out[static_cast<size_t>(b) * R + r] = s >> 4;
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct PlaneArgs {
  const int8_t* q;
  const uint8_t* plane;
  int32_t* out;
  int B;
  long long N;
  int D2;
  cudaStream_t stream;
};

template <int BT, int ROWS, int MODE, bool TAIL>
cudaError_t launch_plane(const PlaneArgs& a) {
  const long long words_pad = round_up((a.D2 + 3) / 4, kChunkWords);
  const size_t smem = static_cast<size_t>(2) * BT * words_pad * 4;
  const dim3 grid(static_cast<unsigned>((a.N + ROWS - 1) / ROWS),
                  static_cast<unsigned>((a.B + BT - 1) / BT));
  return launch(plane_kernel<BT, ROWS, MODE, TAIL>, grid, ROWS, smem,
                a.stream, a.q, a.plane, a.out, a.B, a.N, a.D2);
}

template <int ROWS, int MODE, bool TAIL>
cudaError_t launch_plane_tile(int bt, const PlaneArgs& a) {
  switch (bt) {
    case 1: return launch_plane<1, ROWS, MODE, TAIL>(a);
    case 2: return launch_plane<2, ROWS, MODE, TAIL>(a);
    case 4: return launch_plane<4, ROWS, MODE, TAIL>(a);
    case 8: return launch_plane<8, ROWS, MODE, TAIL>(a);
    case 16: return launch_plane<16, ROWS, MODE, TAIL>(a);
    default: return launch_plane<32, ROWS, MODE, TAIL>(a);
  }
}

template <int ROWS, int MODE>
cudaError_t launch_plane_wide(const PlaneArgs& a) {
  const dim3 grid(static_cast<unsigned>((a.N + ROWS - 1) / ROWS),
                  static_cast<unsigned>(a.B));
  return launch(plane_wide_kernel<ROWS, MODE>, grid, ROWS,
                static_cast<size_t>(2) * kPanelSpan * 4, a.stream, a.q,
                a.plane, a.out, a.B, a.N, a.D2);
}

template <int ROWS>
cudaError_t launch_plane_rows(int bt, bool wide, const PlaneArgs& a) {
  const int mode = mode_for(a.D2);
  if (wide) {
    if (mode == kVec) return launch_plane_wide<ROWS, kVec>(a);
    if (mode == kWord) return launch_plane_wide<ROWS, kWord>(a);
    return launch_plane_wide<ROWS, kByte>(a);
  }
  if (a.D2 % 64 == 0) return launch_plane_tile<ROWS, kVec, false>(bt, a);
  if (mode == kVec) return launch_plane_tile<ROWS, kVec, true>(bt, a);
  if (mode == kWord) return launch_plane_tile<ROWS, kWord, true>(bt, a);
  return launch_plane_tile<ROWS, kByte, true>(bt, a);
}

template <int ROWS, int MODE>
cudaError_t launch_rows_mode(const int8_t* q, const uint8_t* r, int32_t* o,
                             int B, long long W, int D2, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((W + ROWS - 1) / ROWS),
                  static_cast<unsigned>(B));
  const size_t panel = static_cast<size_t>(2) * ((D2 + 3) / 4) * 4;
  if (panel > static_cast<size_t>(kMaxSmem)) {
    return launch(rows_kernel<ROWS, MODE, true>, grid, ROWS,
                  static_cast<size_t>(2) * kPanelSpan * 4, s, q, r, o, W, D2);
  }
  return launch(rows_kernel<ROWS, MODE, false>, grid, ROWS, panel, s, q, r,
                o, W, D2);
}

template <int ROWS>
cudaError_t launch_rows(const int8_t* q, const uint8_t* r, int32_t* o, int B,
                        long long W, int D2, cudaStream_t s) {
  const int mode = mode_for(D2);
  if (mode == kVec) return launch_rows_mode<ROWS, kVec>(q, r, o, B, W, D2, s);
  if (mode == kWord) {
    return launch_rows_mode<ROWS, kWord>(q, r, o, B, W, D2, s);
  }
  return launch_rows_mode<ROWS, kByte>(q, r, o, B, W, D2, s);
}

template <int MODE>
cudaError_t launch_gather(const int8_t* q, const uint8_t* p,
                          const int32_t* ids, int32_t* o, int B, long long N,
                          int J, int BR, int D2, cudaStream_t s) {
  const long long R = static_cast<long long>(J) * BR;
  const dim3 grid(static_cast<unsigned>((R + kGatherThreads - 1)
                                        / kGatherThreads),
                  static_cast<unsigned>(B));
  const size_t panel = static_cast<size_t>(2) * ((D2 + 3) / 4) * 4;
  if (panel > static_cast<size_t>(kMaxSmem)) {
    return launch(gather_kernel<MODE, true>, grid, kGatherThreads,
                  static_cast<size_t>(2) * kPanelSpan * 4, s, q, p, ids, o, N,
                  J, BR, D2);
  }
  return launch(gather_kernel<MODE, false>, grid, kGatherThreads, panel, s, q,
                p, ids, o, N, J, BR, D2);
}

}  // namespace

// rows: threads (plane rows) per block, one of 128, 256, 512, 1024.
extern "C" int stage1_plane_launch(const void* q_panel, const void* plane,
                                   void* out, int B, long long N, int D2,
                                   int rows, void* stream) {
  // The smallest power-of-two lane tile that covers B (at most 32), halved
  // while its panels exceed the shared memory one block may hold; past one
  // lane, the wide kernel walks the panels through shared memory.
  int bt = 1;
  while (bt < B && bt < 32) bt *= 2;
  const long long words_pad = round_up((D2 + 3) / 4, kChunkWords);
  while (bt > 1 && 2LL * bt * words_pad * 4 > kMaxSmem) bt /= 2;
  const bool wide = 2LL * words_pad * 4 > kMaxSmem;
  const PlaneArgs a{static_cast<const int8_t*>(q_panel),
                    static_cast<const uint8_t*>(plane),
                    static_cast<int32_t*>(out), B, N, D2,
                    static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (rows) {
    case 128: err = launch_plane_rows<128>(bt, wide, a); break;
    case 256: err = launch_plane_rows<256>(bt, wide, a); break;
    case 512: err = launch_plane_rows<512>(bt, wide, a); break;
    case 1024: err = launch_plane_rows<1024>(bt, wide, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int stage1_rows_launch(const void* q_eo, const void* rows_in,
                                  void* out, int B, long long W, int D2,
                                  int rows, void* stream) {
  const auto* q = static_cast<const int8_t*>(q_eo);
  const auto* r = static_cast<const uint8_t*>(rows_in);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows) {
    case 128: err = launch_rows<128>(q, r, o, B, W, D2, s); break;
    case 256: err = launch_rows<256>(q, r, o, B, W, D2, s); break;
    case 512: err = launch_rows<512>(q, r, o, B, W, D2, s); break;
    case 1024: err = launch_rows<1024>(q, r, o, B, W, D2, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int stage1_gather_launch(const void* q_eo, const void* plane,
                                    const void* block_ids, void* out, int B,
                                    long long N, int J, int BR, int D2,
                                    void* stream) {
  const auto* q = static_cast<const int8_t*>(q_eo);
  const auto* p = static_cast<const uint8_t*>(plane);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int mode = mode_for(D2);
  cudaError_t err;
  if (mode == kVec) {
    err = launch_gather<kVec>(q, p, ids, o, B, N, J, BR, D2, s);
  } else if (mode == kWord) {
    err = launch_gather<kWord>(q, p, ids, o, B, N, J, BR, D2, s);
  } else {
    err = launch_gather<kByte>(q, p, ids, o, B, N, J, BR, D2, s);
  }
  return static_cast<int>(err);
}
