// Stage-1 MSB-nibble (INT4) shared-plane scan on Hopper's dp4a path, and
// its single-query form: the kernels and their launch, which two sources
// compile, one per pair of tiles (stage1_int4.cu: 128 and 256 rows per
// block; stage1_int4_tall.cu: 512 and 1024), so the two build in parallel.
//
// Replaces two Pallas TPU kernels of the reference package:
//   src/repro/kernels/stage1_int4.py  stage1_int4_batched_pallas
//   src/repro/kernels/stage1_int4.py  stage1_int4_pallas (B = 1)
// The per-lane rows scan and the dp4a block gather, which share the
// arithmetic, live in stage1_rows.cu.
//
// Computes  score = sum_j q_even[j] * sext4(lo(byte j))
//                 + q_odd[j]  * sext4(hi(byte j))
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

#pragma once

#include "nibble.cuh"

namespace {

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

// stage1_plane_launch for a source that compiles the ROWS_A- and
// ROWS_B-row instances: the smallest power-of-two lane tile that covers B
// (at most 32), halved while its panels exceed the shared memory one block
// may hold; past one lane, the wide kernel walks the panels through shared
// memory. Any other `rows` is refused (cudaErrorInvalidValue).
template <int ROWS_A, int ROWS_B>
int plane_launch(const void* q_panel, const void* plane, void* out, int B,
                 long long N, int D2, int rows, void* stream) {
  int bt = 1;
  while (bt < B && bt < 32) bt *= 2;
  const long long words_pad = round_up((D2 + 3) / 4, kChunkWords);
  while (bt > 1 && 2LL * bt * words_pad * 4 > kMaxSmem) bt /= 2;
  const bool wide = 2LL * words_pad * 4 > kMaxSmem;
  const PlaneArgs a{static_cast<const int8_t*>(q_panel),
                    static_cast<const uint8_t*>(plane),
                    static_cast<int32_t*>(out), B, N, D2,
                    static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (rows == ROWS_A) err = launch_plane_rows<ROWS_A>(bt, wide, a);
  if (rows == ROWS_B) err = launch_plane_rows<ROWS_B>(bt, wide, a);
  return static_cast<int>(err);
}

}  // namespace
