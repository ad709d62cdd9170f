// Stage-1 MSB-nibble (INT4) scoring of per-lane rows and of per-lane
// gathered blocks on Hopper's dp4a path.
//
// Replaces two Pallas TPU kernels of the reference package:
//   rows:   src/repro/kernels/stage1_int4.py    stage1_int4_rows_pallas
//   gather: src/repro/kernels/stage1_gather.py  stage1_int4_gather_pallas
//           (for the shapes the TMA gather of stage1_gather.cu refuses)
// with the plane scan's arithmetic (stage1_int4.cu): __dp4a on
// pre-shifted words of packed MSB-nibble rows (nibble.cuh). The rows read
// 16 bytes, words or single bytes as D/2 allows (`mode_for`), and a D
// whose one-lane panels do not fit in shared memory walks them through
// it kPanelSpan words per half at a time.
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
