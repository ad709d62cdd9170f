// Stage-1 MSB-nibble (INT4) scoring on Hopper: the shared-plane scan, the
// per-lane rows scan and the per-lane block-gather scan.
//
// Replaces three Pallas TPU kernels of the reference package:
//   plane:  src/repro/kernels/stage1_int4.py    stage1_int4_batched_pallas
//   rows:   src/repro/kernels/stage1_int4.py    stage1_int4_rows_pallas
//   gather: src/repro/kernels/stage1_gather.py  stage1_int4_gather_pallas
//
// All compute  score = sum_j q_even[j] * sext4(lo(byte j))
//                    + q_odd[j]  * sext4(hi(byte j))
// over packed MSB-nibble rows (byte j: dim 2j in the low nibble, dim 2j+1 in
// the high nibble, raw two's complement). No nibble is unpacked: for a plane
// word w, (w << 4) & 0xF0F0F0F0 holds 16 * sext4(lo) in each signed byte and
// w & 0xF0F0F0F0 holds 16 * sext4(hi), so __dp4a against the query's even
// and odd nibble words sums 16 * score, and an arithmetic shift right by 4
// is exact.
//
// Widths: every D with D % 8 == 0 (D/2 bytes a whole number of 32-bit
// words per row). Rows are read 16 bytes at a time when D/2 % 16 == 0 and
// word by word otherwise; the last partial chunk is masked word by word.
// The query panels sit in dynamic shared memory, raised above the default
// 48 KiB with cudaFuncSetAttribute when a width needs it (Hopper allows
// 227 KiB per block); a D whose panels do not fit is refused.
//
// What bounds the plane scan on an H100 at N = 2^20, D = 512, B = 32: it
// reads the 256 MiB plane once and writes the (B, N) int32 scores
// (128 MiB), about 120 us at 3.35 TB/s; its 2*B*N*D = 34 G int8 operations
// would take 17 us on the int8 tensor cores. On dp4a (4 MACs per
// instruction, integer pipe) it is compute-bound above the byte bound.
// Design: a block of 256 threads owns 256 consecutive plane rows (one per
// thread) and a tile of up to BT = 32 query lanes, whose even/odd nibble
// panel sits in shared memory and is read by broadcast. Each thread turns
// 64 bytes of its row at a time into 32 pre-shifted words held in registers
// and reuses them for every lane of the tile, so the row is read from
// device memory once per tile of lanes and the (B, N) stores are coalesced
// across the warp (consecutive rows). At large D the lane tile shrinks
// until 2 * BT * D/2 bytes of panels fit in shared memory. The kernel masks
// its own ragged row edge: the plane is never padded or copied. wgmma s8
// is later work.
//
// The rows scan is the same arithmetic over per-lane row blocks (B, W, D/2):
// grid.y walks lanes, a block scores 256 of that lane's rows against the
// lane's query held in shared memory. At W = 2048 it moves 32 MiB and is
// bound by launch latency rather than bytes.
//
// The gather scan is the rows scan with one change: view row r of lane b is
// plane row ids[b, r / BR] * BR + r % BR, read in place (the Pallas kernel
// streams the same blocks through scalar prefetch). View rows at or past N
// score 0 and are never read, so a ragged plane is not padded. At the
// cluster path's shapes (B = 32 lanes x 8192 view rows, D = 512) it reads
// 64 MiB of plane rows and writes 1 MiB: about 20 us at 3.35 TB/s, bound by
// bytes (0.27 G int8 operations). Lanes that probe the same cluster read
// the same blocks, which may then come from L2. Each thread block owns a
// run of 256 view rows of one lane; consecutive threads read consecutive
// rows of a block and store consecutive scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // one row per thread
constexpr int kChunkWords = 16;   // 64 row bytes per register chunk
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // Hopper's opt-in shared memory per block

__device__ __forceinline__ int lo16(uint32_t w) {
  return static_cast<int>((w << 4) & 0xF0F0F0F0u);
}

__device__ __forceinline__ int hi16(uint32_t w) {
  return static_cast<int>(w & 0xF0F0F0F0u);
}

// Loads words [c, c + 16) of a row as pre-shifted nibble words. VEC: 16-byte
// loads (the row is 16-byte aligned); MASKED: words at or past `words` read
// as zero, which contributes nothing to the dot.
template <bool VEC, bool MASKED>
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ rowp,
                                           int c, int words,
                                           int (&lo)[kChunkWords],
                                           int (&hi)[kChunkWords]) {
  if constexpr (VEC && !MASKED) {
    const uint4* p = reinterpret_cast<const uint4*>(rowp + c);
#pragma unroll
    for (int v = 0; v < kChunkWords / 4; ++v) {
      const uint4 x = __ldg(p + v);
      lo[4 * v + 0] = lo16(x.x); hi[4 * v + 0] = hi16(x.x);
      lo[4 * v + 1] = lo16(x.y); hi[4 * v + 1] = hi16(x.y);
      lo[4 * v + 2] = lo16(x.z); hi[4 * v + 2] = hi16(x.z);
      lo[4 * v + 3] = lo16(x.w); hi[4 * v + 3] = hi16(x.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunkWords; ++i) {
      const uint32_t x = (!MASKED || c + i < words) ? __ldg(rowp + c + i) : 0u;
      lo[i] = lo16(x);
      hi[i] = hi16(x);
    }
  }
}

// acc[b] += 16 * (lane b's panel words [c, c + 16) . the loaded chunk).
template <int BT>
__device__ __forceinline__ void dot_chunk(const uint32_t* q_s, int words_pad,
                                          int c, const int (&lo)[kChunkWords],
                                          const int (&hi)[kChunkWords],
                                          int (&acc)[BT]) {
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    const uint4* qe = reinterpret_cast<const uint4*>(q_s + b * words_pad + c);
    const uint4* qo = reinterpret_cast<const uint4*>(
        q_s + (BT + b) * words_pad + c);
    int s = acc[b];
#pragma unroll
    for (int v = 0; v < kChunkWords / 4; ++v) {
      const uint4 e = qe[v];
      const uint4 o = qo[v];
      s = __dp4a(lo[4 * v + 0], static_cast<int>(e.x), s);
      s = __dp4a(lo[4 * v + 1], static_cast<int>(e.y), s);
      s = __dp4a(lo[4 * v + 2], static_cast<int>(e.z), s);
      s = __dp4a(lo[4 * v + 3], static_cast<int>(e.w), s);
      s = __dp4a(hi[4 * v + 0], static_cast<int>(o.x), s);
      s = __dp4a(hi[4 * v + 1], static_cast<int>(o.y), s);
      s = __dp4a(hi[4 * v + 2], static_cast<int>(o.z), s);
      s = __dp4a(hi[4 * v + 3], static_cast<int>(o.w), s);
    }
    acc[b] = s;
  }
}

// q_panel (2, B, D2) int8; plane (N, D2) uint8; out (B, N) int32.
// D2 % 4 == 0; VEC needs D2 % 16 == 0; TAIL when D2 % 64 != 0 (a last,
// partial chunk). BT query lanes per block (blockIdx.y walks lane tiles);
// each lane's panel is zero-padded in shared memory to words_pad, a
// multiple of 16 words.
template <int BT, bool VEC, bool TAIL>
__global__ void __launch_bounds__(kThreads)
plane_kernel(const int8_t* __restrict__ q_panel,
             const uint8_t* __restrict__ plane,
             int32_t* __restrict__ out, int B, long long N, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][BT][words_pad]
  const int words = D2 / 4;
  const int words_pad = (words + kChunkWords - 1) / kChunkWords * kChunkWords;
  const int b0 = blockIdx.y * BT;
  const uint32_t* qg = reinterpret_cast<const uint32_t*>(q_panel);
  for (int i = threadIdx.x; i < 2 * BT * words_pad; i += kThreads) {
    const int half = i / (BT * words_pad);
    const int b = (i / words_pad) % BT;
    const int w = i % words_pad;
    q_s[i] = (b0 + b < B && w < words)
        ? qg[(static_cast<size_t>(half) * B + b0 + b) * words + w] : 0u;
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  if (row >= N) return;

  int acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0;

  const uint32_t* rowp = reinterpret_cast<const uint32_t*>(
      plane + static_cast<size_t>(row) * D2);
  // The masked tail is compiled only into the TAIL instances: in the same
  // body as the whole-chunk loop it raised the 32-lane tile from 126 to 154
  // registers and slowed the D = 512 scan by a fifth on an H100.
  const int full = TAIL ? words / kChunkWords * kChunkWords : words;
  for (int c = 0; c < full; c += kChunkWords) {
    int lo[kChunkWords], hi[kChunkWords];
    load_chunk<VEC, false>(rowp, c, words, lo, hi);
    dot_chunk<BT>(q_s, words_pad, c, lo, hi, acc);
  }
  if constexpr (TAIL) {
    int lo[kChunkWords], hi[kChunkWords];
    load_chunk<VEC, true>(rowp, full, words, lo, hi);
    dot_chunk<BT>(q_s, words_pad, full, lo, hi, acc);
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      out[static_cast<size_t>(b0 + b) * N + row] = acc[b] >> 4;
    }
  }
}

// 16 * (one packed row . the lane's [even; odd] panel in shared memory).
// q_s: [2][words]; VEC needs words % 4 == 0 and a 16-byte aligned row.
template <bool VEC>
__device__ __forceinline__ int row_dot(const uint8_t* __restrict__ row,
                                       const uint32_t* q_s, int words) {
  int s = 0;
  if constexpr (VEC) {
    const uint4* rowp = reinterpret_cast<const uint4*>(row);
    const uint4* qe = reinterpret_cast<const uint4*>(q_s);
    const uint4* qo = reinterpret_cast<const uint4*>(q_s + words);
    for (int v = 0; v < words / 4; ++v) {
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
    for (int w = 0; w < words; ++w) {
      const uint32_t x = __ldg(rowp + w);
      s = __dp4a(lo16(x), static_cast<int>(q_s[w]), s);
      s = __dp4a(hi16(x), static_cast<int>(q_s[words + w]), s);
    }
  }
  return s;
}

// Copies lane b's [even; odd] panel (2 * D2 bytes of q_eo) to shared memory.
__device__ __forceinline__ void load_lane_panel(const int8_t* __restrict__ q_eo,
                                                uint32_t* q_s, int b,
                                                int words) {
  const uint32_t* qg = reinterpret_cast<const uint32_t*>(
      q_eo + static_cast<size_t>(b) * 8 * words);
  for (int i = threadIdx.x; i < 2 * words; i += kThreads) q_s[i] = qg[i];
  __syncthreads();
}

// q_eo (B, 2, D2) int8; rows (B, W, D2) uint8; out (B, W) int32.
// D2 % 4 == 0 (VEC: D2 % 16 == 0); blockIdx.y is the lane.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int8_t* __restrict__ q_eo,
            const uint8_t* __restrict__ rows,
            int32_t* __restrict__ out, long long W, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][D2/4]
  const int b = blockIdx.y;
  load_lane_panel(q_eo, q_s, b, D2 / 4);
  const long long r = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (r >= W) return;
  const int s = row_dot<VEC>(rows + (static_cast<size_t>(b) * W + r) * D2,
                             q_s, D2 / 4);
  out[static_cast<size_t>(b) * W + r] = s >> 4;
}

// q_eo (B, 2, D2) int8; plane (N, D2) uint8; ids (B, J) int32 block ids;
// out (B, J * BR) int32. View rows at or past N (or before 0) score 0.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int8_t* __restrict__ q_eo,
              const uint8_t* __restrict__ plane,
              const int32_t* __restrict__ ids,
              int32_t* __restrict__ out, long long N, int J, int BR, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][D2/4]
  const int b = blockIdx.y;
  load_lane_panel(q_eo, q_s, b, D2 / 4);
  const long long R = static_cast<long long>(J) * BR;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (r >= R) return;
  const long long id = ids[static_cast<size_t>(b) * J + r / BR];
  const long long row = id * BR + r % BR;
  int s = 0;
  if (row >= 0 && row < N) {
    s = row_dot<VEC>(plane + static_cast<size_t>(row) * D2, q_s, D2 / 4);
  }
  out[static_cast<size_t>(b) * R + r] = s >> 4;
}

// Opts a kernel into more than the default 48 KiB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int BT, bool VEC, bool TAIL>
cudaError_t launch_plane(const int8_t* q, const uint8_t* plane, int32_t* out,
                         int B, long long N, int D2, cudaStream_t stream) {
  const int words_pad = (D2 / 4 + kChunkWords - 1) / kChunkWords * kChunkWords;
  const size_t smem = static_cast<size_t>(2) * BT * words_pad * 4;
  cudaError_t err = allow_smem(plane_kernel<BT, VEC, TAIL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                  static_cast<unsigned>((B + BT - 1) / BT));
  plane_kernel<BT, VEC, TAIL><<<grid, kThreads, smem, stream>>>(
      q, plane, out, B, N, D2);
  return cudaGetLastError();
}

template <bool VEC, bool TAIL>
cudaError_t launch_plane_tile(int bt, const int8_t* q, const uint8_t* p,
                              int32_t* o, int B, long long N, int D2,
                              cudaStream_t s) {
  switch (bt) {
    case 1: return launch_plane<1, VEC, TAIL>(q, p, o, B, N, D2, s);
    case 2: return launch_plane<2, VEC, TAIL>(q, p, o, B, N, D2, s);
    case 4: return launch_plane<4, VEC, TAIL>(q, p, o, B, N, D2, s);
    case 8: return launch_plane<8, VEC, TAIL>(q, p, o, B, N, D2, s);
    case 16: return launch_plane<16, VEC, TAIL>(q, p, o, B, N, D2, s);
    default: return launch_plane<32, VEC, TAIL>(q, p, o, B, N, D2, s);
  }
}

}  // namespace

extern "C" int stage1_plane_launch(const void* q_panel, const void* plane,
                                   void* out, int B, long long N, int D2,
                                   void* stream) {
  if (D2 % 4) return static_cast<int>(cudaErrorInvalidValue);
  // The smallest power-of-two lane tile that covers B (at most 32), halved
  // while its panels exceed the shared memory one block may hold.
  int bt = 1;
  while (bt < B && bt < 32) bt *= 2;
  const long long words_pad =
      (D2 / 4 + kChunkWords - 1) / kChunkWords * kChunkWords;
  while (bt > 1 && 2LL * bt * words_pad * 4 > kMaxSmem) bt /= 2;
  const auto* q = static_cast<const int8_t*>(q_panel);
  const auto* p = static_cast<const uint8_t*>(plane);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D2 % 64 == 0) {
    err = launch_plane_tile<true, false>(bt, q, p, o, B, N, D2, s);
  } else if (D2 % 16 == 0) {
    err = launch_plane_tile<true, true>(bt, q, p, o, B, N, D2, s);
  } else {
    err = launch_plane_tile<false, true>(bt, q, p, o, B, N, D2, s);
  }
  return static_cast<int>(err);
}

extern "C" int stage1_rows_launch(const void* q_eo, const void* rows,
                                  void* out, int B, long long W, int D2,
                                  void* stream) {
  if (D2 % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>(2) * D2;
  const auto* q = static_cast<const int8_t*>(q_eo);
  const auto* r = static_cast<const uint8_t*>(rows);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D2 % 16 == 0) {
    err = allow_smem(rows_kernel<true>, smem);
    if (err == cudaSuccess) {
      rows_kernel<true><<<grid, kThreads, smem, s>>>(q, r, o, W, D2);
    }
  } else {
    err = allow_smem(rows_kernel<false>, smem);
    if (err == cudaSuccess) {
      rows_kernel<false><<<grid, kThreads, smem, s>>>(q, r, o, W, D2);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stage1_gather_launch(const void* q_eo, const void* plane,
                                    const void* block_ids, void* out, int B,
                                    long long N, int J, int BR, int D2,
                                    void* stream) {
  if (D2 % 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(J) * BR;
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>(2) * D2;
  const auto* q = static_cast<const int8_t*>(q_eo);
  const auto* p = static_cast<const uint8_t*>(plane);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D2 % 16 == 0) {
    err = allow_smem(gather_kernel<true>, smem);
    if (err == cudaSuccess) {
      gather_kernel<true><<<grid, kThreads, smem, s>>>(q, p, ids, o, N, J, BR,
                                                       D2);
    }
  } else {
    err = allow_smem(gather_kernel<false>, smem);
    if (err == cudaSuccess) {
      gather_kernel<false><<<grid, kThreads, smem, s>>>(q, p, ids, o, N, J,
                                                        BR, D2);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
