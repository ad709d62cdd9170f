// Stage-1 MSB-nibble (INT4) scoring on Hopper: the shared-plane scan and
// the per-lane rows scan.
//
// Replaces two Pallas TPU kernels of the reference package:
//   plane: src/repro/kernels/stage1_int4.py  stage1_int4_batched_pallas
//   rows:  src/repro/kernels/stage1_int4.py  stage1_int4_rows_pallas
//
// Both compute  score = sum_j q_even[j] * sext4(lo(byte j))
//                     + q_odd[j]  * sext4(hi(byte j))
// over packed MSB-nibble rows (byte j: dim 2j in the low nibble, dim 2j+1 in
// the high nibble, raw two's complement). No nibble is unpacked: for a plane
// word w, (w << 4) & 0xF0F0F0F0 holds 16 * sext4(lo) in each signed byte and
// w & 0xF0F0F0F0 holds 16 * sext4(hi), so __dp4a against the query's even
// and odd nibble words sums 16 * score, and an arithmetic shift right by 4
// is exact.
//
// What bounds the plane scan on an H100 at N = 2^20, D = 512, B = 32: it
// reads the 256 MiB plane once and writes the (B, N) int32 scores
// (128 MiB), about 120 us at 3.35 TB/s; its 2*B*N*D = 34 G int8 operations
// would take 17 us on the int8 tensor cores. On dp4a (4 MACs per
// instruction, integer pipe) it is compute-bound above the byte bound.
// Design: a block of 256 threads owns 256 consecutive plane rows (one per
// thread) and a tile of up to 32 query lanes, whose even/odd nibble panel
// sits in shared memory and is read by broadcast. Each thread turns 64 bytes
// of its row at a time into 32 pre-shifted words held in registers and
// reuses them for every lane of the tile, so the row is read from device
// memory once per tile of 32 lanes and the (B, N) stores are coalesced
// across the warp (consecutive rows). The kernel masks its own ragged row
// edge: the plane is never padded or copied. wgmma s8 is later work.
//
// The rows scan is the same arithmetic over per-lane row blocks (B, W, D/2):
// grid.y walks lanes, a block scores 256 of that lane's rows against the
// lane's query held in shared memory. At W = 2048 it moves 32 MiB and is
// bound by launch latency rather than bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // one row per thread
constexpr int kChunkWords = 16;   // 64 row bytes per register chunk

__device__ __forceinline__ int lo16(uint32_t w) {
  return static_cast<int>((w << 4) & 0xF0F0F0F0u);
}

__device__ __forceinline__ int hi16(uint32_t w) {
  return static_cast<int>(w & 0xF0F0F0F0u);
}

// q_panel (2, B, D2) int8; plane (N, D2) uint8; out (B, N) int32.
// D2 % 64 == 0; BT query lanes per block (blockIdx.y walks lane tiles).
template <int BT>
__global__ void __launch_bounds__(kThreads)
plane_kernel(const int8_t* __restrict__ q_panel,
             const uint8_t* __restrict__ plane,
             int32_t* __restrict__ out, int B, long long N, int D2) {
  extern __shared__ uint4 q_smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(q_smem);  // [2][BT][D2/4]
  const int words = D2 / 4;
  const int b0 = blockIdx.y * BT;
  const uint32_t* qg = reinterpret_cast<const uint32_t*>(q_panel);
  for (int i = threadIdx.x; i < 2 * BT * words; i += kThreads) {
    const int half = i / (BT * words);
    const int b = (i / words) % BT;
    const int w = i % words;
    q_s[i] = (b0 + b < B)
        ? qg[(static_cast<size_t>(half) * B + b0 + b) * words + w] : 0u;
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  if (row >= N) return;

  int acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0;

  const uint4* rowp = reinterpret_cast<const uint4*>(
      plane + static_cast<size_t>(row) * D2);
  for (int c = 0; c < words; c += kChunkWords) {
    int lo[kChunkWords], hi[kChunkWords];
#pragma unroll
    for (int v = 0; v < kChunkWords / 4; ++v) {
      const uint4 x = __ldg(rowp + c / 4 + v);
      lo[4 * v + 0] = lo16(x.x); hi[4 * v + 0] = hi16(x.x);
      lo[4 * v + 1] = lo16(x.y); hi[4 * v + 1] = hi16(x.y);
      lo[4 * v + 2] = lo16(x.z); hi[4 * v + 2] = hi16(x.z);
      lo[4 * v + 3] = lo16(x.w); hi[4 * v + 3] = hi16(x.w);
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const uint4* qe = reinterpret_cast<const uint4*>(q_s + b * words + c);
      const uint4* qo = reinterpret_cast<const uint4*>(
          q_s + (BT + b) * words + c);
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
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      out[static_cast<size_t>(b0 + b) * N + row] = acc[b] >> 4;
    }
  }
}

// q_eo (B, 2, D2) int8; rows (B, W, D2) uint8; out (B, W) int32.
// D2 % 16 == 0; blockIdx.y is the lane.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int8_t* __restrict__ q_eo,
            const uint8_t* __restrict__ rows,
            int32_t* __restrict__ out, long long W, int D2) {
  extern __shared__ uint4 q_s[];  // [2][D2/16]: even panel, then odd
  const int vecs = D2 / 16;
  const int b = blockIdx.y;
  const uint4* qg = reinterpret_cast<const uint4*>(
      q_eo + static_cast<size_t>(b) * 2 * D2);
  for (int i = threadIdx.x; i < 2 * vecs; i += kThreads) q_s[i] = qg[i];
  __syncthreads();

  const long long r = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (r >= W) return;
  const uint4* rowp = reinterpret_cast<const uint4*>(
      rows + (static_cast<size_t>(b) * W + r) * D2);
  int s = 0;
  for (int v = 0; v < vecs; ++v) {
    const uint4 x = __ldg(rowp + v);
    const uint4 e = q_s[v];
    const uint4 o = q_s[vecs + v];
    s = __dp4a(lo16(x.x), static_cast<int>(e.x), s);
    s = __dp4a(lo16(x.y), static_cast<int>(e.y), s);
    s = __dp4a(lo16(x.z), static_cast<int>(e.z), s);
    s = __dp4a(lo16(x.w), static_cast<int>(e.w), s);
    s = __dp4a(hi16(x.x), static_cast<int>(o.x), s);
    s = __dp4a(hi16(x.y), static_cast<int>(o.y), s);
    s = __dp4a(hi16(x.z), static_cast<int>(o.z), s);
    s = __dp4a(hi16(x.w), static_cast<int>(o.w), s);
  }
  out[static_cast<size_t>(b) * W + r] = s >> 4;
}

template <int BT>
cudaError_t launch_plane(const int8_t* q, const uint8_t* plane, int32_t* out,
                         int B, long long N, int D2, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                  static_cast<unsigned>((B + BT - 1) / BT));
  const size_t smem = static_cast<size_t>(2) * BT * D2;
  plane_kernel<BT><<<grid, kThreads, smem, stream>>>(q, plane, out, B, N, D2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stage1_plane_launch(const void* q_panel, const void* plane,
                                   void* out, int B, long long N, int D2,
                                   void* stream) {
  const auto* q = static_cast<const int8_t*>(q_panel);
  const auto* p = static_cast<const uint8_t*>(plane);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (B <= 1) err = launch_plane<1>(q, p, o, B, N, D2, s);
  else if (B <= 2) err = launch_plane<2>(q, p, o, B, N, D2, s);
  else if (B <= 4) err = launch_plane<4>(q, p, o, B, N, D2, s);
  else if (B <= 8) err = launch_plane<8>(q, p, o, B, N, D2, s);
  else if (B <= 16) err = launch_plane<16>(q, p, o, B, N, D2, s);
  else err = launch_plane<32>(q, p, o, B, N, D2, s);
  return static_cast<int>(err);
}

extern "C" int stage1_rows_launch(const void* q_eo, const void* rows,
                                  void* out, int B, long long W, int D2,
                                  void* stream) {
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>(2) * D2;
  rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_eo), static_cast<const uint8_t*>(rows),
      static_cast<int32_t*>(out), W, D2);
  return static_cast<int>(cudaGetLastError());
}
