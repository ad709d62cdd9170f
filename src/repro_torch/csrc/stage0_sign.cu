// Stage-0 sign-agreement scan over gathered blocks of the packed sign plane
// on Hopper: the cluster cascade's 1-bit prescreen.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stage0_sign.py  stage0_sign_gather_pallas
//
// The reference scores  sum_k q_sign[k] * (1 - 2 * bit_k)  with the query's
// dense +-1 signs and the row's sign bits (bit k % 8 of byte k / 8 set when
// dim k is negative). With the query packed the same way (bit set where
// q_sign < 0) every dim adds +1 where the two bits agree and -1 where they
// differ, so the score is  D - 2 * popc(qbits ^ dbits)  exactly, for a
// query of +-1 signs. Each block packs its lane's D signs into D/32 words of
// shared memory once. View row r of lane b is sign-plane row
// ids[b, r / BR] * BR + r % BR; a row at or past N is all-zero bytes in the
// reference (rows read as +1), which scores D - 2 * popc(qbits) = sum_k
// q_sign[k], computed here without a read.
//
// Widths: every D with D % 8 == 0. Rows are read 16 bytes at a time when
// D % 128 == 0, in 32-bit words when D % 32 == 0, and byte by byte
// otherwise (D/8 bytes do not then fill whole words, so rows are not
// word-aligned); the partial last word is zero in both operands.
//
// What bounds it on an H100 at the cluster path's shapes (B = 32 lanes x
// 8192 view rows, D = 512): it reads 16 MiB of sign rows and writes 1 MiB
// of scores, about 5 us at 3.35 TB/s; the XOR + popcount work is a few
// instructions per 16 bytes. Bytes bound it. Design: one thread per view
// row, a block owning 256 consecutive view rows of one lane (grid.y walks
// lanes), so consecutive threads read consecutive 64-byte rows of a block
// and store consecutive scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one view row per thread
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // Hopper's opt-in shared memory per block

// VEC: bytes per load (16, 4 or 1). nw = ceil(D / 32) query words.
template <int VEC>
__device__ __forceinline__ int row_popc(const uint8_t* __restrict__ row,
                                        const uint32_t* qbits, int nw,
                                        int D8) {
  int pop = 0;
  if constexpr (VEC == 16) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    for (int v = 0; v < nw / 4; ++v) {
      const uint4 x = __ldg(p + v);
      pop += __popc(x.x ^ qbits[4 * v + 0]) + __popc(x.y ^ qbits[4 * v + 1])
           + __popc(x.z ^ qbits[4 * v + 2]) + __popc(x.w ^ qbits[4 * v + 3]);
    }
  } else if constexpr (VEC == 4) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row);
    for (int w = 0; w < nw; ++w) pop += __popc(__ldg(p + w) ^ qbits[w]);
  } else {
    for (int w = 0; w < nw; ++w) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * w + i < D8) {
          x |= static_cast<uint32_t>(__ldg(row + 4 * w + i)) << (8 * i);
        }
      }
      pop += __popc(x ^ qbits[w]);
    }
  }
  return pop;
}

// q_sign (B, D) int8 +-1; plane (N, D/8) uint8; ids (B, J) int32 block ids;
// out (B, J * BR) int32.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
sign_gather_kernel(const int8_t* __restrict__ q_sign,
                   const uint8_t* __restrict__ plane,
                   const int32_t* __restrict__ ids,
                   int32_t* __restrict__ out, long long N, int J, int BR,
                   int D) {
  extern __shared__ uint32_t qbits[];  // [ceil(D / 32)]
  const int nw = (D + 31) / 32;
  const int D8 = D / 8;
  const int b = blockIdx.y;
  const int8_t* qg = q_sign + static_cast<size_t>(b) * D;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    uint32_t bits = 0;
    for (int i = 0; i < 32 && 32 * w + i < D; ++i) {
      bits |= static_cast<uint32_t>(qg[32 * w + i] < 0) << i;
    }
    qbits[w] = bits;
  }
  __syncthreads();

  const long long R = static_cast<long long>(J) * BR;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (r >= R) return;
  const long long id = ids[static_cast<size_t>(b) * J + r / BR];
  const long long row = id * BR + r % BR;
  int pop = 0;
  if (row >= 0 && row < N) {
    pop = row_popc<VEC>(plane + static_cast<size_t>(row) * D8, qbits, nw, D8);
  } else {
    for (int w = 0; w < nw; ++w) pop += __popc(qbits[w]);
  }
  out[static_cast<size_t>(b) * R + r] = D - 2 * pop;
}

template <int VEC>
cudaError_t launch(const int8_t* q, const uint8_t* p, const int32_t* ids,
                   int32_t* o, int B, long long N, int J, int BR, int D,
                   cudaStream_t stream) {
  const long long R = static_cast<long long>(J) * BR;
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>((D + 31) / 32) * 4;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        sign_gather_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sign_gather_kernel<VEC><<<grid, kThreads, smem, stream>>>(q, p, ids, o, N,
                                                            J, BR, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stage0_sign_gather_launch(const void* q_sign,
                                         const void* sign_plane,
                                         const void* block_ids, void* out,
                                         int B, long long N, int J, int BR,
                                         int D, void* stream) {
  if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const int8_t*>(q_sign);
  const auto* p = static_cast<const uint8_t*>(sign_plane);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D % 128 == 0) err = launch<16>(q, p, ids, o, B, N, J, BR, D, s);
  else if (D % 32 == 0) err = launch<4>(q, p, ids, o, B, N, J, BR, D, s);
  else err = launch<1>(q, p, ids, o, B, N, J, BR, D, s);
  return static_cast<int>(err);
}
