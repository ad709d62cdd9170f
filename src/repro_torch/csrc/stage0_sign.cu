// Stage-0 sign-agreement scans over the packed sign plane on Hopper: the
// dense scan of the whole plane and the cluster cascade's 1-bit prescreen
// over gathered blocks.
//
// Replaces the Pallas TPU kernels
//   plane:  src/repro/kernels/stage0_sign.py  stage0_sign_batched_pallas
//   gather: src/repro/kernels/stage0_sign.py  stage0_sign_gather_pallas
//
// The reference scores  sum_k q_sign[k] * (1 - 2 * bit_k)  with the query's
// dense +-1 signs and the row's sign bits (bit k % 8 of byte k / 8 set when
// dim k is negative). With the query packed the same way (bit set where
// q_sign < 0) every dim adds +1 where the two bits agree and -1 where they
// differ, so the score is  D - 2 * popc(qbits ^ dbits)  exactly, for a
// query of +-1 signs. Each block packs its lanes' D signs into D/32 words
// of shared memory once.
//
// Widths: every D with D % 8 == 0. Rows are read 16 bytes at a time when
// D % 128 == 0, in 32-bit words when D % 32 == 0, and byte by byte
// otherwise (D/8 bytes do not then fill whole words, so rows are not
// word-aligned); the partial last word is zero in both operands.
//
// The dense scan (sign_plane_kernel): each thread owns one sign row, reads its
// D/8 bytes once and scores it against a tile of up to BT = 32 lanes whose
// packed bits sit in shared memory (read by broadcast), so the plane
// streams once per batch, as the TPU kernel streams it. Rows per block
// (ROWS: 128, 256, 512 or 1024) is the autotuner's knob for the
// "stage0_sign" family; 256 is the default. At N = 2^20, D = 512, B = 32 it
// reads 64 MiB and writes the (B, N) int32 scores (128 MiB), about 60 us
// at 3.35 TB/s; its B * N * D / 32 = 537 M XOR + popcount pairs run on the
// integer pipe, where popcount issues at a quarter of the add rate, so
// the popcounts may bound it above the byte bound.
//
// The gather (sign_gather_kernel): view row r of lane b is sign-plane row
// ids[b / G, r / BR] * BR + r % BR (G lanes share a table row); a row at
// or past N is all-zero bytes in the reference (rows read as +1), which
// scores D - 2 * popc(qbits) = sum_k q_sign[k], computed here without a
// read. At the cluster path's shapes
// (B = 32 lanes x 8192 view rows, D = 512) it reads 16 MiB of sign rows
// and writes 1 MiB of scores, about 5 us at 3.35 TB/s; the XOR + popcount
// work is a few instructions per 16 bytes. There bytes bound it (5.58 us
// device-only against a 4.65 us bound on an H100, PERF.md); at the decode
// prescreen's 8-byte rows it takes 5.4 us against 0.71 us: its 1792
// blocks each repeat the sign packing, and every row waits on its block
// id. Design: one thread per view row, a block owning 256 consecutive
// view rows of one lane (grid.y walks lanes; ids row b / G), so
// consecutive threads read consecutive rows of a block and store
// consecutive scores. The bulk-copy gather of stage0_sign_gather.cu
// takes the decode widths (rows of 4-16 bytes); this kernel keeps every
// other shape, D = 512 included, where it was as fast or faster.

#include "nibble.cuh"   // byte_word, allow_smem, kMaxSmem

namespace {

constexpr int kThreads = 256;  // the gather's view rows per block

// Word w of a lane's packed signs: bit i set where q_sign[32 w + i] < 0
// (zero past D).
__device__ __forceinline__ uint32_t pack_sign_word(
    const int8_t* __restrict__ q, int w, int D) {
  uint32_t bits = 0;
  for (int i = 0; i < 32 && 32 * w + i < D; ++i) {
    bits |= static_cast<uint32_t>(q[32 * w + i] < 0) << i;
  }
  return bits;
}

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
      pop += __popc(byte_word(row, w, D8) ^ qbits[w]);
    }
  }
  return pop;
}

// q_sign (B, D) int8 +-1; plane (N, D/8) uint8; out (B, N) int32. BT
// lanes per block (blockIdx.y walks lane tiles), their packed signs at
// qbits[b * nw]; VEC as in row_popc (16 needs nw % 4 == 0).
template <int BT, int ROWS, int VEC>
__global__ void __launch_bounds__(ROWS)
sign_plane_kernel(const int8_t* __restrict__ q_sign,
                  const uint8_t* __restrict__ plane,
                  int32_t* __restrict__ out, int B, long long N, int D) {
  extern __shared__ uint4 q_smem[];
  uint32_t* qbits = reinterpret_cast<uint32_t*>(q_smem);  // [BT][nw]
  const int nw = (D + 31) / 32;
  const int D8 = D / 8;
  const int b0 = blockIdx.y * BT;
  for (int i = threadIdx.x; i < BT * nw; i += ROWS) {
    const int b = i / nw;
    qbits[i] = b0 + b < B
        ? pack_sign_word(q_sign + static_cast<size_t>(b0 + b) * D, i % nw, D)
        : 0u;
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * ROWS
                        + threadIdx.x;
  if (row >= N) return;
  int pop[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) pop[b] = 0;
  const uint8_t* rowp = plane + static_cast<size_t>(row) * D8;
  if constexpr (VEC == 16) {
    const uint4* p = reinterpret_cast<const uint4*>(rowp);
    for (int v = 0; v < nw / 4; ++v) {
      const uint4 x = __ldg(p + v);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const uint4 q = reinterpret_cast<const uint4*>(qbits + b * nw)[v];
        pop[b] += __popc(x.x ^ q.x) + __popc(x.y ^ q.y)
                + __popc(x.z ^ q.z) + __popc(x.w ^ q.w);
      }
    }
  } else {
    for (int w = 0; w < nw; ++w) {
      const uint32_t x = VEC == 4
          ? __ldg(reinterpret_cast<const uint32_t*>(rowp) + w)
          : byte_word(rowp, w, D8);
#pragma unroll
      for (int b = 0; b < BT; ++b) pop[b] += __popc(x ^ qbits[b * nw + w]);
    }
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      out[static_cast<size_t>(b0 + b) * N + row] = D - 2 * pop[b];
    }
  }
}

// q_sign (B, D) int8 +-1; plane (N, D/8) uint8; ids (B / G, J) int32 block
// ids, row b / G serving lane b; out (B, J * BR) int32.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
sign_gather_kernel(const int8_t* __restrict__ q_sign,
                   const uint8_t* __restrict__ plane,
                   const int32_t* __restrict__ ids,
                   int32_t* __restrict__ out, long long N, int J, int BR,
                   int D, int G) {
  extern __shared__ uint32_t qbits[];  // [ceil(D / 32)]
  const int nw = (D + 31) / 32;
  const int D8 = D / 8;
  const int b = blockIdx.y;
  const int8_t* qg = q_sign + static_cast<size_t>(b) * D;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    qbits[w] = pack_sign_word(qg, w, D);
  }
  __syncthreads();

  const long long R = static_cast<long long>(J) * BR;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (r >= R) return;
  const long long id = ids[static_cast<size_t>(b / G) * J + r / BR];
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
cudaError_t launch_gather(const int8_t* q, const uint8_t* p,
                          const int32_t* ids, int32_t* o, int B, long long N,
                          int J, int BR, int D, int G, cudaStream_t stream) {
  const long long R = static_cast<long long>(J) * BR;
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>((D + 31) / 32) * 4;
  const cudaError_t err = allow_smem(sign_gather_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  sign_gather_kernel<VEC><<<grid, kThreads, smem, stream>>>(q, p, ids, o, N,
                                                            J, BR, D, G);
  return cudaGetLastError();
}

template <int BT, int ROWS, int VEC>
cudaError_t launch_plane(const int8_t* q, const uint8_t* p, int32_t* o,
                         int B, long long N, int D, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + ROWS - 1) / ROWS),
                  static_cast<unsigned>((B + BT - 1) / BT));
  const size_t smem = static_cast<size_t>(BT) * ((D + 31) / 32) * 4;
  const cudaError_t err = allow_smem(sign_plane_kernel<BT, ROWS, VEC>, smem);
  if (err != cudaSuccess) return err;
  sign_plane_kernel<BT, ROWS, VEC><<<grid, ROWS, smem, stream>>>(q, p, o, B,
                                                                  N, D);
  return cudaGetLastError();
}

template <int ROWS, int VEC>
cudaError_t launch_plane_tile(int bt, const int8_t* q, const uint8_t* p,
                              int32_t* o, int B, long long N, int D,
                              cudaStream_t s) {
  switch (bt) {
    case 1: return launch_plane<1, ROWS, VEC>(q, p, o, B, N, D, s);
    case 2: return launch_plane<2, ROWS, VEC>(q, p, o, B, N, D, s);
    case 4: return launch_plane<4, ROWS, VEC>(q, p, o, B, N, D, s);
    case 8: return launch_plane<8, ROWS, VEC>(q, p, o, B, N, D, s);
    case 16: return launch_plane<16, ROWS, VEC>(q, p, o, B, N, D, s);
    default: return launch_plane<32, ROWS, VEC>(q, p, o, B, N, D, s);
  }
}

template <int ROWS>
cudaError_t launch_plane_rows(int bt, const int8_t* q, const uint8_t* p,
                              int32_t* o, int B, long long N, int D,
                              cudaStream_t s) {
  if (D % 128 == 0) {
    return launch_plane_tile<ROWS, 16>(bt, q, p, o, B, N, D, s);
  }
  if (D % 32 == 0) return launch_plane_tile<ROWS, 4>(bt, q, p, o, B, N, D, s);
  return launch_plane_tile<ROWS, 1>(bt, q, p, o, B, N, D, s);
}

}  // namespace

// ids (B / G, J): G consecutive lanes share each table row.
extern "C" int stage0_sign_gather_launch(const void* q_sign,
                                         const void* sign_plane,
                                         const void* block_ids, void* out,
                                         int B, long long N, int J, int BR,
                                         int D, int G, void* stream) {
  if (D % 8 || G <= 0 || B % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* q = static_cast<const int8_t*>(q_sign);
  const auto* p = static_cast<const uint8_t*>(sign_plane);
  const auto* ids = static_cast<const int32_t*>(block_ids);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D % 128 == 0) {
    err = launch_gather<16>(q, p, ids, o, B, N, J, BR, D, G, s);
  } else if (D % 32 == 0) {
    err = launch_gather<4>(q, p, ids, o, B, N, J, BR, D, G, s);
  } else {
    err = launch_gather<1>(q, p, ids, o, B, N, J, BR, D, G, s);
  }
  return static_cast<int>(err);
}

// rows: threads (sign rows) per block, one of 128, 256, 512, 1024.
extern "C" int stage0_sign_plane_launch(const void* q_sign,
                                        const void* sign_plane, void* out,
                                        int B, long long N, int D, int rows,
                                        void* stream) {
  if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
  // The smallest power-of-two lane tile that covers B (at most 32), halved
  // while its packed signs exceed the shared memory one block may hold.
  int bt = 1;
  while (bt < B && bt < 32) bt *= 2;
  const long long nw = (D + 31) / 32;
  while (bt > 1 && bt * nw * 4 > kMaxSmem) bt /= 2;
  const auto* q = static_cast<const int8_t*>(q_sign);
  const auto* p = static_cast<const uint8_t*>(sign_plane);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows) {
    case 128: err = launch_plane_rows<128>(bt, q, p, o, B, N, D, s); break;
    case 256: err = launch_plane_rows<256>(bt, q, p, o, B, N, D, s); break;
    case 512: err = launch_plane_rows<512>(bt, q, p, o, B, N, D, s); break;
    case 1024: err = launch_plane_rows<1024>(bt, q, p, o, B, N, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
