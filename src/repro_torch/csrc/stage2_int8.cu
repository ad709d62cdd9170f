// Stage-2 exact INT8 rescore of gathered candidates on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/stage2_int8.py  stage2_int8_batched_pallas
//   and, at B = 1, stage2_int8_pallas (the single-query form)
//
// out[b, c] = sum_d q[b, d] * v[b, c, d], where each INT8 value v is rebuilt
// from its packed MSB and LSB nibble planes. No nibble is unpacked: the
// original byte is (msb_nibble << 4) | lsb_nibble, so for plane words m and
// l the even-dim word is ((m & 0x0F0F0F0F) << 4) | (l & 0x0F0F0F0F) and the
// odd-dim word is (m & 0xF0F0F0F0) | ((l >> 4) & 0x0F0F0F0F); each goes
// through __dp4a with the query's even or odd int8 word. Every even D is
// served: rows of D/2 bytes are read in 32-bit words when D/2 % 4 == 0 and
// byte by byte otherwise (the bytes of the last word past D/2 read as
// zero in every operand); the warp's strided word loop masks the last
// partial round itself.
//
// What bounds it on an H100 at B = 32, C = 50, D = 512: it reads
// 2 * B * C * D/2 = 800 KiB of gathered rows, under a microsecond of
// memory time, so it is bound by launch latency. Design: one warp per
// (lane, candidate) row; the 32 threads read consecutive 4-byte words of
// both planes (coalesced 128-byte requests), dp4a them against the lane's
// query words and reduce with warp shuffles. The gathered-rows interface of
// the reference is kept: a kernel that gathers candidate rows by id, and so
// skips the (B, C, D/2) copies, is later work.

#include "nibble.cuh"

namespace {

constexpr int kThreads = 256;  // 8 rows (warps) per block

// q_eo8 (B, 2, D2) int8; msb/lsb (B, C, D2) uint8; out (B, C) int32.
// MODE kWord (D2 % 4 == 0) or kByte (any D2).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
exact_kernel(const int8_t* __restrict__ q_eo8,
             const uint8_t* __restrict__ msb,
             const uint8_t* __restrict__ lsb,
             int32_t* __restrict__ out, long long rows, int C, int D2) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long b = row / C;
  const int words = (D2 + 3) / 4;
  const uint8_t* mrow = msb + static_cast<size_t>(row) * D2;
  const uint8_t* lrow = lsb + static_cast<size_t>(row) * D2;
  const uint8_t* qrow = reinterpret_cast<const uint8_t*>(q_eo8)
                        + static_cast<size_t>(b) * 2 * D2;
  const uint32_t* m = reinterpret_cast<const uint32_t*>(mrow);
  const uint32_t* l = reinterpret_cast<const uint32_t*>(lrow);
  const uint32_t* qe = reinterpret_cast<const uint32_t*>(qrow);
  const uint32_t* qo = qe + words;
  int s = 0;
  for (int w = lane; w < words; w += 32) {
    uint32_t mw, lw, ew, ow;
    if constexpr (MODE == kByte) {
      mw = byte_word(mrow, w, D2);
      lw = byte_word(lrow, w, D2);
      ew = byte_word(qrow, w, D2);
      ow = byte_word(qrow + D2, w, D2);
    } else {
      mw = __ldg(m + w);
      lw = __ldg(l + w);
      ew = __ldg(qe + w);
      ow = __ldg(qo + w);
    }
    const uint32_t even = ((mw & 0x0F0F0F0Fu) << 4) | (lw & 0x0F0F0F0Fu);
    const uint32_t odd = (mw & 0xF0F0F0F0u) | ((lw >> 4) & 0x0F0F0F0Fu);
    s = __dp4a(static_cast<int>(even), static_cast<int>(ew), s);
    s = __dp4a(static_cast<int>(odd), static_cast<int>(ow), s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

}  // namespace

extern "C" int stage2_exact_launch(const void* q_eo8, const void* msb,
                                   const void* lsb, void* out, int B, int C,
                                   int D2, void* stream) {
  const long long rows = static_cast<long long>(B) * C;
  const long long warps_per_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>(
      (rows + warps_per_block - 1) / warps_per_block);
  const auto* q = static_cast<const int8_t*>(q_eo8);
  const auto* m = static_cast<const uint8_t*>(msb);
  const auto* l = static_cast<const uint8_t*>(lsb);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (D2 % 4 == 0) {
    exact_kernel<kWord><<<blocks, kThreads, 0, s>>>(q, m, l, o, rows, C, D2);
  } else {
    exact_kernel<kByte><<<blocks, kThreads, 0, s>>>(q, m, l, o, rows, C, D2);
  }
  return static_cast<int>(cudaGetLastError());
}
