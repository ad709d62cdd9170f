// Stage-2 exact INT8 rescore of gathered candidates on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stage2_int8.py  stage2_int8_batched_pallas
//
// out[b, c] = sum_d q[b, d] * v[b, c, d], where each INT8 value v is rebuilt
// from its packed MSB and LSB nibble planes. No nibble is unpacked: the
// original byte is (msb_nibble << 4) | lsb_nibble, so for plane words m and
// l the even-dim word is ((m & 0x0F0F0F0F) << 4) | (l & 0x0F0F0F0F) and the
// odd-dim word is (m & 0xF0F0F0F0) | ((l >> 4) & 0x0F0F0F0F); each goes
// through __dp4a with the query's even or odd int8 word. Every D with
// D % 8 == 0 is served (D/2 bytes a whole number of words per row); the
// warp's strided word loop masks the last partial round itself.
//
// What bounds it on an H100 at B = 32, C = 50, D = 512: it reads
// 2 * B * C * D/2 = 800 KiB of gathered rows, under a microsecond of
// memory time, so it is bound by launch latency. Design: one warp per
// (lane, candidate) row; the 32 threads read consecutive 4-byte words of
// both planes (coalesced 128-byte requests), dp4a them against the lane's
// query words and reduce with warp shuffles. The gathered-rows interface of
// the reference is kept: a kernel that gathers candidate rows by id, and so
// skips the (B, C, D/2) copies, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 rows (warps) per block

// q_eo8 (B, 2, D2) int8; msb/lsb (B, C, D2) uint8; out (B, C) int32.
// D2 % 4 == 0, any length.
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
  const int words = D2 / 4;
  const uint32_t* m = reinterpret_cast<const uint32_t*>(
      msb + static_cast<size_t>(row) * D2);
  const uint32_t* l = reinterpret_cast<const uint32_t*>(
      lsb + static_cast<size_t>(row) * D2);
  const uint32_t* qe = reinterpret_cast<const uint32_t*>(
      q_eo8 + static_cast<size_t>(b) * 2 * D2);
  const uint32_t* qo = qe + words;
  int s = 0;
  for (int w = lane; w < words; w += 32) {
    const uint32_t mw = __ldg(m + w);
    const uint32_t lw = __ldg(l + w);
    const uint32_t even = ((mw & 0x0F0F0F0Fu) << 4) | (lw & 0x0F0F0F0Fu);
    const uint32_t odd = (mw & 0xF0F0F0F0u) | ((lw >> 4) & 0x0F0F0F0Fu);
    s = __dp4a(static_cast<int>(even), static_cast<int>(__ldg(qe + w)), s);
    s = __dp4a(static_cast<int>(odd), static_cast<int>(__ldg(qo + w)), s);
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
  exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_eo8), static_cast<const uint8_t*>(msb),
      static_cast<const uint8_t*>(lsb), static_cast<int32_t*>(out), rows, C,
      D2);
  return static_cast<int>(cudaGetLastError());
}
