// The dp4a shared-plane scan of stage1_plane.cuh at 512 and 1024 rows per
// block; stage1_int4.cu compiles the 128- and 256-row tiles beside this
// source, so the two build in parallel.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/stage1_int4.py  stage1_int4_batched_pallas
//   src/repro/kernels/stage1_int4.py  stage1_int4_pallas (B = 1)
// for these tiles.

#include "stage1_plane.cuh"

// q_panel (2, B, D2) int8, plane (N, D2) uint8, out (B, N) int32. rows:
// threads (plane rows) per block, 512 or 1024.
extern "C" int stage1_plane_launch(const void* q_panel, const void* plane,
                                   void* out, int B, long long N, int D2,
                                   int rows, void* stream) {
  return plane_launch<512, 1024>(q_panel, plane, out, B, N, D2, rows, stream);
}
