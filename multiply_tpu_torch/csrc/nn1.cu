// Nearest neighbour (K=1) of each query point among a small reference set.
//
// Replaces the Pallas TPU kernel multiply_tpu/ops/knn_pallas.py::nn1_pallas
// (_nn_kernel): for every query, the squared distance to the nearest
// reference point and its index, from direct squared differences, ties going
// to the lower index. Used by the deformer's skinning-weight transfer on every
// SDF evaluation of the training step (8 calls a step, both persons at once).
//
// Bound on an H100: FP32 arithmetic. Each (query, ref) pair costs 3 subs,
// 3 muls, 2 adds and a compare (~9 operations) while a query moves only
// 12 bytes in and 8 out, so at V = 386..6890 refs the work is 1e2..1e3
// operations per byte, far above the card's FP32 ridge.
//
// Design: one thread per query, the query held in registers. The reference
// set is staged through shared memory in fixed tiles of TILE points (as three
// float arrays, 24 KB), so any V works without the dynamic-shared-memory
// opt-in; every thread of a warp reads the same ref at once, which shared
// memory broadcasts without bank conflicts. A running min/argmin with a
// strict `<` over ascending indices keeps the lowest index on ties, as the
// TPU kernel's `take = tile_min < best` does. The distance is rounded exactly
// as written (no fused multiply-add) so it matches the plain PyTorch version
// bit for bit. gridDim.y is the person axis: one launch serves all persons.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 2048;
constexpr int THREADS = 256;

__global__ void nn1_kernel(const float* __restrict__ query,  // (P, N, 3)
                           const float* __restrict__ refs,   // (P, V, 3)
                           float* __restrict__ d2_out,       // (P, N)
                           int* __restrict__ idx_out,        // (P, N)
                           int N, int V) {
  __shared__ float sx[TILE];
  __shared__ float sy[TILE];
  __shared__ float sz[TILE];

  const int p = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < N;
  const float* q = query + ((size_t)p * N + (live ? i : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* r = refs + (size_t)p * V * 3;

  float best = CUDART_INF_F;
  int best_idx = 0;
  for (int base = 0; base < V; base += TILE) {
    const int len = min(TILE, V - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < len; j += THREADS) {
      const float* v = r + (size_t)(base + j) * 3;
      sx[j] = v[0];
      sy[j] = v[1];
      sz[j] = v[2];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_idx = base + j;
      }
    }
  }
  if (live) {
    d2_out[(size_t)p * N + i] = best;
    idx_out[(size_t)p * N + i] = best_idx;
  }
}

}  // namespace

extern "C" int nn1_launch(const float* query, const float* refs, float* d2, int* idx,
                          int P, int N, int V, void* stream) {
  const dim3 grid((N + THREADS - 1) / THREADS, P);
  nn1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(query, refs, d2, idx, N, V);
  return static_cast<int>(cudaGetLastError());
}
