// Nearest neighbour (K=1) of each query point among a small reference set.
//
// Replaces the Pallas TPU kernel multiply_tpu/ops/knn_pallas.py::nn1_pallas
// (_nn_kernel): for every query, the squared distance to the nearest
// reference point and its index, from direct squared differences, ties going
// to the lower index. Used by the deformer's skinning-weight transfer on every
// SDF evaluation of the training step (8 calls a step, both persons at once).
//
// Bound on an H100: FP32 instruction slots. Each (query, ref) pair costs 3 subs,
// 3 muls, 2 adds and a compare (~9 operations) while a query moves only
// 12 bytes in and 12 out, so at V = 386..6890 refs the work is 1e2..1e3
// operations per byte, far above the card's FP32 ridge. The card's peak counts
// a fused multiply-add as two operations and a scheduler starts one warp
// instruction a clock, so what decides the time is how few instructions a pair
// takes: direct differences need 6 (3 FADD, FMUL, 2 FFMA) before any selection,
// which puts the floor of this formulation at 4/3 of the 9-operation bound.
//
// Design:
// - Register tiling. A thread holds QUERIES queries; the references sit in
//   shared memory as float4 (x, y, z, pad), so one 16-byte broadcast load
//   serves QUERIES pairs (1/4 load a pair, from 3) and the queries' chains are
//   independent. 128 threads x 4 queries give the step's main call (2 x 65,536
//   queries) 256 blocks, all resident at once on the 132 SMs.
// - Selection by groups of GROUP references. Per query the minimum of the
//   group's distances is taken with fminf, and one strict `<` against the
//   running best records the group's first index: 1.25 instructions a pair in
//   place of a compare and two selects. Ascending groups with a strict `<`
//   keep the lowest group that holds the minimum, across tiles too, as the TPU
//   kernel's `take = tile_min < best` does; after a tile's scan the thread
//   reads the winning group again from shared memory and takes the first
//   reference that attains the minimum (ascending, strict `<`), which is the
//   lowest index overall. The per-pair strict `<` was not taken because it
//   takes more than twice the instructions for the same answer; a data-dependent
//   rescan inside the loop was not taken because with 128 queries a warp some
//   lane improves in almost every group. Groups of 8 were measured against 4
//   and 16 on the card (kernel_sweep.py): 4 is a tenth faster at V = 386 and a
//   quarter slower at V = 6890, 16 the other way round by a tenth each.
// - Rounding. The distance is fma(dz, dz, fma(dy, dy, dx * dx)) from exactly
//   rounded differences: 6 instructions a pair in place of 8. It differs from
//   the plain version's (dx*dx + dy*dy) + dz*dz in the last bit, so the two are
//   held to 1e-6 relative, and an index may differ only where two candidates
//   tie that closely. Compiled with -DNN1_EXACT_ROUNDING the distance is
//   rounded as the plain version rounds it and the kernel agrees bit for bit:
//   that build exists to check the tiling and the selection, not to run.
// - The whole reference set in shared memory. Up to TILE_MAX points (112 KB of
//   dynamic shared memory, opted in to above 48 KB, two blocks to an SM) are
//   loaded once, as the TPU kernel held them in VMEM: a real SMPL body (6890)
//   fits. A larger set streams through in tiles of TILE_MAX. The packed rows
//   are read with coalesced, independent loads and scattered to their float4
//   slots. Padding points lie at infinity and never win.
// gridDim.y is the person axis: one launch serves all persons. The outputs are
// written in their final form, d2 as it is (never negative) and the index as
// int64.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;
constexpr int QUERIES = 4;      // queries a thread
constexpr int GROUP = 8;        // references a selection step
constexpr int TILE_MAX = 7168;  // references in shared memory at once; a multiple of GROUP

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
#ifdef NN1_EXACT_ROUNDING
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
#else
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
#endif
}

__global__ void __launch_bounds__(THREADS)
nn1_kernel(const float* __restrict__ query,   // (P, N, 3)
           const float* __restrict__ refs,    // (P, V, 3)
           float* __restrict__ d2_out,        // (P, N)
           long long* __restrict__ idx_out,   // (P, N)
           int N, int V, int tile) {
  extern __shared__ float4 s[];  // `tile` references

  const int p = blockIdx.y;
  const float* r = refs + (size_t)p * V * 3;
  const size_t row = (size_t)p * N;
  const int first = blockIdx.x * (THREADS * QUERIES) + threadIdx.x;

  float qx[QUERIES], qy[QUERIES], qz[QUERIES], best[QUERIES];
  int group[QUERIES], idx[QUERIES];
#pragma unroll
  for (int k = 0; k < QUERIES; ++k) {
    const int i = min(first + k * THREADS, N - 1);  // a thread past the end repeats the last query
    const float* q = query + (row + i) * 3;
    qx[k] = q[0], qy[k] = q[1], qz[k] = q[2];
    best[k] = CUDART_INF_F;
    group[k] = 0;
    idx[k] = 0;
  }

  float* words = reinterpret_cast<float*>(s);
  for (int base = 0; base < V; base += tile) {
    const int len = min(tile, V - base);
    const int padded = (len + GROUP - 1) / GROUP * GROUP;
    const float* src = r + (size_t)base * 3;
    __syncthreads();  // the previous tile is no longer read
    // coalesced, independent loads of the packed (x, y, z) rows, scattered to float4 slots
#pragma unroll 4
    for (int f = threadIdx.x; f < 3 * len; f += THREADS) {
      const int j = f / 3;
      words[4 * j + (f - 3 * j)] = __ldg(src + f);
    }
    for (int j = len + threadIdx.x; j < padded; j += THREADS) {
      s[j] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.0f);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < padded; j += GROUP) {
      float4 g[GROUP];
#pragma unroll
      for (int t = 0; t < GROUP; ++t) g[t] = s[j + t];
#pragma unroll
      for (int k = 0; k < QUERIES; ++k) {
        float m = dist2(qx[k], qy[k], qz[k], g[0].x, g[0].y, g[0].z);
#pragma unroll
        for (int t = 1; t < GROUP; ++t) m = fminf(m, dist2(qx[k], qy[k], qz[k], g[t].x, g[t].y, g[t].z));
        if (m < best[k]) {
          best[k] = m;
          group[k] = base + j;
        }
      }
    }
    // where this tile moved the winner: the first reference of the winning group
    // that attains its minimum (the padding never does)
#pragma unroll
    for (int k = 0; k < QUERIES; ++k) {
      if (group[k] < base) continue;
      float d = CUDART_INF_F;
      int at = 0;
#pragma unroll
      for (int t = 0; t < GROUP; ++t) {
        const float4 v = s[group[k] - base + t];
        const float dt = dist2(qx[k], qy[k], qz[k], v.x, v.y, v.z);
        if (dt < d) {
          d = dt;
          at = t;
        }
      }
      idx[k] = group[k] + at;
    }
  }

#pragma unroll
  for (int k = 0; k < QUERIES; ++k) {
    const int i = first + k * THREADS;
    if (i < N) {
      d2_out[row + i] = best[k];
      idx_out[row + i] = idx[k];
    }
  }
}

}  // namespace

extern "C" int nn1_launch(const float* query, const float* refs, float* d2, long long* idx, int P,
                          int N, int V, void* stream) {
  const int tile = std::min((V + GROUP - 1) / GROUP * GROUP, TILE_MAX);
  const size_t shared = (size_t)tile * sizeof(float4);
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(nn1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + THREADS * QUERIES - 1) / (THREADS * QUERIES), P);
  nn1_kernel<<<grid, THREADS, shared, static_cast<cudaStream_t>(stream)>>>(query, refs, d2, idx, N,
                                                                           V, tile);
  return static_cast<int>(cudaGetLastError());
}
