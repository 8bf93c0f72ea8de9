// Trilinear interpolation of a res^3 signed-distance grid at N points, with the
// caller's minimum over each run of `group` consecutive points fused in.
//
// Replaces the Pallas TPU kernel multiply_tpu/ops/grid_pallas.py::_grid_trilinear
// (_kernel), which the renderer's in/off-surface tests call once a training
// step (models/renderer.py _training_extras) and reduce at once to the least
// distance along each ray. The grid is indexed g[ix, iy, iz]; coordinates are
// (p - origin) / spacing clamped to [0, res - 1 - 1e-6] with
// i1 = min(i0 + 1, res - 1), exactly as ops/mesh_ops.py::grid_query. The TPU
// kernel contracted a one-hot matrix against the grid in bf16 on its matrix
// unit to avoid slow gathers; here gathers are cheap, so the grid stays in f32.
//
// Bound on an H100: memory and launch latency. A point reads 12 bytes and does
// ~40 operations; the step's ~100k points move 1.2 MB, and the 1 MB grid
// (res 64) stays resident in the 50 MB L2 cache. What a redesign can save is
// traffic and launches around the interpolation, so:
//
// - group == 1: one value per point, the TPU kernel's output.
// - group == S: a warp owns one (person, ray). Its lanes stride over the ray's
//   S consecutive points, each keeps a running fminf, a __shfl_xor_sync tree
//   finishes it and lane 0 writes out[p, r]. The (P, N) array never exists
//   and the caller launches no reduction.
//
// Both forms are one kernel template around one interpolation function, so the
// arithmetic checked per point is the arithmetic that runs fused. In the fused
// form a lane interpolates PER_LANE points at once, without a branch between
// them, so that their 8 x PER_LANE corner reads are in flight together; per
// point a lane takes one, which gives the most warps. A lane reads its point's
// three floats directly: a warp's 32 points are 384 consecutive bytes, which
// the L1 cache serves in whole lines. Staging them through shared memory with
// coalesced loads was built and measured on the card and was no faster in
// either form, with random points or with points along rays, so the simpler
// reads stayed. The corner reads go through the read-only path. gridDim.y is
// the person axis.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;     // warps a block
constexpr int PER_LANE = 4;  // points a lane interpolates at once in the fused form

struct Frame {
  const float* g;  // this person's grid
  float ox, oy, oz, sx, sy, sz, hi;
  int res;
};

__device__ __forceinline__ void cell(float q, float o, float s, float hi, int res, int& i0, int& i1,
                                     float& f) {
  const float x = fminf(fmaxf((q - o) / s, 0.0f), hi);
  const float xf = floorf(x);
  i0 = static_cast<int>(xf);
  i1 = min(i0 + 1, res - 1);
  f = x - xf;
}

__device__ __forceinline__ float interpolate(const Frame& fr, float qx, float qy, float qz) {
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  cell(qx, fr.ox, fr.sx, fr.hi, fr.res, x0, x1, fx);
  cell(qy, fr.oy, fr.sy, fr.hi, fr.res, y0, y1, fy);
  cell(qz, fr.oz, fr.sz, fr.hi, fr.res, z0, z1, fz);
  const int res = fr.res;
  auto at = [&](int ix, int iy, int iz) { return __ldg(fr.g + ((size_t)ix * res + iy) * res + iz); };
  const float c000 = at(x0, y0, z0), c001 = at(x0, y0, z1);
  const float c010 = at(x0, y1, z0), c011 = at(x0, y1, z1);
  const float c100 = at(x1, y0, z0), c101 = at(x1, y0, z1);
  const float c110 = at(x1, y1, z0), c111 = at(x1, y1, z1);
  const float c00 = c000 * (1.0f - fz) + c001 * fz;
  const float c01 = c010 * (1.0f - fz) + c011 * fz;
  const float c10 = c100 * (1.0f - fz) + c101 * fz;
  const float c11 = c110 * (1.0f - fz) + c111 * fz;
  const float c0 = c00 * (1.0f - fy) + c01 * fy;
  const float c1 = c10 * (1.0f - fy) + c11 * fy;
  return c0 * (1.0f - fx) + c1 * fx;
}

// A warp owns a run of consecutive points of one person: `group` points whose
// minimum it writes (REDUCE), or 32 points written one by one.
template <bool REDUCE>
__global__ void __launch_bounds__(WARPS * 32)
grid_trilinear_kernel(const float* __restrict__ grid,     // (P, res, res, res)
                      const float* __restrict__ pts,      // (P, N, 3)
                      const float* __restrict__ origin,   // (P, 3)
                      const float* __restrict__ spacing,  // (P, 3)
                      float* __restrict__ out,            // (P, N) or (P, N / group)
                      int N, int res, int group) {
  constexpr int per_lane = REDUCE ? PER_LANE : 1;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.y;
  const int run = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int run_len = REDUCE ? group : 32;
  const long long start = static_cast<long long>(run) * run_len;
  if (start >= N) return;
  const int len = static_cast<int>(min(static_cast<long long>(run_len), N - start));

  Frame fr;
  fr.g = grid + (size_t)p * res * res * res;
  fr.ox = origin[p * 3 + 0], fr.oy = origin[p * 3 + 1], fr.oz = origin[p * 3 + 2];
  fr.sx = spacing[p * 3 + 0], fr.sy = spacing[p * 3 + 1], fr.sz = spacing[p * 3 + 2];
  fr.hi = static_cast<float>(static_cast<double>(res - 1) - 1e-6);
  fr.res = res;

  const size_t first = (size_t)p * N + start;
  float best = CUDART_INF_F;
  for (int c = 0; c < len; c += 32 * per_lane) {
#pragma unroll
    for (int k = 0; k < per_lane; ++k) {
      // a lane past the end repeats the run's last point: no branch between
      // the interpolations, and the repeat cannot change a minimum
      const int j = c + lane + 32 * k;
      const float* q = pts + (first + min(j, len - 1)) * 3;
      const float v = interpolate(fr, __ldg(q), __ldg(q + 1), __ldg(q + 2));
      if constexpr (REDUCE) {
        best = fminf(best, v);
      } else {
        if (j < len) out[first + j] = v;
      }
    }
  }
  if constexpr (REDUCE) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) best = fminf(best, __shfl_xor_sync(0xffffffffu, best, d));
    if (lane == 0) out[(size_t)p * (N / group) + run] = best;
  }
}

}  // namespace

// group == 1: out (P, N), one value per point. group > 1 (N a multiple of it):
// out (P, N / group), the least value of each run of `group` consecutive points.
extern "C" int grid_trilinear_launch(const float* grid, const float* pts, const float* origin,
                                     const float* spacing, float* out, int P, int N, int res,
                                     int group, void* stream) {
  const int runs = group == 1 ? (N + 31) / 32 : N / group;
  const dim3 blocks((runs + WARPS - 1) / WARPS, P);
  const auto s = static_cast<cudaStream_t>(stream);
  if (group == 1) {
    grid_trilinear_kernel<false><<<blocks, WARPS * 32, 0, s>>>(grid, pts, origin, spacing, out, N,
                                                              res, group);
  } else {
    grid_trilinear_kernel<true><<<blocks, WARPS * 32, 0, s>>>(grid, pts, origin, spacing, out, N,
                                                             res, group);
  }
  return static_cast<int>(cudaGetLastError());
}
