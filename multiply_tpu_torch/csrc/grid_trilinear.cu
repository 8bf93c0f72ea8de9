// Trilinear interpolation of a res^3 signed-distance grid at N points.
//
// Replaces the Pallas TPU kernel multiply_tpu/ops/grid_pallas.py::_grid_trilinear
// (_kernel), which the renderer's in/off-surface tests call once a training
// step (models/renderer.py _training_extras). The grid is indexed
// g[ix, iy, iz]; coordinates are (p - origin) / spacing clamped to
// [0, res - 1 - 1e-6] with i1 = min(i0 + 1, res - 1), exactly as
// multiply_tpu/ops/mesh_ops.py::grid_query. The TPU kernel contracted a
// one-hot matrix against the grid in bf16 on its matrix unit to avoid slow
// gathers; here gathers are cheap, so the grid stays in f32.
//
// Bound on an H100: memory and launch latency. A point reads 12 bytes, writes
// 4 and does ~30 operations; the step's ~100k points move ~1.6 MB, and the
// 1 MB grid (res 64) stays resident in the 50 MB L2 cache.
//
// Design: one thread per point, eight corner loads through the read-only
// cache. gridDim.y is the person axis, so one launch serves all persons.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void grid_trilinear_kernel(const float* __restrict__ grid,     // (P, res, res, res)
                                      const float* __restrict__ pts,      // (P, N, 3)
                                      const float* __restrict__ origin,   // (P, 3)
                                      const float* __restrict__ spacing,  // (P, 3)
                                      float* __restrict__ out,            // (P, N)
                                      int N, int res) {
  const int p = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float hi = static_cast<float>(static_cast<double>(res - 1) - 1e-6);
  const float* q = pts + ((size_t)p * N + n) * 3;
  int i0[3], i1[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float x = (q[a] - origin[p * 3 + a]) / spacing[p * 3 + a];
    x = fminf(fmaxf(x, 0.0f), hi);
    const float xf = floorf(x);
    i0[a] = static_cast<int>(xf);
    i1[a] = min(i0[a] + 1, res - 1);
    f[a] = x - xf;
  }
  const float* g = grid + (size_t)p * res * res * res;
  auto at = [&](int ix, int iy, int iz) { return __ldg(g + ((size_t)ix * res + iy) * res + iz); };
  const float c000 = at(i0[0], i0[1], i0[2]), c001 = at(i0[0], i0[1], i1[2]);
  const float c010 = at(i0[0], i1[1], i0[2]), c011 = at(i0[0], i1[1], i1[2]);
  const float c100 = at(i1[0], i0[1], i0[2]), c101 = at(i1[0], i0[1], i1[2]);
  const float c110 = at(i1[0], i1[1], i0[2]), c111 = at(i1[0], i1[1], i1[2]);
  const float fx = f[0], fy = f[1], fz = f[2];
  const float c00 = c000 * (1.0f - fz) + c001 * fz;
  const float c01 = c010 * (1.0f - fz) + c011 * fz;
  const float c10 = c100 * (1.0f - fz) + c101 * fz;
  const float c11 = c110 * (1.0f - fz) + c111 * fz;
  const float c0 = c00 * (1.0f - fy) + c01 * fy;
  const float c1 = c10 * (1.0f - fy) + c11 * fy;
  out[(size_t)p * N + n] = c0 * (1.0f - fx) + c1 * fx;
}

}  // namespace

extern "C" int grid_trilinear_launch(const float* grid, const float* pts, const float* origin,
                                     const float* spacing, float* out, int P, int N, int res,
                                     void* stream) {
  const dim3 blocks((N + THREADS - 1) / THREADS, P);
  grid_trilinear_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, pts, origin, spacing, out, N, res);
  return static_cast<int>(cudaGetLastError());
}
