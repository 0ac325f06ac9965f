// K7: static two-level (instance -> mesh) Moller-Trumbore closest-hit and
// any-hit over a trace-time instanced scene.
//
// Replaces rendertoy3c_tpu/trace/pallas_instanced.py _trace_instanced
// (:236, the pallas_call at :244): the kernel of _make_kernel (:189) with
// the instance sweep _instance_sweep (:76) and its updates _closest_update
// (:162) and _any_update (:182).
//
// Design: one thread per ray, one 256-thread block per ray tile (the TPU's
// RAY_TILE), because the instance cull is a vote of the whole tile. The
// instance table [I, 20] (world->object affine 0:12, world box 12:18) is
// staged in shared memory INST_CHUNK rows at a time, and the instances are
// a run-time loop in table order (the TPU kernel unrolls them at trace
// time). Per instance every thread slab-tests the box with its world ray,
// bounded by its best t (closest) or its tmax (any-hit), and the block
// votes with __syncthreads_or; every thread reaches the vote. A voted
// instance moves every ray of the block into object space (the direction
// is not normalized: t stays world-parametric) and stages each 128-face
// tile of its mesh in shared memory (9 x 128 floats), which every thread
// then tests with mt.cuh's Moller-Trumbore test.
//
// Exactness: the slab test's min and max keep NaN as jnp.minimum does;
// within a tile the closest update takes the tile's least t (ties to the
// lowest face) with every test bounded by the ray's best t when the tile
// starts, u and v as the reference's masked sums (+ 0.0f), and the tile
// replaces the ray's best only at a strictly smaller t, so the earlier tile
// and instance win. Prim and instance are written as floats.
//
// Output [R, 8]: closest (t, prim, u, v, instance, 0, 0, 0), miss = (tmax,
// -1, 0, 0, -1); any (occluded, 0, ...). Tiles at or past `count` write
// the initial row.
#include "mt.cuh"

namespace rt3c {

constexpr int ITILE = 128;
constexpr int INST_W = 20;
constexpr int INST_CHUNK = 64;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <bool kAny>
__global__ void __launch_bounds__(RAY_TILE)
    instanced_mt_kernel(const float* __restrict__ rays,
                        const int* __restrict__ count,
                        const float* __restrict__ tris,
                        const float* __restrict__ table,
                        const int* __restrict__ inst_tiles, int n_inst,
                        float* __restrict__ out) {
  __shared__ float s_tab[INST_CHUNK * INST_W];
  __shared__ int s_rng[INST_CHUNK * 2];
  __shared__ float s_tile[9 * ITILE];
  const int lane = blockIdx.x * RAY_TILE + threadIdx.x;
  const Ray r = load_ray(rays, lane);
  const bool live = (int)blockIdx.x * RAY_TILE < *count;  // block-uniform
  float best_t = r.tmax, best_prim = -1.0f, best_u = 0.0f, best_v = 0.0f,
        best_inst = -1.0f;
  bool occ = false;
  if (live) {
    const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
    for (int c0 = 0; c0 < n_inst; c0 += INST_CHUNK) {
      const int nc = min(INST_CHUNK, n_inst - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int q = threadIdx.x; q < nc * INST_W; q += RAY_TILE)
        s_tab[q] = table[(size_t)c0 * INST_W + q];
      for (int q = threadIdx.x; q < nc * 2; q += RAY_TILE)
        s_rng[q] = inst_tiles[2 * c0 + q];
      __syncthreads();
      for (int j = 0; j < nc; ++j) {
        const float* m = s_tab + INST_W * j;
        const float t0x = (m[12] - r.ox) * ix;
        const float t1x = (m[15] - r.ox) * ix;
        const float t0y = (m[13] - r.oy) * iy;
        const float t1y = (m[16] - r.oy) * iy;
        const float t0z = (m[14] - r.oz) * iz;
        const float t1z = (m[17] - r.oz) * iz;
        const float tn = max_nan(max_nan(min_nan(t0x, t1x),
                                         min_nan(t0y, t1y)),
                                 min_nan(t0z, t1z));
        const float tf = min_nan(min_nan(max_nan(t0x, t1x),
                                         max_nan(t0y, t1y)),
                                 max_nan(t0z, t1z));
        const float tcur = kAny ? r.tmax : best_t;
        const bool in_box = (tn <= tf) && (tf >= r.tmin) && (tn <= tcur);
        if (!__syncthreads_or(in_box)) continue;  // every thread votes
        Ray q;
        q.ox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[3];
        q.oy = m[4] * r.ox + m[5] * r.oy + m[6] * r.oz + m[7];
        q.oz = m[8] * r.ox + m[9] * r.oy + m[10] * r.oz + m[11];
        q.dx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
        q.dy = m[4] * r.dx + m[5] * r.dy + m[6] * r.dz;
        q.dz = m[8] * r.dx + m[9] * r.dy + m[10] * r.dz;
        q.tmin = r.tmin;
        q.tmax = r.tmax;
        const int start = s_rng[2 * j];
        const int n_tiles = s_rng[2 * j + 1];
        const float inst_f = (float)(c0 + j);
        for (int k = start; k < start + n_tiles; ++k) {
          stage_tile(tris, k, ITILE, s_tile);
          if (kAny) {
            if (occ) continue;
            for (int f = 0; f < ITILE; ++f) {
              float t, u, v;
              if (mt_test(q, r.tmax, s_tile, ITILE, f, t, u, v)) {
                occ = true;
                break;
              }
            }
          } else {
            // face 0 seeds the tile's minimum: with no hit the reference
            // picks face 0 at t = BIG
            float t, u, v;
            const bool h0 = mt_test(q, best_t, s_tile, ITILE, 0, t, u, v);
            float tc = h0 ? t : BIG, uc = u, vc = v;
            int fc = 0;
            for (int f = 1; f < ITILE; ++f) {
              const bool h = mt_test(q, best_t, s_tile, ITILE, f, t, u, v);
              if ((h ? t : BIG) < tc) {
                tc = t;
                fc = f;
                uc = u;
                vc = v;
              }
            }
            if (tc < best_t) {
              best_t = tc;
              best_prim = (float)(k * ITILE + fc);
              best_u = uc + 0.0f;
              best_v = vc + 0.0f;
              best_inst = inst_f;
            }
          }
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + 8 * (size_t)lane);
  if (kAny)
    o[0] = make_float4(occ ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
  else
    o[0] = make_float4(best_t, best_prim, best_u, best_v);
  o[1] = make_float4(kAny ? 0.0f : best_inst, 0.0f, 0.0f, 0.0f);
}

}  // namespace rt3c

// rays [n_rays, 8], n_rays a multiple of 256; count int32 [1] on the
// device; tris [T, 9, 128] the object-space soup; table [n_inst, 20];
// inst_tiles int32 [n_inst, 2] (first tile, tile count) of each instance's
// mesh; out [n_rays, 8].
extern "C" int rt3c_instanced_mt(int device, int any, const float* rays,
                                 int n_rays, const int* count,
                                 const float* tris, const float* table,
                                 const int* inst_tiles, int n_inst,
                                 float* out, void* stream) {
  if (n_rays % rt3c::RAY_TILE != 0 || n_inst < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const dim3 grid(n_rays / rt3c::RAY_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any)
    rt3c::instanced_mt_kernel<true><<<grid, rt3c::RAY_TILE, 0, s>>>(
        rays, count, tris, table, inst_tiles, n_inst, out);
  else
    rt3c::instanced_mt_kernel<false><<<grid, rt3c::RAY_TILE, 0, s>>>(
        rays, count, tris, table, inst_tiles, n_inst, out);
  return (int)cudaGetLastError();
}
