// K1/K2: dense Moller-Trumbore closest-hit and any-hit over the whole
// triangle soup, with the two-level tile cull and the live-count skip.
// K3: the same for 2-key motion, triangles lerped to each ray's time.
//
// Replaces rendertoy3c_tpu/trace/pallas_mt.py _closest_kernel (:256) and
// _any_kernel (:302), launched by _mt_pallas_call (:340), and
// _closest_kernel_motion (:545) and _any_kernel_motion (:593), launched by
// _mt_motion_call (:632).
//
// Bound: arithmetic. Each ray-triangle pair costs ~30 flops and no memory
// traffic (the tile sits in shared memory, the ray in registers), so the
// sweep runs at the SMs' fp32 rate; a Cornell-sized soup is one 128-wide
// tile. Design: one thread per ray, one 256-thread block per ray tile (the
// TPU's RAY_TILE), so the live-count skip and the cull votes act on the
// same 256-ray tiles as on the TPU. `count` is read from device memory, so
// the host never synchronises to pass it.
//
// Output [R, 4]: closest (t, prim as float, u, v), miss = (tmax, -1, 0, 0);
// any (occluded, 0, 0, 0). Tiles at or past `count` write the miss row.
//
// K3 works on 128-ray tiles (MOTION_RAY_TILE), as the TPU kernel does, so
// its count skip acts on the same rays. Each block stages both keys' tiles
// (2 x 9 x 512 floats = 36 KB of shared memory) and lerps every triangle
// component, r0 + (r1 - r0) * time; the cull boxes are the union of both
// keys' boxes, which hold a triangle at any time in [0, 1].
#include "mt.cuh"

namespace rt3c {

template <bool kAny>
__global__ void __launch_bounds__(RAY_TILE)
    mt_kernel(const float* __restrict__ rays, const int* __restrict__ count,
              Soup soup, float* __restrict__ out) {
  __shared__ float tile[9 * MAX_CT];
  const int i = blockIdx.x * RAY_TILE + threadIdx.x;
  const Ray r = load_ray(rays, i);
  const bool live = (int)blockIdx.x * RAY_TILE < *count;
  float4 res;
  if (kAny) {
    const bool occ = sweep_any(soup, tile, r, live, true);
    res = make_float4(occ ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    const ClosestHit h = sweep_closest(soup, tile, r, live);
    res = make_float4(h.t, h.prim, h.u, h.v);
  }
  reinterpret_cast<float4*>(out)[i] = res;
}

template <bool kAny>
__global__ void __launch_bounds__(MOTION_RAY_TILE)
    mt_motion_kernel(const float* __restrict__ rays,
                     const float* __restrict__ time,
                     const int* __restrict__ count, MotionSoup soup,
                     float* __restrict__ out) {
  __shared__ float tile0[9 * MAX_CT];
  __shared__ float tile1[9 * MAX_CT];
  const int i = blockIdx.x * MOTION_RAY_TILE + threadIdx.x;
  const Ray r = load_ray(rays, i);
  const float tm = time[i];
  const bool live = (int)blockIdx.x * MOTION_RAY_TILE < *count;
  float4 res;
  if (kAny) {
    const bool occ =
        sweep_any_motion(soup, tile0, tile1, r, tm, live, true);
    res = make_float4(occ ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    const ClosestHit h = sweep_closest_motion(soup, tile0, tile1, r, tm, live);
    res = make_float4(h.t, h.prim, h.u, h.v);
  }
  reinterpret_cast<float4*>(out)[i] = res;
}

}  // namespace rt3c

extern "C" int rt3c_mt_trace(int device, int any, const float* rays,
                             int n_rays, const int* count, const float* tris,
                             const float* aabb, const float* super_aabb,
                             int n_tiles, int ct, float* out, void* stream) {
  if (n_rays % rt3c::RAY_TILE != 0 || ct > rt3c::MAX_CT || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const rt3c::Soup soup{tris, aabb, super_aabb, n_tiles, ct};
  const dim3 grid(n_rays / rt3c::RAY_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any)
    rt3c::mt_kernel<true><<<grid, rt3c::RAY_TILE, 0, s>>>(rays, count, soup,
                                                         out);
  else
    rt3c::mt_kernel<false><<<grid, rt3c::RAY_TILE, 0, s>>>(rays, count, soup,
                                                          out);
  return (int)cudaGetLastError();
}

extern "C" int rt3c_mt_trace_motion(int device, int any, const float* rays,
                                    const float* time, int n_rays,
                                    const int* count, const float* tris0,
                                    const float* tris1, const float* aabb,
                                    const float* super_aabb, int n_tiles,
                                    int ct, float* out, void* stream) {
  if (n_rays % rt3c::MOTION_RAY_TILE != 0 || ct > rt3c::MAX_CT || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const rt3c::MotionSoup soup{tris0, tris1, aabb, super_aabb, n_tiles, ct};
  const dim3 grid(n_rays / rt3c::MOTION_RAY_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any)
    rt3c::mt_motion_kernel<true><<<grid, rt3c::MOTION_RAY_TILE, 0, s>>>(
        rays, time, count, soup, out);
  else
    rt3c::mt_motion_kernel<false><<<grid, rt3c::MOTION_RAY_TILE, 0, s>>>(
        rays, time, count, soup, out);
  return (int)cudaGetLastError();
}
