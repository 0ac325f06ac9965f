// K4 and K5 (megakernel.cuh) without AOV, and the C entry points of both
// halves: a launch with p->aov takes the AOV instantiations of
// megakernel_aov.cu.
#include "megakernel.cuh"

namespace rt3c {

__global__ void seed_stats(const int* __restrict__ stats_in,
                           int* __restrict__ stats_out) {
  stats_out[0] = stats_in[0];
  stats_out[1] = 0;
  stats_out[2] = 0;
  stats_out[3] = 0;
}

}  // namespace rt3c

// tris, aabb, super_aabb: the key-0 tiles and the cull boxes (the union of
// both keys' for motion), p->n_faces real faces, the columns past them
// zero; tris1 and time: the key-1 tiles and the per-lane
// time [P], null for a static scene; tex: the atlas of a textured scene,
// null for an untextured one; p->params_base > 0 takes the dispatch
// variant, p->aov the AOV variant (misc [P, 24]).
extern "C" int rt3c_trace_shade_refill(
    int device, const rt3c::RefillParams* p, float* rays, float* misc,
    float* stash, float* time, int n_lanes, const int* stats_in,
    int* stats_out, const float* tris, const float* tris1, const float* aabb,
    const float* super_aabb, const float* attr_t, const float* lights_t,
    const unsigned int* jump, const rt3c::TexParams* tex, void* stream) {
  if (n_lanes <= 0 || n_lanes % rt3c::RAY_TILE != 0 || p->ct > rt3c::MAX_CT ||
      p->n_tiles < 1 || p->n_faces < 1 || p->n_faces > p->n_tiles * p->ct ||
      p->num_lights < 1 || p->spp < 1 || p->width < 1 ||
      p->params_base < 0 ||
      (p->motion && (tris1 == nullptr || time == nullptr)) ||
      (tex && (tex->texels == nullptr || tex->meta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rt3c::seed_stats<<<1, 1, 0, s>>>(stats_in, stats_out);
  const rt3c::Soup soup{tris,      aabb,  super_aabb,
                        p->n_tiles, p->ct, p->n_faces};
  if (p->aov)
    return rt3c::launch_refill_aov(p, rays, misc, stash, time, n_lanes,
                                   stats_in, stats_out, soup, tris1, attr_t,
                                   lights_t, jump, tex, s);
  return rt3c::launch_refill<false>(p, rays, misc, stash, time, n_lanes,
                                    stats_in, stats_out, soup, tris1, attr_t,
                                    lights_t, jump, tex, s);
}

// hit4 [P, 4]: the closest hits of the non-merged K5, null for the merged
// one (which sweeps them in the kernel; a motion launch then needs time).
extern "C" int rt3c_trace_shade(int device, const rt3c::TraceShadeParams* p,
                                const float* rays, const float* misc,
                                const float* time, const float* hit4,
                                int n_lanes, const int* count,
                                const float* tris,
                                const float* tris1, const float* aabb,
                                const float* super_aabb, const float* attr_t,
                                const float* lights_t, float* rays_out,
                                float* misc_out, const rt3c::TexParams* tex,
                                void* stream) {
  if (n_lanes <= 0 || n_lanes % rt3c::RAY_TILE != 0 || p->ct > rt3c::MAX_CT ||
      p->n_tiles < 1 || p->n_faces < 1 || p->n_faces > p->n_tiles * p->ct ||
      p->num_lights < 1 || p->params_base < 0 ||
      (p->motion &&
       (tris1 == nullptr || (time == nullptr && hit4 == nullptr))) ||
      (tex && (tex->texels == nullptr || tex->meta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rt3c::Soup soup{tris,      aabb,  super_aabb,
                        p->n_tiles, p->ct, p->n_faces};
  if (p->aov)
    return rt3c::launch_trace_shade_aov(p, rays, misc, time, hit4, n_lanes,
                                        count, soup, tris1, attr_t, lights_t,
                                        rays_out, misc_out, tex, s);
  return rt3c::launch_trace_shade<false>(p, rays, misc, time, hit4, n_lanes,
                                         count, soup, tris1, attr_t, lights_t,
                                         rays_out, misc_out, tex, s);
}
