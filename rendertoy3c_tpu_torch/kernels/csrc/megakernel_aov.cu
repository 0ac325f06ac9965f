// K4 and K5 (megakernel.cuh) with the first-hit AOV rows: the 16 kAov
// instantiations, in a translation unit of their own so that nvcc compiles
// them beside megakernel.cu's 16. Reached through megakernel.cu's C entry
// points.
#include "megakernel.cuh"

namespace rt3c {

int launch_refill_aov(const RefillParams* p, float* rays, float* misc,
                      float* stash, float* time, int n_lanes,
                      const int* stats_in, int* stats_out, const Soup& soup,
                      const float* tris1, const float* attr_t,
                      const float* lights_t, const unsigned int* jump,
                      const TexParams* tex, cudaStream_t s) {
  return launch_refill<true>(p, rays, misc, stash, time, n_lanes, stats_in,
                             stats_out, soup, tris1, attr_t, lights_t, jump,
                             tex, s);
}

int launch_trace_shade_aov(const TraceShadeParams* p, const float* rays,
                           const float* misc, const float* time,
                           const float* hit4, int n_lanes, const int* count,
                           const Soup& soup, const float* tris1,
                           const float* attr_t, const float* lights_t,
                           float* rays_out, float* misc_out,
                           const TexParams* tex, cudaStream_t s) {
  return launch_trace_shade<true>(p, rays, misc, time, hit4, n_lanes, count,
                                  soup, tris1, attr_t, lights_t, rays_out,
                                  misc_out, tex, s);
}

}  // namespace rt3c
