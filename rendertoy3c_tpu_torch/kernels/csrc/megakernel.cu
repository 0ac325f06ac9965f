// K4: the in-kernel-refill megakernel of the pool integrator, for the
// static, untextured, all-diffuse, uniform-light, stash-on configuration.
//
// Replaces rendertoy3c_tpu/trace/pallas_shade.py _make_shade_kernel (:271)
// as built by make_fused_shader(merged=True, refill=...) and launched by
// trace_shade_refill (:1281-1367). One launch is one pool iteration:
// closest sweep, attribute fetch by prim, emission, miss ambient,
// Lambertian draw, uniform NEE light pick + area sample, shadow sweep,
// Russian roulette, the next path state, then the refill epilogue (retire
// into the stash, pixel claim, tea seed, per-sample LCG jump, jittered
// camera ray) and the launch stats (next_work, count_hint, n_live, 0).
//
// Bound: latency. A pool of 32768 lanes is 128 blocks of 256 threads, less
// than one block per SM, and each lane does two sweeps of dependent loads
// and a chain of scalar math; the per-lane state (rays 32 B, misc 64 B,
// stash 64 B in and out) is a few MB per launch. Design: one thread per
// lane, state updated in place (each thread reads and writes only its own
// lane, the CUDA form of the TPU kernel's input/output aliasing), tables
// read by plain fp32 indexed loads (no one-hot matmul, so no TF32 path).
//
// The work counter: TPU grid steps run in order and step 0 seeds an SMEM
// counter; CUDA blocks run concurrently. Here a one-thread launch first
// seeds stats_out = (next_work, 0, 0, 0) from the previous launch's stats
// (stats_in, never the same buffer), and each block claims pixels for its
// idle lanes with an in-block exclusive scan plus one compare-and-swap loop
// that clamps the counter at n_pix. Which block gets which pixels varies
// from run to run; per-pixel RNG streams are keyed by pixel id (tea), so the
// image does not depend on it.
#include "mt.cuh"

namespace rt3c {

// Launch parameters; mirrored field for field by kernels/build.py.
struct RefillParams {
  int n_pix, spp, width, max_depth;
  int num_lights, pixel_base, subframe_index, attr_stride;
  int light_stride, n_tiles, ct, pad_i;
  unsigned int seed_rot;
  float width_f, height_f, tmin, tmax;
  float shadow_tmin, shadow_eps, pick_pdf;
  float bg[3];
  float cam[12];  // eye, u, v, w
};

constexpr double PI_D = 3.14159265358979323846;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float INV_2_24 = 1.0f / 16777216.0f;

__device__ __forceinline__ uint32_t lcg_next(uint32_t s) {
  return 1664525u * s + 1013904223u;
}

__device__ __forceinline__ float lcg_unit(uint32_t s) {
  return (float)(s & 0x00FFFFFFu) * INV_2_24;
}

// One draw; the state advances only where `adv` (rnd_masked).
__device__ __forceinline__ float rnd_masked(uint32_t& s, bool adv) {
  const uint32_t n = lcg_next(s);
  if (adv) s = n;
  return lcg_unit(n);
}

__device__ __forceinline__ uint32_t tea4(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
  for (int k = 0; k < 4; ++k) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__global__ void seed_stats(const int* __restrict__ stats_in,
                           int* __restrict__ stats_out) {
  stats_out[0] = stats_in[0];
  stats_out[1] = 0;
  stats_out[2] = 0;
  stats_out[3] = 0;
}

__global__ void __launch_bounds__(RAY_TILE)
    refill_kernel(const RefillParams p, float* __restrict__ rays,
                  float* __restrict__ misc, float* __restrict__ stash,
                  const int* __restrict__ stats_in, int* __restrict__ stats_out,
                  const Soup soup, const float* __restrict__ attr_t,
                  const float* __restrict__ lights_t,
                  const uint32_t* __restrict__ jump) {
  __shared__ float tile[9 * MAX_CT];
  __shared__ int warp_base[RAY_TILE / 32];
  __shared__ int s_base, s_max_lane, s_live;

  const int lane = blockIdx.x * RAY_TILE + threadIdx.x;
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_max_lane = -1;
    s_live = 0;
  }
  const bool live = (int)blockIdx.x * RAY_TILE < stats_in[1];
  const Ray r = load_ray(rays, lane);
  float m[16];
  {
    const float4* mp = reinterpret_cast<const float4*>(misc + 16 * (size_t)lane);
    for (int q = 0; q < 4; ++q) {
      const float4 x = mp[q];
      m[4 * q + 0] = x.x;
      m[4 * q + 1] = x.y;
      m[4 * q + 2] = x.z;
      m[4 * q + 3] = x.w;
    }
  }

  // --- closest sweep (the _closest_kernel body) ---
  const ClosestHit h = sweep_closest(soup, tile, r, live);

  // --- unpack the lane state (misc layout, pallas_shade.py:32-36) ---
  uint32_t seed = __float_as_uint(m[0]);
  const float atten[3] = {m[1], m[2], m[3]};
  const float last_at[3] = {m[4], m[5], m[6]};
  const float prev_delta = m[7];
  const float depth = m[8];
  const bool alive = m[9] > 0.0f;
  const float acc[3] = {m[10], m[11], m[12]};
  const float emit_gate = (depth == 0.0f || prev_delta > 0.0f) ? 1.0f : 0.0f;
  const bool is_hit = h.prim >= 0.0f;

  // --- attribute fetch: rows n0 n1 n2 emission diffuse of attr_t[16, F] ---
  const float* a = attr_t + (int)fmaxf(h.prim, 0.0f);
  const int as = p.attr_stride;
  const float bu = h.u, bv = h.v;
  const float w0 = 1.0f - bu - bv;
  float ngx = w0 * a[0 * as] + bu * a[3 * as] + bv * a[6 * as];
  float ngy = w0 * a[1 * as] + bu * a[4 * as] + bv * a[7 * as];
  float ngz = w0 * a[2 * as] + bu * a[5 * as] + bv * a[8 * as];
  normalize3(ngx, ngy, ngz);
  const float side =
      (-(r.dx * ngx + r.dy * ngy + r.dz * ngz) >= 0.0f) ? 1.0f : -1.0f;
  const float nsx = ngx * side, nsy = ngy * side, nsz = ngz * side;
  const float px = r.ox + h.t * r.dx;
  const float py = r.oy + h.t * r.dy;
  const float pz = r.oz + h.t * r.dz;
  const float hit_f = is_hit ? 1.0f : 0.0f;
  float emitted[3], albedo[3];
  for (int c = 0; c < 3; ++c) {
    emitted[c] = a[(9 + c) * as] * emit_gate * hit_f;
    albedo[c] = a[(12 + c) * as];
  }

  // --- BSDF sample: cosine hemisphere, reference draw order ---
  const bool adv = is_hit && alive;
  rnd_masked(seed, adv);
  rnd_masked(seed, adv);
  const float u1 = rnd_masked(seed, adv);
  const float u2 = rnd_masked(seed, adv);
  const float rad = sqrtf(u1);
  const float phi = TWO_PI * u2;
  const float wx = rad * cosf(phi);
  const float wy = rad * sinf(phi);
  const float wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
  // ONB about ns (shader_common.h:15-48, branch as a select)
  const bool use_x = fabsf(nsx) > fabsf(nsz);
  float bx0 = use_x ? -nsy : 0.0f;
  float by0 = use_x ? nsx : -nsz;
  float bz0 = use_x ? 0.0f : nsy;
  normalize3(bx0, by0, bz0);
  const float txx = by0 * nsz - bz0 * nsy;
  const float txy = bz0 * nsx - bx0 * nsz;
  const float txz = bx0 * nsy - by0 * nsx;
  // reference Lambertian: attenuation = albedo * (1/pi) / (cos/pi)
  const float inv_cos = 1.0f / fmaxf(wz * INV_PI, 1e-12f) * INV_PI;
  const float ndx = wx * txx + wy * bx0 + wz * nsx;
  const float ndy = wx * txy + wy * by0 + wz * nsy;
  const float ndz = wx * txz + wy * bz0 + wz * nsz;

  // --- NEE: uniform light pick, clamped to count - 1 ---
  const float u_pick = rnd_masked(seed, adv);
  const float lu = rnd_masked(seed, adv);
  const float lv = rnd_masked(seed, adv);
  const float lidx = fminf(floorf(u_pick * (float)p.num_lights),
                           (float)(p.num_lights - 1));
  const float* l = lights_t + (int)lidx;
  const int ls = p.light_stride;
  const float su = sqrtf(lu);
  const float b0 = 1.0f - su;
  const float b1 = lv * su;
  const float b2 = 1.0f - b0 - b1;
  const float lpx = b0 * l[0 * ls] + b1 * l[3 * ls] + b2 * l[6 * ls];
  const float lpy = b0 * l[1 * ls] + b1 * l[4 * ls] + b2 * l[7 * ls];
  const float lpz = b0 * l[2 * ls] + b1 * l[5 * ls] + b2 * l[8 * ls];
  const float lvx = lpx - px, lvy = lpy - py, lvz = lpz - pz;
  const float dist2 = lvx * lvx + lvy * lvy + lvz * lvz;
  const float sdist2 = fmaxf(dist2, 1e-20f);
  const float inv_d = 1.0f / sqrtf(sdist2);
  const float ldist = sdist2 * inv_d;
  const float ldx = lvx * inv_d, ldy = lvy * inv_d, ldz = lvz * inv_d;
  const float cos_l =
      fabsf(ldx * l[12 * ls] + ldy * l[13 * ls] + ldz * l[14 * ls]);
  const float omega = cos_l * l[15 * ls] / sdist2;
  const bool degen = (dist2 < 1e-5f) || (omega < 1e-5f);
  float le[3];
  for (int c = 0; c < 3; ++c) le[c] = degen ? 0.0f : l[(9 + c) * ls] * omega;
  const float pdf_light =
      (degen ? 1.0f : 1.0f / fmaxf(omega, 1e-20f)) * p.pick_pdf;
  const float n_dl = nsx * ldx + nsy * ldy + nsz * ldz;
  const bool want_shadow = adv && (n_dl > 0.0f);

  // --- shadow sweep (the _any_kernel body) ---
  const Ray sr{px, py, pz, ldx, ldy, ldz, p.shadow_tmin,
               want_shadow ? ldist - p.shadow_eps : 0.0f};
  const bool occ = sweep_any(soup, tile, sr, live, want_shadow);
  const bool lit = want_shadow && !occ;

  // weight = albedo/pi * powerHeuristic(pdf_light, |n.l|/pi)
  const float pdf_sc = fabsf(n_dl) * INV_PI;
  const float ph = (pdf_light * pdf_light) /
                   fmaxf(pdf_light * pdf_light + pdf_sc * pdf_sc, 1e-20f);
  float contrib[3], new_at[3], new_last[3];
  for (int c = 0; c < 3; ++c) {
    float radiance = lit ? le[c] * albedo[c] * (ph * INV_PI) : 0.0f;
    radiance = is_hit ? radiance : p.bg[c];  // miss: constant background
    contrib[c] = emitted[c] + radiance * last_at[c];
    new_at[c] = adv ? atten[c] * (albedo[c] * inv_cos) : atten[c];
    new_last[c] = alive ? new_at[c] : last_at[c];
  }

  // --- Russian roulette (raygen.cu:62-66): drawn on hit lanes only ---
  const float p_rr = 0.30f * new_at[0] + 0.59f * new_at[1] + 0.11f * new_at[2];
  const float u_rr = rnd_masked(seed, adv);
  const bool survive = adv && (u_rr <= p_rr);
  const float inv_p = 1.0f / fmaxf(p_rr, 1e-12f);
  float accs[3];
  for (int c = 0; c < 3; ++c) {
    new_at[c] = survive ? new_at[c] * inv_p : new_at[c];
    accs[c] = acc[c] + (alive ? contrib[c] : 0.0f);
  }
  const float depth_new = depth + (alive ? 1.0f : 0.0f);
  const bool alive_b = survive && (depth_new < (float)p.max_depth);
  const float pdelta_new = alive ? 0.0f : prev_delta;

  // ==== refill epilogue ====
  const bool deadr = !alive_b;
  float pixf = m[13];
  float sampf = m[14];

  // retire a completed lane into its stash slot if the slot is free
  float st[4];
  {
    const float4 x = reinterpret_cast<const float4*>(stash + 16 * (size_t)lane)[0];
    st[0] = x.x;
    st[1] = x.y;
    st[2] = x.z;
    st[3] = x.w;
  }
  const bool completed = deadr && (pixf >= 0.0f) && (sampf >= (float)p.spp);
  const bool can_stash = completed && (st[0] < 0.0f);
  if (can_stash) {
    st[0] = pixf;
    for (int c = 0; c < 3; ++c) {
      st[1 + c] = accs[c];
      accs[c] = 0.0f;
    }
    pixf = -1.0f;
    sampf = 0.0f;
  }

  // pixel claim: exclusive scan of idle lanes in lane order, one CAS loop
  // per block on the work counter, clamped at n_pix
  const bool idle = deadr && (pixf < 0.0f);
  const unsigned ballot = __ballot_sync(0xffffffffu, idle);
  const int lane_rank = __popc(ballot & ((1u << lid) - 1u));
  if (lid == 0) warp_base[wid] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int w = 0; w < RAY_TILE / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = k;
      k += c;
    }
    int base = atomicAdd(&stats_out[0], 0);
    while (true) {
      const int want = min(base + k, p.n_pix);
      if (want <= base) break;
      const int prev = atomicCAS(&stats_out[0], base, want);
      if (prev == base) break;
      base = prev;
    }
    s_base = base;
  }
  __syncthreads();
  const int rank = warp_base[wid] + lane_rank;
  const float wpixf = (float)s_base + ((float)(rank + 1) - 1.0f);
  const bool take_px = idle && (wpixf < (float)p.n_pix);
  if (take_px) {
    pixf = (float)p.pixel_base +
           fminf(fmaxf(wpixf, 0.0f), (float)(p.n_pix - 1));
    sampf = 0.0f;
  }

  // start the next sample of the lane's pixel
  const bool take = deadr && (pixf >= 0.0f) && (sampf < (float)p.spp);
  const float samp_idx = sampf;
  if (take) sampf = sampf + 1.0f;
  const int npix = (int)fmaxf(pixf, 0.0f);
  uint32_t s_new = tea4((uint32_t)npix, (uint32_t)p.subframe_index);
  if (p.seed_rot) s_new ^= p.seed_rot;
  // per-sample LCG jump: state after 2 jitter draws per earlier sample
  const int si = (samp_idx >= 1.0f && samp_idx < (float)p.spp) ? (int)samp_idx : 0;
  s_new = jump[2 * si] * s_new + jump[2 * si + 1];
  s_new = lcg_next(s_new);
  const float jx = lcg_unit(s_new);
  s_new = lcg_next(s_new);
  const float jy = lcg_unit(s_new);
  const float pxc = (float)(npix % p.width);
  const float pyc = (float)(npix / p.width);
  const float dxc = 2.0f * ((pxc + jx) / p.width_f) - 1.0f;
  const float dyc = 2.0f * ((pyc + jy) / p.height_f) - 1.0f;
  float cdx = dxc * p.cam[3] + dyc * p.cam[6] + p.cam[9];
  float cdy = dxc * p.cam[4] + dyc * p.cam[7] + p.cam[10];
  float cdz = dxc * p.cam[5] + dyc * p.cam[8] + p.cam[11];
  normalize3(cdx, cdy, cdz);

  uint32_t seed_u = take ? s_new : seed;
  const bool alive2 = alive_b || take;
  // the per-ray time draw of the motion path: advances every live lane
  if (alive2) seed_u = lcg_next(seed_u);

  // --- write the lane back in place ---
  {
    float4* rp = reinterpret_cast<float4*>(rays + 8 * (size_t)lane);
    rp[0] = make_float4(take ? p.cam[0] : (survive ? px : r.ox),
                        take ? p.cam[1] : (survive ? py : r.oy),
                        take ? p.cam[2] : (survive ? pz : r.oz),
                        take ? cdx : (survive ? ndx : r.dx));
    rp[1] = make_float4(take ? cdy : (survive ? ndy : r.dy),
                        take ? cdz : (survive ? ndz : r.dz), p.tmin, p.tmax);
    float4* mp = reinterpret_cast<float4*>(misc + 16 * (size_t)lane);
    mp[0] = make_float4(__uint_as_float(seed_u), take ? 1.0f : new_at[0],
                        take ? 1.0f : new_at[1], take ? 1.0f : new_at[2]);
    mp[1] = make_float4(take ? 1.0f : new_last[0], take ? 1.0f : new_last[1],
                        take ? 1.0f : new_last[2], take ? 0.0f : pdelta_new);
    mp[2] = make_float4(take ? 0.0f : depth_new, alive2 ? 1.0f : 0.0f,
                        accs[0], accs[1]);
    mp[3] = make_float4(accs[2], pixf, sampf, want_shadow ? 1.0f : 0.0f);
    float4* sp = reinterpret_cast<float4*>(stash + 16 * (size_t)lane);
    sp[0] = make_float4(st[0], st[1], st[2], st[3]);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sp[1] = z;
    sp[2] = z;
    sp[3] = z;
  }

  // --- launch stats: count_hint = last live lane + 1, n_live ---
  const unsigned live_mask = __ballot_sync(0xffffffffu, alive2);
  if (lid == 0 && live_mask) {
    atomicMax(&s_max_lane, wid * 32 + 31 - __clz(live_mask));
    atomicAdd(&s_live, __popc(live_mask));
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_max_lane >= 0) {
    atomicMax(&stats_out[1], (int)blockIdx.x * RAY_TILE + s_max_lane + 1);
    atomicAdd(&stats_out[2], s_live);
  }
}

}  // namespace rt3c

extern "C" int rt3c_trace_shade_refill(
    int device, const rt3c::RefillParams* p, float* rays, float* misc,
    float* stash, int n_lanes, const int* stats_in, int* stats_out,
    const float* tris, const float* aabb, const float* super_aabb,
    const float* attr_t, const float* lights_t, const unsigned int* jump,
    void* stream) {
  if (n_lanes <= 0 || n_lanes % rt3c::RAY_TILE != 0 || p->ct > rt3c::MAX_CT ||
      p->n_tiles < 1 || p->num_lights < 1 || p->spp < 1 || p->width < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rt3c::seed_stats<<<1, 1, 0, s>>>(stats_in, stats_out);
  const rt3c::Soup soup{tris, aabb, super_aabb, p->n_tiles, p->ct};
  rt3c::refill_kernel<<<n_lanes / rt3c::RAY_TILE, rt3c::RAY_TILE, 0, s>>>(
      *p, rays, misc, stash, stats_in, stats_out, soup, attr_t, lights_t,
      jump);
  return (int)cudaGetLastError();
}
