// The shading body shared by the refill megakernel K4 (megakernel.cu) and
// the external shade kernel K6 (external.cu): one lane, from the attribute
// fetch to the next path state.
//
// Replaces the body of rendertoy3c_tpu/trace/pallas_shade.py
// _make_shade_kernel (:436-880) for the Lambertian, uniform-light branch:
// emission at depth 0, the miss ambient, the cosine-hemisphere draw, the
// NEE light pick and area sample, the shadow ray, Russian roulette and the
// next state. K4 and K5 sweep the shadow ray in place (`occluded`); K6
// (kExternal) hands it out, with NEE provisional on want_shadow
// (pallas_shade.py :751-773, :844-850). The shadow ray's time is a peek of
// the post-NEE stream that does not advance the seed (:756-760): K6 hands it
// out, the motion variants of K4 and K5 sweep at it.
#pragma once

#include "mt.cuh"

namespace rt3c {

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

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Launch constants of the shading body.
struct ShadeConsts {
  int max_depth, num_lights, light_stride;
  float shadow_tmin, shadow_eps, pick_pdf;
  float bg[3];
};

// What one lane's shading produces.
struct Shaded {
  uint32_t seed;               // after the RR draw
  float px, py, pz;            // hit point
  float ndx, ndy, ndz;         // sampled bounce direction
  float new_at[3], new_last[3], accs[3];
  float nee[3];                // kExternal: pending NEE term, else 0
  float pdelta_new, depth_new;
  bool survive, alive_b, want_shadow;
  Ray sr;                      // the shadow ray (tmax 0 without one)
  float occl_time;             // the shadow ray's time (a peek)
};

// r: the lane's ray; h: its closest hit; m: misc columns 0-15; a: the
// lane's attribute row (n0 n1 n2 emission diffuse) read at a[field * as];
// lights_t [24, light_stride]. occluded(shadow_ray, want, time) runs the
// shadow sweep and must be reached by every thread of the block (K4, K5).
template <bool kExternal, class Occluded>
__device__ __forceinline__ Shaded shade_lane(const ShadeConsts& p,
                                             const Ray& r, const ClosestHit& h,
                                             const float* m, const float* a,
                                             int as, const float* lights_t,
                                             Occluded occluded) {
  Shaded o;
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

  // --- shading attributes: rows n0 n1 n2 emission diffuse ---
  const float bu = h.u, bv = h.v;
  const float w0 = 1.0f - bu - bv;
  float ngx = w0 * a[0 * as] + bu * a[3 * as] + bv * a[6 * as];
  float ngy = w0 * a[1 * as] + bu * a[4 * as] + bv * a[7 * as];
  float ngz = w0 * a[2 * as] + bu * a[5 * as] + bv * a[8 * as];
  normalize3(ngx, ngy, ngz);
  const float side =
      (-(r.dx * ngx + r.dy * ngy + r.dz * ngz) >= 0.0f) ? 1.0f : -1.0f;
  const float nsx = ngx * side, nsy = ngy * side, nsz = ngz * side;
  o.px = r.ox + h.t * r.dx;
  o.py = r.oy + h.t * r.dy;
  o.pz = r.oz + h.t * r.dz;
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
  o.ndx = wx * txx + wy * bx0 + wz * nsx;
  o.ndy = wx * txy + wy * by0 + wz * nsy;
  o.ndz = wx * txz + wy * bz0 + wz * nsz;

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
  const float lvx = lpx - o.px, lvy = lpy - o.py, lvz = lpz - o.pz;
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
  o.want_shadow = adv && (n_dl > 0.0f);

  // --- the shadow ray: swept here (K4) or handed out (K6) ---
  o.sr = Ray{o.px, o.py, o.pz, ldx, ldy, ldz, p.shadow_tmin,
             o.want_shadow ? ldist - p.shadow_eps : 0.0f};
  o.occl_time = lcg_unit(lcg_next(seed));  // a peek: seed stays
  bool lit;
  if (kExternal) {
    lit = o.want_shadow;
  } else {
    // called on every thread, outside any short circuit: the sweep's cull
    // votes are block barriers
    const bool occ = occluded(o.sr, o.want_shadow, o.occl_time);
    lit = o.want_shadow && !occ;
  }

  // weight = albedo/pi * powerHeuristic(pdf_light, |n.l|/pi)
  const float pdf_sc = fabsf(n_dl) * INV_PI;
  const float ph = (pdf_light * pdf_light) /
                   fmaxf(pdf_light * pdf_light + pdf_sc * pdf_sc, 1e-20f);
  float contrib[3];
  for (int c = 0; c < 3; ++c) {
    float radiance = lit ? le[c] * albedo[c] * (ph * INV_PI) : 0.0f;
    if (kExternal) {
      // provisional NEE leaves for the caller; the accumulator takes
      // emission and the miss background only
      o.nee[c] = radiance * last_at[c];
      radiance = 0.0f;
    } else {
      o.nee[c] = 0.0f;
    }
    radiance = is_hit ? radiance : p.bg[c];  // miss: constant background
    contrib[c] = emitted[c] + radiance * last_at[c];
    o.new_at[c] = adv ? atten[c] * (albedo[c] * inv_cos) : atten[c];
    o.new_last[c] = alive ? o.new_at[c] : last_at[c];
  }

  // --- Russian roulette (raygen.cu:62-66): drawn on hit lanes only ---
  const float p_rr =
      0.30f * o.new_at[0] + 0.59f * o.new_at[1] + 0.11f * o.new_at[2];
  const float u_rr = rnd_masked(seed, adv);
  o.survive = adv && (u_rr <= p_rr);
  const float inv_p = 1.0f / fmaxf(p_rr, 1e-12f);
  for (int c = 0; c < 3; ++c) {
    o.new_at[c] = o.survive ? o.new_at[c] * inv_p : o.new_at[c];
    o.accs[c] = acc[c] + (alive ? contrib[c] : 0.0f);
  }
  o.depth_new = depth + (alive ? 1.0f : 0.0f);
  o.alive_b = o.survive && (o.depth_new < (float)p.max_depth);
  o.pdelta_new = alive ? 0.0f : prev_delta;
  o.seed = seed;
  return o;
}

}  // namespace rt3c
