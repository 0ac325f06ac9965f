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
//
// kTextured adds the texture work of the same body (:459-535): the uv
// interpolation, the per-material uv transform, a tangent-space normal map
// and the diffuse texture, each fetched by `tex_fetch` (the TPU's _tex_fetch,
// :225-268, a one-hot matmul over the whole atlas, becomes four indexed
// 4-byte loads of the RGBA8 atlas). The uv transform and the normal map are
// launch-uniform switches of the textured variant; untextured scenes keep
// the body without any of it.
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

__device__ __forceinline__ void normalize3(float& x, float& y, float& z,
                                           float eps = 1e-20f) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, eps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// The texture atlas of a textured launch; mirrored field for field by
// kernels/build.py. texels: the RGBA8 atlas [AH * AW], byte 0 red; meta
// [T, 6] int: y0 x0 height width wrap_s wrap_t (scene/texture.py).
struct TexParams {
  const uint32_t* texels;
  const int* meta;
  int aw, uv_xform, normal_maps, nmap_base;
};

// jnp.mod on floats: the C remainder moved into y's sign (exact).
__device__ __forceinline__ float fmod_floored(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

// One axis of the bilinear footprint (pallas_shade.py _wrap_axis, :211-222,
// the float arithmetic of scene/texture.py _wrap_footprint): the base texel
// i0, its +1 neighbour i1 under the address mode (0 repeat, 1 clamp, 2
// mirror; the quad table's rule) and the fraction.
__device__ __forceinline__ void wrap_axis(float c, int size, int mode,
                                          int& i0, int& i1, float& frac) {
  const float size_f = (float)size;
  const float cm =
      mode == 2 ? 1.0f - fabsf(fmod_floored(c, 2.0f) - 1.0f) : c;
  const bool repeat = mode == 0;
  const float cc = repeat ? cm - floorf(cm) : cm;
  float sc = cc * size_f - 0.5f;
  if (!repeat) sc = fminf(fmaxf(sc, 0.0f), size_f - 1.0f);
  const float i0f = floorf(sc);
  frac = sc - i0f;
  i0 = (int)i0f;
  if (repeat) {
    i0 %= size;  // i0 >= -1 here
    if (i0 < 0) i0 += size;
    i1 = i0 + 1 == size ? 0 : i0 + 1;
  } else {
    i0 = min(max(i0, 0), size - 1);  // in range already for finite c
    i1 = min(i0 + 1, size - 1);
  }
}

__device__ __forceinline__ float texel(uint32_t rgba, int c) {
  return (float)((rgba >> (8 * c)) & 0xFFu) * (1.0f / 255.0f);
}

// The wrap-mode bilinear fetch of texture `tid` at (u, v): rgb in out[3],
// black where tid < 0 (scene/texture.py sample_texture_bilinear; combine
// order q00 (1-fu)(1-fv) + q01 fu (1-fv) + q10 (1-fu) fv + q11 fu fv).
__device__ __forceinline__ void tex_fetch(const TexParams& tex, float tid,
                                          float u, float v, float* out) {
  if (!(tid >= 0.0f)) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const int* mt = tex.meta + 6 * (int)tid;
  int iu0, iu1, iv0, iv1;
  float fu, fv;
  wrap_axis(u, mt[3], mt[4], iu0, iu1, fu);
  wrap_axis(v, mt[2], mt[5], iv0, iv1, fv);
  const uint32_t* row0 = tex.texels + (size_t)(mt[0] + iv0) * tex.aw + mt[1];
  const uint32_t* row1 = tex.texels + (size_t)(mt[0] + iv1) * tex.aw + mt[1];
  const uint32_t q00 = row0[iu0], q01 = row0[iu1];
  const uint32_t q10 = row1[iu0], q11 = row1[iu1];
  const float ifu = 1.0f - fu, ifv = 1.0f - fv;
  for (int c = 0; c < 3; ++c)
    out[c] = texel(q00, c) * ifu * ifv + texel(q01, c) * fu * ifv +
             texel(q10, c) * ifu * fv + texel(q11, c) * fu * fv;
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
// lane's attribute row (n0 n1 n2 emission diffuse, and for kTextured uv0
// uv1 uv2 in fields 16-21, the diffuse texture id in 22, the uv transform in
// 23-28 and the raw tangent and normal texture id at tex.nmap_base) read at
// a[field * as]; lights_t [24, light_stride]. occluded(shadow_ray, want,
// time) runs the shadow sweep and must be reached by every thread of the
// block (K4, K5).
template <bool kExternal, bool kTextured, class Occluded>
__device__ __forceinline__ Shaded shade_lane(const ShadeConsts& p,
                                             const Ray& r, const ClosestHit& h,
                                             const float* m, const float* a,
                                             int as, const float* lights_t,
                                             const TexParams& tex,
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
  float tex_rgb[3] = {0.0f, 0.0f, 0.0f};
  float tid = -1.0f;
  if constexpr (kTextured) {
    tid = a[22 * as];
    float tu = w0 * a[16 * as] + bu * a[18 * as] + bv * a[20 * as];
    float tv = w0 * a[17 * as] + bu * a[19 * as] + bv * a[21 * as];
    if (tex.uv_xform) {
      // uv' = M uv + o in the reference's operation order (:464-469)
      const float tu2 = a[23 * as] * tu + a[24 * as] * tv + a[27 * as];
      const float tv2 = a[25 * as] * tu + a[26 * as] * tv + a[28 * as];
      tu = tu2;
      tv = tv2;
    }
    if (tex.normal_maps) {
      // tangent-space normal map on the interpolated normal, before the
      // faceforward (:470-518): Gram-Schmidt of the baked raw tangent
      // against ng, n = T t + B b + N n_ts
      const float* nm = a + tex.nmap_base * as;
      const float ntex = nm[3 * as];
      float n_rgb[3];
      tex_fetch(tex, ntex, tu, tv, n_rgb);
      const float ntsx = n_rgb[0] * 2.0f - 1.0f;
      const float ntsy = n_rgb[1] * 2.0f - 1.0f;
      const float ntsz = n_rgb[2] * 2.0f - 1.0f;
      float tgx = nm[0], tgy = nm[as], tgz = nm[2 * as];
      const float d_tn = tgx * ngx + tgy * ngy + tgz * ngz;
      tgx = tgx - ngx * d_tn;
      tgy = tgy - ngy * d_tn;
      tgz = tgz - ngz * d_tn;
      normalize3(tgx, tgy, tgz, 1e-12f);
      const float btx = ngy * tgz - ngz * tgy;
      const float bty = ngz * tgx - ngx * tgz;
      const float btz = ngx * tgy - ngy * tgx;
      float mgx = ntsx * tgx + ntsy * btx + ntsz * ngx;
      float mgy = ntsx * tgy + ntsy * bty + ntsz * ngy;
      float mgz = ntsx * tgz + ntsy * btz + ntsz * ngz;
      normalize3(mgx, mgy, mgz, 1e-12f);
      if (ntex >= 0.0f) {
        ngx = mgx;
        ngy = mgy;
        ngz = mgz;
      }
    }
    tex_fetch(tex, tid, tu, tv, tex_rgb);
  }
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
    albedo[c] = (kTextured && tid >= 0.0f) ? tex_rgb[c] : a[(12 + c) * as];
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
