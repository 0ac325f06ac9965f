// The shading body shared by the refill megakernel K4 (megakernel.cu) and
// the external shade kernel K6 (external.cu): one lane, from the attribute
// fetch to the next path state.
//
// Replaces the body of rendertoy3c_tpu/trace/pallas_shade.py
// _make_shade_kernel (:436-880): emission at depth 0 and after delta lobes,
// the miss ambient, the cosine-hemisphere draw (or the material dispatch),
// the NEE light pick and area sample, the shadow ray, Russian roulette and
// the next state. K4 and K5 sweep the shadow ray in place (`occluded`); K6
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
//
// kDispatch is the four-type material dispatch (:563-700; its NEE half
// :748-749 and :826-843): DIFFUSE, the SPECULAR mirror, the
// FRESNEL_TRANSMISSIVE dielectric (exact Fresnel, total internal
// reflection) and the PRINCIPLED one-sample mix of a Lambertian base and a
// GGX / Smith / Schlick lobe with sheen, whose eval (`prin_eval`) runs
// twice per lane (the sampled direction and the NEE direction). It reads 6
// material-parameter rows at `params_base` and is a template switch so
// that all-diffuse scenes keep the Lambertian body and its registers. The
// power light pick (:710-720, :742-745) is a launch-uniform flag: an
// upper-bound search over the f32 CDF in light row 17, equal to the
// reference's compare-sum for a nondecreasing CDF (ties from zero-power
// lights included), with the pick pdf from light row 16.
//
// An instanced lane of K6 (`InstRows` on, trace-time instancing) carries
// its hit instance's 18 transform rows: rows 0-8 the inverse-transpose that
// moves the interpolated object-space normal to world space before its
// second normalisation (pallas_shade.py :447-457), rows 9-17 the forward
// linear part that moves a normal map's raw tangent (:487-501); the
// identity where the lane hit no instance. K4 and K5 pass it off, and the
// compiler drops the branch from them.
//
// The AOV variants of the kernels (kAov, pallas_shade.py :881-893) read the
// lane's albedo (the texel where a texture is present) and its
// face-forwarded shading normal (after any normal map) from `Shaded`, with
// `first` = a live lane that hit at depth 0; the instantiations without AOV
// leave those fields unread, and the compiler drops them.
#pragma once

#include "mt.cuh"

namespace rt3c {

constexpr double PI_D = 3.14159265358979323846;
constexpr float PI_F = (float)PI_D;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float E7 = 1e-7f;  // the dispatch body's guard against zero
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

// Launch constants of the shading body. power: the power light pick;
// params_base: the first material-parameter row (kDispatch).
struct ShadeConsts {
  int max_depth, num_lights, light_stride, power, params_base;
  float shadow_tmin, shadow_eps, pick_pdf;
  float bg[3];
};

// One lane's material under kDispatch (pallas_shade.py :565-594).
struct Mat {
  bool is_spec, is_glass, is_prin, is_diff;
  float albedo[3], f0[3];
  float metal, ior, transm, sheen, a2, p_spec;
};

__device__ __forceinline__ float schlick5(float c) {
  return (c * c) * (c * c) * c;
}

__device__ __forceinline__ float smith_g1(float cos_v, float a2) {
  const float c2 = fminf(fmaxf(cos_v * cos_v, 1e-12f), 1.0f);
  return 2.0f / (1.0f + sqrtf(1.0f + a2 * (1.0f - c2) / c2));
}

// f (rgb, out) and pdf of the principled lobe pair at local wo, wi, both 0
// below the surface (prin_eval, :600-635).
__device__ __forceinline__ float prin_eval(const Mat& m, float wox, float woy,
                                           float woz, float wix, float wiy,
                                           float wiz, float* f) {
  const float cos_i = wiz;
  const bool valid = (cos_i > E7) && (woz > E7);
  float hx = wox + wix, hy = woy + wiy, hz = woz + wiz;
  normalize3(hx, hy, hz, 1e-20f);
  const float cos_h = hz;
  const float cos_oh = wox * hx + woy * hy + woz * hz;
  const float denom = cos_h * cos_h * (m.a2 - 1.0f) + 1.0f;
  const float d_g = m.a2 / fmaxf(PI_F * denom * denom, 1e-12f);
  const float g_sm = smith_g1(cos_i, m.a2) * smith_g1(woz, m.a2);
  const float spec_s = d_g * g_sm / fmaxf(4.0f * cos_i * woz, 1e-9f);
  const float sw =
      schlick5(fminf(fmaxf(1.0f - fminf(fmaxf(cos_oh, 0.0f), 1.0f), 0.0f),
                     1.0f));
  const float f_sheen =
      m.sheen * schlick5(fminf(fmaxf(1.0f - cos_oh, 0.0f), 1.0f));
  for (int c = 0; c < 3; ++c)
    f[c] = valid ? m.albedo[c] * ((1.0f - m.metal) * INV_PI) +
                       (m.f0[c] + (1.0f - m.f0[c]) * sw) * spec_s + f_sheen
                 : 0.0f;
  const float pdf_spec =
      d_g * fmaxf(cos_h, 0.0f) / fmaxf(4.0f * fabsf(cos_oh), 1e-12f);
  return valid ? m.p_spec * pdf_spec +
                     (1.0f - m.p_spec) * fmaxf(cos_i, 0.0f) * INV_PI
               : 0.0f;
}

template <class T>
__device__ __forceinline__ T pick4(const Mat& m, T spec_v, T glass_v, T prin_v,
                                   T diff_v) {
  return m.is_spec ? spec_v
                   : (m.is_glass ? glass_v : (m.is_prin ? prin_v : diff_v));
}

// An instanced lane's transform rows (see the note at the top).
struct InstRows {
  bool on;
  float m[18];  // 0-8 inverse-transpose, 9-17 forward linear, row-major
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
  bool first;                  // a live lane that hit at depth 0
  float albedo[3], ns[3];      // the AOV rows' albedo and shading normal
};

// r: the lane's ray; h: its closest hit; m: misc columns 0-15; a: the
// lane's attribute row (n0 n1 n2 emission diffuse, and for kTextured uv0
// uv1 uv2 in fields 16-21, the diffuse texture id in 22, the uv transform in
// 23-28 and the raw tangent and normal texture id at tex.nmap_base; for
// kDispatch mtype roughness metallic ior transmittance sheen at
// p.params_base) read at a[field * as]; lights_t [24, light_stride], row 16
// the pick pdf and row 17 the CDF of the power pick. occluded(shadow_ray,
// want, time) runs the shadow sweep and must be reached by every thread of
// the block (K4, K5). inst: an instanced lane's transform rows (K6).
template <bool kExternal, bool kTextured, bool kDispatch, class Occluded>
__device__ __forceinline__ Shaded shade_lane(const ShadeConsts& p,
                                             const Ray& r, const ClosestHit& h,
                                             const float* m, const float* a,
                                             int as, const float* lights_t,
                                             const TexParams& tex,
                                             Occluded occluded,
                                             const InstRows& inst = {}) {
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
  if (inst.on) {
    const float* it = inst.m;
    const float nx2 = it[0] * ngx + it[1] * ngy + it[2] * ngz;
    const float ny2 = it[3] * ngx + it[4] * ngy + it[5] * ngz;
    const float nz2 = it[6] * ngx + it[7] * ngy + it[8] * ngz;
    ngx = nx2;
    ngy = ny2;
    ngz = nz2;
    normalize3(ngx, ngy, ngz);
  }
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
      if (inst.on) {
        const float* it = inst.m;
        const float tx2 = it[9] * tgx + it[10] * tgy + it[11] * tgz;
        const float ty2 = it[12] * tgx + it[13] * tgy + it[14] * tgz;
        const float tz2 = it[15] * tgx + it[16] * tgy + it[17] * tgz;
        tgx = tx2;
        tgy = ty2;
        tgz = tz2;
      }
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
  o.ns[0] = nsx;
  o.ns[1] = nsy;
  o.ns[2] = nsz;
  o.px = r.ox + h.t * r.dx;
  o.py = r.oy + h.t * r.dy;
  o.pz = r.oz + h.t * r.dz;
  const float hit_f = is_hit ? 1.0f : 0.0f;
  float emitted[3], albedo[3];
  for (int c = 0; c < 3; ++c) {
    emitted[c] = a[(9 + c) * as] * emit_gate * hit_f;
    albedo[c] = (kTextured && tid >= 0.0f) ? tex_rgb[c] : a[(12 + c) * as];
    o.albedo[c] = albedo[c];
  }

  // --- BSDF sample: cosine hemisphere, reference draw order ---
  const bool adv = is_hit && alive;
  o.first = adv && depth == 0.0f;
  const float z1 = rnd_masked(seed, adv);  // the dispatch's lobe choice
  rnd_masked(seed, adv);
  const float u1 = rnd_masked(seed, adv);
  const float u2 = rnd_masked(seed, adv);
  const float rad = sqrtf(u1);
  const float phi = TWO_PI * u2;
  float wx = rad * cosf(phi);
  float wy = rad * sinf(phi);
  float wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
  // ONB about ns (shader_common.h:15-48, branch as a select)
  const bool use_x = fabsf(nsx) > fabsf(nsz);
  float bx0 = use_x ? -nsy : 0.0f;
  float by0 = use_x ? nsx : -nsz;
  float bz0 = use_x ? 0.0f : nsy;
  normalize3(bx0, by0, bz0);
  const float txx = by0 * nsz - bz0 * nsy;
  const float txy = bz0 * nsx - bx0 * nsz;
  const float txz = bx0 * nsy - by0 * nsx;
  float at_fac[3];
  Mat mat;
  float wox = 0.0f, woy = 0.0f, woz = 0.0f;
  if constexpr (kDispatch) {
    // --- the four-type dispatch (:564-700), wo = -d in the local frame ---
    const float* mp = a + p.params_base * as;
    const float mt_r = mp[0];
    const float rough = mp[as];
    mat.metal = mp[2 * as];
    mat.ior = mp[3 * as];
    mat.transm = mp[4 * as];
    mat.sheen = mp[5 * as];
    mat.is_spec = mt_r == 1.0f;
    mat.is_glass = mt_r == 2.0f;
    mat.is_prin = mt_r == 3.0f;
    mat.is_diff = !(mat.is_spec || mat.is_glass || mat.is_prin);
    wox = -(r.dx * txx + r.dy * txy + r.dz * txz);
    woy = -(r.dx * bx0 + r.dy * by0 + r.dz * bz0);
    woz = -(r.dx * nsx + r.dy * nsy + r.dz * nsz);
    const float cos_o = fmaxf(woz, E7);
    const float alpha = fmaxf(rough * rough, 1e-4f);
    mat.a2 = alpha * alpha;
    const float r0 = (mat.ior - 1.0f) / (mat.ior + 1.0f);
    const float f0d = r0 * r0;
    for (int c = 0; c < 3; ++c) {
      mat.albedo[c] = albedo[c];
      mat.f0[c] = f0d * (1.0f - mat.metal) + albedo[c] * mat.metal;
    }
    const float spec_w =
        0.30f * mat.f0[0] + 0.59f * mat.f0[1] + 0.11f * mat.f0[2];
    const float diff_w =
        (0.30f * albedo[0] + 0.59f * albedo[1] + 0.11f * albedo[2]) *
        (1.0f - mat.metal);
    mat.p_spec =
        fminf(fmaxf(spec_w / fmaxf(spec_w + diff_w, 1e-9f), 0.05f), 0.98f);

    // FRESNEL_TRANSMISSIVE: the exact dielectric Fresnel at cos_o
    const float ior = mat.ior;
    const float cos_ci = fminf(fmaxf(cos_o, 0.0f), 1.0f);
    const float sin2_t = (1.0f - cos_ci * cos_ci) / fmaxf(ior * ior, 1e-12f);
    const bool tir = sin2_t >= 1.0f;
    const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
    const float r_par =
        (ior * cos_ci - cos_t) / fmaxf(ior * cos_ci + cos_t, 1e-12f);
    const float r_perp =
        (cos_ci - ior * cos_t) / fmaxf(cos_ci + ior * cos_t, 1e-12f);
    const float f_diel =
        tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
    const float eta = 1.0f / ior;
    const float sin2_r = eta * eta * fmaxf(1.0f - cos_o * cos_o, 0.0f);
    const float cos_rt = sqrtf(fmaxf(1.0f - sin2_r, 0.0f));
    const bool choose_refl = z1 < f_diel;
    const float gl_x = choose_refl ? -wox : -eta * wox;
    const float gl_y = choose_refl ? -woy : -eta * woy;
    const float gl_z = choose_refl ? woz : -cos_rt;

    // PRINCIPLED: the one-sample mix (sample_ggx_half on u1, u2)
    const float phi_g = TWO_PI * u1;
    const float den_g = 1.0f + (mat.a2 - 1.0f) * u2;
    const float cos_hg =
        sqrtf(fminf(fmaxf((1.0f - u2) / fmaxf(den_g, 1e-12f), 0.0f), 1.0f));
    const float sin_hg = sqrtf(fmaxf(1.0f - cos_hg * cos_hg, 0.0f));
    const float hgx = sin_hg * cosf(phi_g);
    const float hgy = sin_hg * sinf(phi_g);
    const float hgz = cos_hg;
    const float cos_ohg = wox * hgx + woy * hgy + woz * hgz;
    const bool take_spec = z1 < mat.p_spec;
    const float pr_x = take_spec ? 2.0f * cos_ohg * hgx - wox : wx;
    const float pr_y = take_spec ? 2.0f * cos_ohg * hgy - woy : wy;
    const float pr_z = take_spec ? 2.0f * cos_ohg * hgz - woz : wz;
    float f_pr[3];
    const float pdf_pr = prin_eval(mat, wox, woy, woz, pr_x, pr_y, pr_z, f_pr);
    // cos / pdf first, as XLA orders it
    const float w_scale = fmaxf(pr_z, 0.0f) / fmaxf(pdf_pr, E7);
    for (int c = 0; c < 3; ++c) {
      const float w_glass =
          choose_refl ? 1.0f : albedo[c] * mat.transm + (1.0f - mat.transm);
      const float w_prin = pdf_pr > E7 ? f_pr[c] * w_scale : 0.0f;
      at_fac[c] = pick4(mat, albedo[c], w_glass, w_prin, albedo[c]);
    }
    const float wix = pick4(mat, -wox, gl_x, pr_x, wx);
    const float wiy = pick4(mat, -woy, gl_y, pr_y, wy);
    const float wiz = pick4(mat, woz, gl_z, pr_z, wz);
    wx = wix;
    wy = wiy;
    wz = wiz;
  } else {
    // reference Lambertian: attenuation = albedo * (1/pi) / (cos/pi)
    const float inv_cos = 1.0f / fmaxf(wz * INV_PI, 1e-12f) * INV_PI;
    for (int c = 0; c < 3; ++c) at_fac[c] = albedo[c] * inv_cos;
  }
  o.ndx = wx * txx + wy * bx0 + wz * nsx;
  o.ndy = wx * txy + wy * by0 + wz * nsy;
  o.ndz = wx * txz + wy * bz0 + wz * nsz;

  // --- NEE: uniform or power light pick, clamped to count - 1 ---
  const float u_pick = rnd_masked(seed, adv);
  const float lu = rnd_masked(seed, adv);
  const float lv = rnd_masked(seed, adv);
  const int ls = p.light_stride;
  int lidx;
  if (p.power) {
    // searchsorted(cdf, u, right): the first entry above u
    const float* cdf = lights_t + 17 * ls;
    int lo = 0, hi = p.num_lights;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= u_pick)
        lo = mid + 1;
      else
        hi = mid;
    }
    lidx = min(lo, p.num_lights - 1);
  } else {
    lidx = (int)fminf(floorf(u_pick * (float)p.num_lights),
                      (float)(p.num_lights - 1));
  }
  const float* l = lights_t + lidx;
  const float pick_pdf = p.power ? l[16 * ls] : p.pick_pdf;
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
      (degen ? 1.0f : 1.0f / fmaxf(omega, 1e-20f)) * pick_pdf;
  const float n_dl = nsx * ldx + nsy * ldy + nsz * ldz;
  bool is_delta = false;
  if constexpr (kDispatch) is_delta = mat.is_spec || mat.is_glass;
  o.want_shadow = adv && (n_dl > 0.0f) && !is_delta;  // no NEE on deltas

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

  float nee_w[3];
  if constexpr (kDispatch) {
    // the general NEE, Le omega f(wo, wl) n.l / pick_pdf, no MIS
    const float wlx = ldx * txx + ldy * txy + ldz * txz;
    const float wly = ldx * bx0 + ldy * by0 + ldz * bz0;
    const float wlz = ldx * nsx + ldy * nsy + ldz * nsz;
    float f_l[3];
    prin_eval(mat, wox, woy, woz, wlx, wly, wlz, f_l);
    const float scale = n_dl / fmaxf(pick_pdf, 1e-12f);
    for (int c = 0; c < 3; ++c) {
      const float f_ev =
          mat.is_prin ? f_l[c] : (mat.is_diff ? albedo[c] * INV_PI : 0.0f);
      nee_w[c] = lit ? le[c] * f_ev * scale : 0.0f;
    }
  } else {
    // weight = albedo/pi * powerHeuristic(pdf_light, |n.l|/pi)
    const float pdf_sc = fabsf(n_dl) * INV_PI;
    const float ph = (pdf_light * pdf_light) /
                     fmaxf(pdf_light * pdf_light + pdf_sc * pdf_sc, 1e-20f);
    for (int c = 0; c < 3; ++c)
      nee_w[c] = lit ? le[c] * albedo[c] * (ph * INV_PI) : 0.0f;
  }
  float contrib[3];
  for (int c = 0; c < 3; ++c) {
    float radiance = nee_w[c];
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
    o.new_at[c] = adv ? atten[c] * at_fac[c] : atten[c];
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
  o.pdelta_new = alive ? (is_delta ? 1.0f : 0.0f) : prev_delta;
  o.seed = seed;
  return o;
}

}  // namespace rt3c
