// K6: the external shade kernel, the shading body of K4 with no trace.
//
// Replaces rendertoy3c_tpu/trace/pallas_shade.py make_external_shader.shade
// (:1678-1817, pallas_call at :1778), which is _make_shade_kernel(
// external=True) (:271), with or without instance rows (inst_base, :447-501,
// :1747-1759), with misc
// row-major or C-major (transposed=True, the walk pool's layout,
// pallas_shade.py:1761-1820), with and without motion, untextured or
// textured,
// all-diffuse or with the material dispatch (kDispatch: 6 more attribute
// rows at params_base), without or with the first-hit AOV rows (kAov, a
// template switch as in K4), with the uniform or the power light pick.
//
// In: rays [R, 8], the closest hit hit4 [R, 4] (t, prim, u, v, traced
// outside by K1 or K3), misc [R, MW] (MW = 16, or 24 with AOV), the
// attribute table attr [F, W] (W = 16, or 24-40 rows of build_shade_tables
// for a textured scene) and lights_t [24, Lp]. Out: rays_out [R, 8] (the
// bounce ray on surviving lanes, tmin/tmax passed on), misc_out [R, MW + 8]
// (the next state in columns 0-15, with AOV the albedo and normal accs in
// 16-21 and zeros in 22-23 (pallas_shade.py :881-918), the pending NEE term
// in columns MW to MW + 2, zeros after), and the shadow rays
// shadow [R, 8] (org, dir, tmin, tmax), [R, 16] for motion with the ray's
// time in column 8. The caller traces the shadow rays (K2 or K3) and adds
// the NEE term on unoccluded lanes. With p.transposed, misc is C-major
// [MW, R] and misc_out [MW + 8, R] (the walk pool traces and gates the
// shadow rays in its own rounds, K9); rays, hits and shadow rays stay
// row-major.
//
// The layout is a runtime stride, not a template switch: C-major is the
// coalesced layout on a GPU (lane i reads misc[c * R + i], a warp 128
// contiguous bytes per column), row-major reads MW * 4 contiguous bytes
// per lane as float4s; both are one uniform branch around the loads and
// the stores, so the 8 instantiations (and nvcc's time) stay as they were.
//
// Instance rows (p.n_inst > 0, a trace-time instanced scene): the lane reads
// its hit's instance id from inst_ids [R] and that instance's 18 rows from
// inst_rows [I, 18] (the identity where the id is -1) and shade_lane moves
// the normal, and a normal map's tangent, to world space, so the AOV normal
// is the world one too. The TPU kernel receives the rows gathered outside
// (instanced_attr_t, :1555), a workaround of its own. A runtime switch like
// `transposed`: no instantiation is added.
//
// One thread per lane, 128-thread blocks. The attribute row is read by
// max(prim, 0) straight from the [F, W] table: the TPU kernel receives
// it gathered and transposed outside (take_packed, a 128-lane packing
// workaround). A textured launch (kTex) fetches its texels itself from the
// uvs of that row (shade.cuh tex_fetch), which folds in the reference's
// make_tex_presampler (:1615-1675): that XLA pass exists only because the
// TPU kernel's own fetch was a one-hot matmul over the whole atlas; its
// arithmetic (_wrap_axis_xla, :1601-1612) is tex_fetch's. The TPU kernel's live count gates only its in-kernel sweep,
// which this variant lacks, so every lane is shaded and no count is read.
//
// Bound: memory and latency. Per lane the kernel reads 32 + 16 + 4 MW B of
// state and a 4W-byte attribute row (and 16 B of texels per fetch) and
// writes 32 + 4 (MW + 8) + 32|64 B; the math is a few hundred scalar
// operations with three transcendentals.
#include <type_traits>

#include "shade.cuh"

namespace rt3c {

constexpr int EXT_BLOCK = 128;

// Launch parameters; mirrored field for field by kernels/build.py.
struct ExternalParams {
  int max_depth, num_lights, light_stride, motion;
  float shadow_tmin, shadow_eps, pick_pdf;
  float bg[3];
  int attr_w;  // the attribute row's width: 16, or 24-40 textured
  int power, params_base, aov;
  int transposed;  // misc C-major [MW, R], misc_out [MW + 8, R]
  int n_inst;      // > 0: instance rows inst_rows [n_inst, 18], inst_ids [R]
};

template <bool kTex, bool kDispatch, bool kAov>
__global__ void __launch_bounds__(EXT_BLOCK)
    external_shade_kernel(const ExternalParams p,
                          const float* __restrict__ rays,
                          const float* __restrict__ hit4,
                          const float* __restrict__ misc,
                          const float* __restrict__ attr, int n_faces,
                          const float* __restrict__ lights_t, int n,
                          float* __restrict__ rays_out,
                          float* __restrict__ misc_out,
                          float* __restrict__ shadow_out,
                          const TexParams tex,
                          const float* __restrict__ inst_rows,
                          const int* __restrict__ inst_ids) {
  constexpr int MW = kAov ? 24 : 16;
  const int i = blockIdx.x * EXT_BLOCK + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, i);
  const float4 hv = reinterpret_cast<const float4*>(hit4)[i];
  const ClosestHit h{hv.x, hv.y, hv.z, hv.w};
  float m[MW];
  if (p.transposed) {
#pragma unroll
    for (int c = 0; c < MW; ++c) m[c] = misc[c * (size_t)n + i];
  } else {
    const float4* mp = reinterpret_cast<const float4*>(misc + MW * (size_t)i);
#pragma unroll
    for (int q = 0; q < MW / 4; ++q) {
      const float4 x = mp[q];
      m[4 * q + 0] = x.x;
      m[4 * q + 1] = x.y;
      m[4 * q + 2] = x.z;
      m[4 * q + 3] = x.w;
    }
  }
  // hits lie on real faces; the clamp only keeps a bad input in bounds
  const int prim = min((int)fmaxf(h.prim, 0.0f), n_faces - 1);
  const ShadeConsts sc{p.max_depth, p.num_lights, p.light_stride,
                       p.power, p.params_base, p.shadow_tmin, p.shadow_eps,
                       p.pick_pdf, {p.bg[0], p.bg[1], p.bg[2]}};
  InstRows inst;
  inst.on = p.n_inst > 0;
  if (inst.on) {
    const int id = inst_ids[i];
    const float* src = inst_rows + 18 * (size_t)min(max(id, 0), p.n_inst - 1);
#pragma unroll
    for (int q = 0; q < 18; ++q)
      inst.m[q] = id >= 0 ? src[q] : ((q % 9) % 4 == 0 ? 1.0f : 0.0f);
  }
  const Shaded o = shade_lane<true, kTex, kDispatch>(
      sc, r, h, m, attr + p.attr_w * (size_t)prim, 1, lights_t, tex,
      [](const Ray&, bool, float) { return false; }, inst);

  float4* rp = reinterpret_cast<float4*>(rays_out + 8 * (size_t)i);
  rp[0] = make_float4(o.survive ? o.px : r.ox, o.survive ? o.py : r.oy,
                      o.survive ? o.pz : r.oz, o.survive ? o.ndx : r.dx);
  rp[1] = make_float4(o.survive ? o.ndy : r.dy, o.survive ? o.ndz : r.dz,
                      r.tmin, r.tmax);
  // the next state, with AOV the albedo and normal accs, then the
  // pending NEE term and zeros
  float mo[MW + 8] = {__uint_as_float(o.seed), o.new_at[0], o.new_at[1],
                      o.new_at[2], o.new_last[0], o.new_last[1],
                      o.new_last[2], o.pdelta_new, o.depth_new,
                      o.alive_b ? 1.0f : 0.0f, o.accs[0], o.accs[1],
                      o.accs[2], m[13], m[14], o.want_shadow ? 1.0f : 0.0f};
  if constexpr (kAov) {
    for (int c = 0; c < 3; ++c) {
      mo[16 + c] = m[16 + c] + (o.first ? o.albedo[c] : 0.0f);
      mo[19 + c] = m[19 + c] + (o.first ? o.ns[c] : 0.0f);
    }
  }
  for (int c = 0; c < 3; ++c) mo[MW + c] = o.nee[c];
  if (p.transposed) {
#pragma unroll
    for (int c = 0; c < MW + 8; ++c) misc_out[c * (size_t)n + i] = mo[c];
  } else {
    float4* mp = reinterpret_cast<float4*>(misc_out + (MW + 8) * (size_t)i);
#pragma unroll
    for (int q = 0; q < (MW + 8) / 4; ++q)
      mp[q] = make_float4(mo[4 * q], mo[4 * q + 1], mo[4 * q + 2],
                          mo[4 * q + 3]);
  }
  const int sw = p.motion ? 16 : 8;
  float4* sp = reinterpret_cast<float4*>(shadow_out + sw * (size_t)i);
  sp[0] = make_float4(o.sr.ox, o.sr.oy, o.sr.oz, o.sr.dx);
  sp[1] = make_float4(o.sr.dy, o.sr.dz, o.sr.tmin, o.sr.tmax);
  if (p.motion) {
    sp[2] = make_float4(o.occl_time, 0.0f, 0.0f, 0.0f);
    sp[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace rt3c

// tex: the atlas of a textured scene, null for an untextured one;
// inst_rows / inst_ids: an instanced scene's rows and hit instances (p->n_inst
// > 0), else null;
// p->params_base > 0 takes the dispatch variant, p->aov the AOV variant
// (misc [R, 24], misc_out [R, 32]); p->transposed takes misc C-major.
extern "C" int rt3c_external_shade(int device, const rt3c::ExternalParams* p,
                                   const float* rays, const float* hit4,
                                   const float* misc, const float* attr,
                                   int n_faces, const float* lights_t, int n,
                                   float* rays_out, float* misc_out,
                                   float* shadow_out,
                                   const rt3c::TexParams* tex,
                                   const float* inst_rows,
                                   const int* inst_ids, void* stream) {
  if (n < 0 || n_faces < 1 || p->num_lights < 1 || p->attr_w < 16 ||
      p->params_base < 0 || p->params_base + 6 > p->attr_w ||
      (tex && (tex->texels == nullptr || tex->meta == nullptr)) ||
      p->n_inst < 0 ||
      (p->n_inst > 0 && (inst_rows == nullptr || inst_ids == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + rt3c::EXT_BLOCK - 1) / rt3c::EXT_BLOCK;
  const rt3c::TexParams none{nullptr, nullptr, 0, 0, 0, 0};
  const auto run = [&](auto kTex, auto kDispatch, auto kAov,
                       const rt3c::TexParams& t) {
    rt3c::external_shade_kernel<decltype(kTex)::value,
                                decltype(kDispatch)::value,
                                decltype(kAov)::value>
        <<<grid, rt3c::EXT_BLOCK, 0, s>>>(*p, rays, hit4, misc, attr, n_faces,
                                          lights_t, n, rays_out, misc_out,
                                          shadow_out, t, inst_rows, inst_ids);
  };
  const auto with_aov = [&](auto kTex, auto kDispatch,
                            const rt3c::TexParams& t) {
    if (p->aov) run(kTex, kDispatch, std::true_type{}, t);
    else run(kTex, kDispatch, std::false_type{}, t);
  };
  const bool dispatch = p->params_base > 0;
  if (tex && dispatch) with_aov(std::true_type{}, std::true_type{}, *tex);
  else if (tex) with_aov(std::true_type{}, std::false_type{}, *tex);
  else if (dispatch) with_aov(std::false_type{}, std::true_type{}, none);
  else with_aov(std::false_type{}, std::false_type{}, none);
  return (int)cudaGetLastError();
}
