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
// The layout is a runtime switch, not a template one: both are one uniform
// branch around the loads and the stores, so the 8 instantiations (and
// nvcc's time) stay as they were.
//
// Instance rows (p.n_inst > 0, a trace-time instanced scene): the lane reads
// its hit's instance id from inst_ids [R] and that instance's 18 rows from
// inst_rows [I, 18] (the identity where the id is -1) and shade_lane moves
// the normal, and a normal map's tangent, to world space, so the AOV normal
// is the world one too. The TPU kernel receives the rows gathered outside
// (instanced_attr_t, :1555), a workaround of its own. A runtime switch like
// `transposed`: no instantiation is added.
//
// The attribute row is read by max(prim, 0) straight from the [F, W]
// table: the TPU kernel receives it gathered and transposed outside
// (take_packed, a 128-lane packing workaround). A textured launch (kTex)
// fetches its texels itself from the uvs of that row (shade.cuh
// tex_fetch), which folds in the reference's make_tex_presampler
// (:1615-1675): that XLA pass exists only because the TPU kernel's own
// fetch was a one-hot matmul over the whole atlas; its
// arithmetic (_wrap_axis_xla, :1601-1612) is tex_fetch's. The TPU
// kernel's live count gates only its in-kernel sweep, which this variant
// lacks, so every lane is shaded and no count is read.
//
// Design (redesigned for Hopper). A block shades 32 lanes with two warps:
// warp 0 the bounce half of each lane (the BSDF sample, Russian roulette,
// the next state and the AOV rows), warp 1 the NEE half (the light pick and
// sample, the shadow ray, the NEE term; shade.cuh LanePart). A lane's work
// was one dependent chain (state, attribute row, texels, light pick, the
// light's row, ~3 k instructions of shading); split over two warps, the
// halves run side by side and the NEE warp issues its light's loads right
// after the state, since the pick needs only the seed and adv. 32 lanes a
// block give 256 blocks of 2 warps at the trace-time pool's 8192 lanes and
// 1024 at the walk pools' and the MT towns' 32768 (128-lane blocks of one
// thread a lane left 68 of 132 SMs idle at 8192). Row-major misc and every
// row-major output pass through shared memory, so that the block reads and
// writes its rows as one contiguous stretch of float4s (a warp's float4
// access to rows of 64-128 B touched 16-32 lines, and those stores took
// 46% of a town warp's cycles); each lane's ray, hit and instance id are
// loaded before that staging's barrier, so every load is in flight
// together. C-major misc is read and written per column, coalesced as it
// is (staging it too, and the rays and hits, measured 0-4% slower). Both
// halves compute the shared front in the same operations, so the outputs
// are the single thread's bit for bit. Timed against this form (PERF.md):
// one thread a lane in the same staged blocks, 3-8% slower weighted by
// launches and no faster than the 128-lane blocks at 8192 lanes; the
// light read from a lane-major copy of the table, no faster.
//
// Bound: memory and the launch. Per lane the kernel reads 32 + 16 + 4 MW B
// of state and a 4W-byte attribute row (and 16 B of texels per fetch) and
// writes 32 + 4 (MW + 8) + 32|64 B, ~0.3-0.4 KB: 32768 lanes move ~10 MB,
// ~3 us at 3.35 TB/s, 8192 lanes ~0.8 us, under an empty launch's ~2 us
// behind another launch; the math is a few hundred scalar operations with
// three transcendentals. At 32768 lanes a warp waits ~1.7 us for its state
// (every block loads at once), longer than its shading.
#include <type_traits>

#include "shade.cuh"

namespace rt3c {

constexpr int EXT_LANES = 32;             // lanes of a block
constexpr int EXT_BLOCK = 2 * EXT_LANES;  // the bounce warp, the NEE warp

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

// The block's nb rows of width W (a multiple of 4) of a row-major array at
// `g` (16-byte aligned), as float4s over the whole block: `load_rows` into
// K registers a thread, `stage_rows` from them into shared memory at `s`
// (row stride W + 1: the padding keeps a lane's column accesses off one
// bank), `store_rows` from shared memory back out.
template <int W, int K>
__device__ __forceinline__ void load_rows(const float* g, int nb,
                                          float4 (&v)[K]) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * EXT_BLOCK;
    if (q < nb * W / 4) v[k] = g4[q];
  }
}

template <int W, int K>
__device__ __forceinline__ void stage_rows(float* s, int nb,
                                           const float4 (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = 4 * (threadIdx.x + k * EXT_BLOCK);
    if (e < nb * W) {
      float* r = s + (e / W) * (W + 1) + e % W;
      r[0] = v[k].x;
      r[1] = v[k].y;
      r[2] = v[k].z;
      r[3] = v[k].w;
    }
  }
}

__device__ __forceinline__ void store_rows(float* g, const float* s, int w,
                                           int nb) {
  float4* g4 = reinterpret_cast<float4*>(g);
  for (int q = threadIdx.x; q < nb * w / 4; q += EXT_BLOCK) {
    const int e = 4 * q;
    const float* r = s + (e / w) * (w + 1) + e % w;
    g4[q] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// float4s a thread loads for the block's nb <= EXT_LANES rows of width W
template <int W>
__host__ __device__ constexpr int rows_per_thread() {
  return (EXT_LANES * W / 4 + EXT_BLOCK - 1) / EXT_BLOCK;
}

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
  constexpr int MO = MW + 8;  // misc_out's width
  __shared__ float s_misc[EXT_LANES * (MW + 1)];
  __shared__ float s_rays[EXT_LANES * (8 + 1)];
  __shared__ float s_mo[EXT_LANES * (MO + 1)];
  __shared__ float s_shadow[EXT_LANES * (16 + 1)];
  const int part = threadIdx.x < EXT_LANES ? LANE_BOUNCE : LANE_NEE;
  const int j = threadIdx.x % EXT_LANES;
  const int i0 = blockIdx.x * EXT_LANES;
  const int nb = min(EXT_LANES, n - i0);  // the block's lanes
  const int i = i0 + j;
  const bool row_major = !p.transposed;
  const int sw = p.motion ? 16 : 8;

  // the lane's ray, hit and instance id, then row-major misc staged by
  // the whole block: every load is issued before the barrier
  Ray r{};
  ClosestHit h{};
  int id = -1;
  if (j < nb) {
    r = load_ray(rays, i);
    const float4 hv = reinterpret_cast<const float4*>(hit4)[i];
    h = ClosestHit{hv.x, hv.y, hv.z, hv.w};
    if (p.n_inst > 0) id = inst_ids[i];
  }
  if (row_major) {
    float4 v[rows_per_thread<MW>()];
    load_rows<MW>(misc + MW * (size_t)i0, nb, v);
    stage_rows<MW>(s_misc, nb, v);
    __syncthreads();
  }
  // every thread reaches the barrier before the stores: no early return
  if (j < nb) {
    float m[MW];
#pragma unroll
    for (int c = 0; c < MW; ++c)
      m[c] = row_major ? s_misc[j * (MW + 1) + c] : misc[c * (size_t)n + i];
    // hits lie on real faces; the clamp only keeps a bad input in bounds
    const int prim = min((int)fmaxf(h.prim, 0.0f), n_faces - 1);
    const ShadeConsts sc{p.max_depth, p.num_lights, p.light_stride,
                         p.power, p.params_base, p.shadow_tmin,
                         p.shadow_eps, p.pick_pdf,
                         {p.bg[0], p.bg[1], p.bg[2]}};
    InstRows inst;
    inst.on = p.n_inst > 0;
    if (inst.on) {
      const float* src =
          inst_rows + 18 * (size_t)min(max(id, 0), p.n_inst - 1);
#pragma unroll
      for (int q = 0; q < 18; ++q)
        inst.m[q] = id >= 0 ? src[q] : ((q % 9) % 4 == 0 ? 1.0f : 0.0f);
    }
    const Shaded o = shade_lane<true, kTex, kDispatch>(
        sc, r, h, m, attr + p.attr_w * (size_t)prim, 1, lights_t, tex,
        [](const Ray&, bool, float) { return false; }, inst, part);

    // each half stages its columns of the lane's rows; C-major misc_out
    // is written per column, coalesced
    float* mo = s_mo + j * (MO + 1);
    const auto put = [&](int c, float v) {
      if (row_major)
        mo[c] = v;
      else
        misc_out[c * (size_t)n + i] = v;
    };
    if (part != LANE_NEE) {
      float* ro = s_rays + j * (8 + 1);
      ro[0] = o.survive ? o.px : r.ox;
      ro[1] = o.survive ? o.py : r.oy;
      ro[2] = o.survive ? o.pz : r.oz;
      ro[3] = o.survive ? o.ndx : r.dx;
      ro[4] = o.survive ? o.ndy : r.dy;
      ro[5] = o.survive ? o.ndz : r.dz;
      ro[6] = r.tmin;
      ro[7] = r.tmax;
      // the next state, with AOV the albedo and normal accs and zeros
      const float st[15] = {__uint_as_float(o.seed), o.new_at[0],
                            o.new_at[1], o.new_at[2], o.new_last[0],
                            o.new_last[1], o.new_last[2], o.pdelta_new,
                            o.depth_new, o.alive_b ? 1.0f : 0.0f,
                            o.accs[0], o.accs[1], o.accs[2], m[13], m[14]};
#pragma unroll
      for (int c = 0; c < 15; ++c) put(c, st[c]);
      if constexpr (kAov) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          put(16 + c, m[16 + c] + (o.first ? o.albedo[c] : 0.0f));
          put(19 + c, m[19 + c] + (o.first ? o.ns[c] : 0.0f));
        }
        put(22, 0.0f);
        put(23, 0.0f);
      }
    }
    if (part != LANE_BOUNCE) {
      // want_shadow, then the pending NEE term and zeros
      put(15, o.want_shadow ? 1.0f : 0.0f);
#pragma unroll
      for (int c = 0; c < 8; ++c) put(MW + c, c < 3 ? o.nee[c] : 0.0f);
      float* so = s_shadow + j * (sw + 1);
      so[0] = o.sr.ox;
      so[1] = o.sr.oy;
      so[2] = o.sr.oz;
      so[3] = o.sr.dx;
      so[4] = o.sr.dy;
      so[5] = o.sr.dz;
      so[6] = o.sr.tmin;
      so[7] = o.sr.tmax;
      for (int c = 8; c < sw; ++c) so[c] = c == 8 ? o.occl_time : 0.0f;
    }
  }
  __syncthreads();
  store_rows(rays_out + 8 * (size_t)i0, s_rays, 8, nb);
  store_rows(shadow_out + sw * (size_t)i0, s_shadow, sw, nb);
  if (row_major) store_rows(misc_out + MO * (size_t)i0, s_mo, MO, nb);
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
  const int grid = (n + rt3c::EXT_LANES - 1) / rt3c::EXT_LANES;
  const rt3c::TexParams none{nullptr, nullptr, 0, 0, 0, 0};
  const auto run = [&](auto kTex, auto kDispatch, auto kAov,
                       const rt3c::TexParams& t) {
    rt3c::external_shade_kernel<decltype(kTex)::value,
                                decltype(kDispatch)::value,
                                decltype(kAov)::value>
        <<<grid, rt3c::EXT_BLOCK, 0, s>>>(*p, rays, hit4, misc, attr, n_faces,
                                          lights_t, n, rays_out,
                                          misc_out, shadow_out, t, inst_rows,
                                          inst_ids);
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
