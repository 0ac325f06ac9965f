// K4: the in-kernel-refill megakernel of the pool integrator, and K5, the
// same megakernel without the refill; each static or 2-key motion,
// untextured or textured, all-diffuse or with the material dispatch,
// without or with the first-hit AOV rows, with the uniform or the power
// light pick. The kernels and their launchers are templates here;
// megakernel.cu instantiates the variants without AOV and holds the C entry
// points, megakernel_aov.cu the AOV variants, so that the two halves compile
// in parallel.
//
// Replaces rendertoy3c_tpu/trace/pallas_shade.py _make_shade_kernel (:271)
// as built by make_fused_shader(merged=True): K4 with refill=... and the
// stash on, launched by trace_shade_refill (:1281-1367); K5 launched by
// `shade` (:1224-1275) behind the merged `trace_shade` (:1371-1375). One
// launch is one pool iteration: closest sweep, attribute fetch by prim,
// emission, miss ambient, the Lambertian draw or the four-type material
// dispatch, NEE light pick + area sample, shadow sweep, Russian roulette
// and the next path state. K4 then
// runs the refill epilogue (retire into the stash, pixel claim, tea seed,
// per-sample LCG jump, jittered camera ray, the per-ray time draw) and the
// launch stats (next_work, count_hint, n_live, 0); K5 writes the next state
// to new buffers and leaves the refill to the caller (integrate/path.py).
//
// Motion (kMotion): both keys' tiles are staged and each triangle is lerped
// to the lane's time, r0 + (r1 - r0) * t, under the union of both keys'
// cull boxes (pallas_shade.py :359-370). The closest sweep runs at the
// lane's time, read from a time buffer [P]; the shadow sweep at the
// post-NEE peek (:756-793). K4 writes each lane's next time draw back into
// the buffer (:1044-1053); K5 takes the time from the caller's loop. The
// motion sweeps vote per 256-ray block, the TPU megakernel's RAY_TILE, not
// per 128-ray block as K3 does. The two keys' tiles take 36 KB of static
// shared memory, shared by the closest and the shadow sweep.
//
// Bound: latency. A pool of 32768 lanes is 128 blocks of 256 lanes, less
// than one block per SM, and each lane does two sweeps of dependent loads
// and a chain of scalar math; the per-lane state (rays 32 B, misc 64 B,
// stash 64 B in and out) is a few MB per launch. Design: a group of
// LANE_GROUP = 2 threads per lane (512-thread blocks, up to 128 registers
// a thread: 80-117, no spills), which split the closest and the shadow
// sweep's triangle tests between them (mt.cuh) and test only the soup's
// real faces; both threads then shade the lane alike (a warp issues the
// same instructions whether one thread of a group or both run them) and
// its leader alone writes it back, in place (each group reads and writes
// only its own lane, the CUDA form of the TPU kernel's input/output
// aliasing); the cull vote still spans the block's 256 lanes, the TPU
// kernel's RAY_TILE. Tables are read by plain fp32 indexed loads (no
// one-hot matmul, so no TF32 path).
//
// The work counter: TPU grid steps run in order and step 0 seeds an SMEM
// counter; CUDA blocks run concurrently. Here a one-thread launch first
// seeds stats_out = (next_work, 0, 0, 0) from the previous launch's stats
// (stats_in, never the same buffer), and each block claims pixels for its
// idle lanes with an in-block exclusive scan (each lane counted once, by
// its leader) plus one compare-and-swap loop that clamps the counter at
// n_pix. Which block gets which pixels varies
// from run to run; per-pixel RNG streams are keyed by pixel id (tea), so the
// image does not depend on it.
//
// The shading body (attribute fetch to next state) is shade_lane in
// shade.cuh, shared with the external shade kernel K6.
//
// Textured (kTex, make_fused_shader with textured=True): the attribute
// table grows to 24-40 rows (uvs, texture ids, uv transform, tangents) and
// shade_lane fetches the diffuse texture and the normal map from the RGBA8
// atlas with four 4-byte loads each (TexParams); the TPU kernel's atlas
// one-hot matmuls (_tex_fetch) have no counterpart. A lane that hits an
// untextured face reads no texel.
//
// Dispatch (kDispatch, make_fused_shader with dispatch=True, for a scene
// with a non-DIFFUSE material): shade_lane's dispatch body over the 6
// material-parameter rows at params_base; all-diffuse scenes keep the
// Lambertian body. The power light pick is a launch-uniform flag.
//
// AOV (kAov, make_fused_shader under cfg.aov, pallas_shade.py :881-893,
// :917-918, :964-967): misc widens to 24 columns; at depth 0 a live lane that
// hits adds its albedo to columns 16-18 and its shading normal to 19-21
// (22-23 stay zero), and K4's retire moves those accs into stash columns 4-9
// (zeroing them in misc) where it moves the radiance acc. It is a template
// switch, not a launch-uniform flag, so that the launches without AOV run
// none of its code or registers. Every combination
// of motion, texture, dispatch and AOV is instantiated (16 of each kernel).
#pragma once

#include <type_traits>

#include "shade.cuh"

namespace rt3c {

// Launch parameters; mirrored field for field by kernels/build.py.
struct RefillParams {
  int n_pix, spp, width, max_depth;
  int num_lights, pixel_base, subframe_index, attr_stride;
  int light_stride, n_tiles, ct, n_faces, motion;
  int power, params_base, aov;
  unsigned int seed_rot;
  float width_f, height_f, tmin, tmax;
  float shadow_tmin, shadow_eps, pick_pdf;
  float bg[3];
  float cam[12];  // eye, u, v, w
};

// K5's launch parameters; mirrored field for field by kernels/build.py.
struct TraceShadeParams {
  int max_depth, num_lights, attr_stride, light_stride;
  int n_tiles, ct, n_faces, motion, power;
  int params_base, aov;
  float shadow_tmin, shadow_eps, pick_pdf;
  float bg[3];
};

// The threads of a lane's group (mt.cuh's sweeps): a block is RAY_TILE
// lanes of LANE_GROUP threads. 2 timed fastest over the paths' launches
// (1 and 4 in turns, PERF.md); at 4 the 64-register cap of a 1024-thread
// block spilled every instantiation.
constexpr int LANE_GROUP = 2;
// The lanes' leaders (thread g = 0 of each group) in a warp's ballot.
constexpr unsigned LEADERS = FULL_MASK / ((1u << LANE_GROUP) - 1u);

// The sweeps of one lane over the launch's tables: the static soup, or for
// motion the key-0 tiles in soup.tris (with the union cull boxes) and the
// key-1 tiles in tris1. smem holds one staged tile per key.
template <bool kMotion>
__device__ __forceinline__ ClosestHit sweep_closest_at(const Soup& s,
                                                       const float* tris1,
                                                       float* smem,
                                                       const Ray& r,
                                                       float time, bool live) {
  if constexpr (kMotion) {
    const MotionSoup ms{s.tris,    tris1, s.aabb,   s.super_aabb,
                        s.n_tiles, s.ct,  s.n_faces};
    return sweep_closest_motion<LANE_GROUP>(ms, smem, smem + 9 * MAX_CT, r,
                                            time, live);
  } else {
    return sweep_closest<LANE_GROUP>(s, smem, r, live);
  }
}

template <bool kMotion>
__device__ __forceinline__ bool sweep_any_at(const Soup& s, const float* tris1,
                                             float* smem, const Ray& r,
                                             float time, bool live,
                                             bool want) {
  if constexpr (kMotion) {
    const MotionSoup ms{s.tris,    tris1, s.aabb,   s.super_aabb,
                        s.n_tiles, s.ct,  s.n_faces};
    return sweep_any_motion<LANE_GROUP>(ms, smem, smem + 9 * MAX_CT, r,
                                        time, live, want);
  } else {
    return sweep_any<LANE_GROUP>(s, smem, r, live, want);
  }
}

// The lane's misc row of W floats (16, or 24 with AOV).
template <int W>
__device__ __forceinline__ void load_misc(const float* base, int lane,
                                          float* m) {
  const float4* mp = reinterpret_cast<const float4*>(base + W * (size_t)lane);
  for (int q = 0; q < W / 4; ++q) {
    const float4 x = mp[q];
    m[4 * q + 0] = x.x;
    m[4 * q + 1] = x.y;
    m[4 * q + 2] = x.z;
    m[4 * q + 3] = x.w;
  }
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

// The AOV rows of a shaded lane (pallas_shade.py :881-893): misc columns
// 16-21 plus the albedo and the shading normal on a first hit.
__device__ __forceinline__ void aov_rows(const Shaded& o, const float* m,
                                         float* aov) {
  for (int c = 0; c < 3; ++c) {
    aov[c] = m[16 + c] + (o.first ? o.albedo[c] : 0.0f);
    aov[3 + c] = m[19 + c] + (o.first ? o.ns[c] : 0.0f);
  }
}

// Columns 16-23 of an AOV misc row: the AOV rows and two zeros.
__device__ __forceinline__ void store_aov(float4* mp, const float* aov) {
  mp[4] = make_float4(aov[0], aov[1], aov[2], aov[3]);
  mp[5] = make_float4(aov[4], aov[5], 0.0f, 0.0f);
}

template <bool kMotion, bool kTex, bool kDispatch, bool kAov>
__global__ void __launch_bounds__(RAY_TILE * LANE_GROUP, 1)
    refill_kernel(const RefillParams p, float* __restrict__ rays,
                  float* __restrict__ misc, float* __restrict__ stash,
                  float* __restrict__ time, const int* __restrict__ stats_in,
                  int* __restrict__ stats_out, const Soup soup,
                  const float* __restrict__ tris1,
                  const float* __restrict__ attr_t,
                  const float* __restrict__ lights_t,
                  const uint32_t* __restrict__ jump, const TexParams tex) {
  __shared__ float tiles[(kMotion ? 2 : 1) * 9 * MAX_CT];
  __shared__ int warp_base[RAY_TILE * LANE_GROUP / 32];
  __shared__ int s_base, s_max_lane, s_live;

  // LANE_GROUP threads a lane: each reads the lane, sweeps its share of
  // the faces and shades it alike; the leader (g = 0) alone writes it back
  const int lane = blockIdx.x * RAY_TILE + threadIdx.x / LANE_GROUP;
  const int g = threadIdx.x % LANE_GROUP;
  const bool lead = g == 0;
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_max_lane = -1;
    s_live = 0;
  }
  constexpr int MW = kAov ? 24 : 16;
  const bool live = (int)blockIdx.x * RAY_TILE < stats_in[1];
  const Ray r = load_ray(rays, lane);
  float m[MW];
  load_misc<MW>(misc, lane, m);
  float tm = 0.0f;
  if constexpr (kMotion) tm = time[lane];

  // --- closest sweep (the _closest_kernel body) ---
  const ClosestHit h = sweep_closest_at<kMotion>(soup, tris1, tiles, r, tm,
                                                    live);

  // --- shading, with the shadow sweep (the _any_kernel body) in place ---
  const ShadeConsts sc{p.max_depth, p.num_lights, p.light_stride,
                       p.power, p.params_base, p.shadow_tmin, p.shadow_eps,
                       p.pick_pdf, {p.bg[0], p.bg[1], p.bg[2]}};
  const Shaded o = shade_lane<false, kTex, kDispatch>(
      sc, r, h, m, attr_t + (int)fmaxf(h.prim, 0.0f), p.attr_stride,
      lights_t, tex, [&](const Ray& sr, bool want, float st) {
        return sweep_any_at<kMotion>(soup, tris1, tiles, sr, st, live,
                                        want);
      });
  const uint32_t seed = o.seed;
  const float px = o.px, py = o.py, pz = o.pz;
  const float ndx = o.ndx, ndy = o.ndy, ndz = o.ndz;
  const bool survive = o.survive, alive_b = o.alive_b;
  const bool want_shadow = o.want_shadow;
  float accs[3] = {o.accs[0], o.accs[1], o.accs[2]};
  [[maybe_unused]] float aov[6];
  if constexpr (kAov) aov_rows(o, m, aov);

  // ==== refill epilogue ====
  const bool deadr = !alive_b;
  float pixf = m[13];
  float sampf = m[14];

  // retire a completed lane into its stash slot if the slot is free; the
  // AOV accs ride in stash columns 4-9
  float st[kAov ? 10 : 4];
  {
    const float4* sp = reinterpret_cast<const float4*>(stash + 16 * (size_t)lane);
    const float4 x = sp[0];
    st[0] = x.x;
    st[1] = x.y;
    st[2] = x.z;
    st[3] = x.w;
    if constexpr (kAov) {
      const float4 y = sp[1], z = sp[2];
      st[4] = y.x;
      st[5] = y.y;
      st[6] = y.z;
      st[7] = y.w;
      st[8] = z.x;
      st[9] = z.y;
    }
  }
  const bool completed = deadr && (pixf >= 0.0f) && (sampf >= (float)p.spp);
  const bool can_stash = completed && (st[0] < 0.0f);
  if (can_stash) {
    st[0] = pixf;
    for (int c = 0; c < 3; ++c) {
      st[1 + c] = accs[c];
      accs[c] = 0.0f;
    }
    if constexpr (kAov) {
      for (int k = 0; k < 6; ++k) {
        st[4 + k] = aov[k];
        aov[k] = 0.0f;
      }
    }
    pixf = -1.0f;
    sampf = 0.0f;
  }

  // pixel claim: exclusive scan of idle lanes in lane order (each lane
  // counted once, by its leader's bit), then one atomicAdd per block on
  // the work counter and an atomicMin that clamps it at n_pix: every add is
  // followed by its block's clamp, so the counter ends at min(start + idle
  // lanes, n_pix) in any block order, and a block whose base is past
  // n_pix takes no pixel (one compare-and-swap loop per block had the
  // 128 blocks retry one another's swaps)
  const bool idle = deadr && (pixf < 0.0f);
  const unsigned ballot = __ballot_sync(FULL_MASK, idle) & LEADERS;
  const int lane_rank = __popc(ballot & ((1u << (lid - g)) - 1u));
  if (lid == 0) warp_base[wid] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int w = 0; w < RAY_TILE * LANE_GROUP / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = k;
      k += c;
    }
    int base = 0;
    if (k > 0) {
      base = atomicAdd(&stats_out[0], k);
      atomicMin(&stats_out[0], p.n_pix);
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
  // the per-ray time draw: advances every live lane; the motion variant
  // keeps the drawn time (on every lane) for the next launch's sweeps
  const uint32_t s_adv = lcg_next(seed_u);
  if constexpr (kMotion) {
    if (lead) time[lane] = lcg_unit(s_adv);
  }
  if (alive2) seed_u = s_adv;

  // --- write the lane back in place ---
  if (lead) {
    float4* rp = reinterpret_cast<float4*>(rays + 8 * (size_t)lane);
    rp[0] = make_float4(take ? p.cam[0] : (survive ? px : r.ox),
                        take ? p.cam[1] : (survive ? py : r.oy),
                        take ? p.cam[2] : (survive ? pz : r.oz),
                        take ? cdx : (survive ? ndx : r.dx));
    rp[1] = make_float4(take ? cdy : (survive ? ndy : r.dy),
                        take ? cdz : (survive ? ndz : r.dz), p.tmin, p.tmax);
    float4* mp = reinterpret_cast<float4*>(misc + MW * (size_t)lane);
    mp[0] = make_float4(__uint_as_float(seed_u), take ? 1.0f : o.new_at[0],
                        take ? 1.0f : o.new_at[1], take ? 1.0f : o.new_at[2]);
    mp[1] = make_float4(take ? 1.0f : o.new_last[0],
                        take ? 1.0f : o.new_last[1],
                        take ? 1.0f : o.new_last[2],
                        take ? 0.0f : o.pdelta_new);
    mp[2] = make_float4(take ? 0.0f : o.depth_new, alive2 ? 1.0f : 0.0f,
                        accs[0], accs[1]);
    mp[3] = make_float4(accs[2], pixf, sampf, want_shadow ? 1.0f : 0.0f);
    if constexpr (kAov) store_aov(mp, aov);
    float4* sp = reinterpret_cast<float4*>(stash + 16 * (size_t)lane);
    sp[0] = make_float4(st[0], st[1], st[2], st[3]);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kAov) {
      sp[1] = make_float4(st[4], st[5], st[6], st[7]);
      sp[2] = make_float4(st[8], st[9], 0.0f, 0.0f);
    } else {
      sp[1] = z;
      sp[2] = z;
    }
    sp[3] = z;
  }

  // --- launch stats: count_hint = last live lane + 1, n_live ---
  const unsigned live_mask = __ballot_sync(FULL_MASK, alive2) & LEADERS;
  if (lid == 0 && live_mask) {
    atomicMax(&s_max_lane,
              (wid * 32 + 31 - __clz(live_mask)) / LANE_GROUP);
    atomicAdd(&s_live, __popc(live_mask));
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_max_lane >= 0) {
    atomicMax(&stats_out[1], (int)blockIdx.x * RAY_TILE + s_max_lane + 1);
    atomicAdd(&stats_out[2], s_live);
  }
}

// K5: one pool iteration without the refill. Reads rays [P, 8], misc
// [P, 16|24] (and time [P] for motion), writes the next rays (the bounce
// ray on surviving lanes, tmin/tmax passed on) and the next misc: the state
// of pallas_shade.py :893-932 with pixel and sample passed on. A non-null
// hit4 [P, 4] (t, prim, u, v) is the non-merged K5
// (make_fused_shader(merged=False)): the closest hit comes from it instead
// of the in-kernel sweep, and `time` is not read (the shadow rays' time is
// the seed's peek either way).
template <bool kMotion, bool kTex, bool kDispatch, bool kAov>
__global__ void __launch_bounds__(RAY_TILE * LANE_GROUP, 1)
    trace_shade_kernel(const TraceShadeParams p,
                       const float* __restrict__ rays,
                       const float* __restrict__ misc,
                       const float* __restrict__ time,
                       const float* __restrict__ hit4,
                       const int* __restrict__ count, const Soup soup,
                       const float* __restrict__ tris1,
                       const float* __restrict__ attr_t,
                       const float* __restrict__ lights_t,
                       float* __restrict__ rays_out,
                       float* __restrict__ misc_out, const TexParams tex) {
  __shared__ float tiles[(kMotion ? 2 : 1) * 9 * MAX_CT];
  constexpr int MW = kAov ? 24 : 16;
  const int lane = blockIdx.x * RAY_TILE + threadIdx.x / LANE_GROUP;
  const bool live = (int)blockIdx.x * RAY_TILE < *count;
  const Ray r = load_ray(rays, lane);
  float m[MW];
  load_misc<MW>(misc, lane, m);
  ClosestHit h;
  if (hit4 != nullptr) {  // grid-uniform: no block skips a sweep's votes
    const float4 g = reinterpret_cast<const float4*>(hit4)[lane];
    h = ClosestHit{g.x, g.y, g.z, g.w};
  } else {
    float tm = 0.0f;
    if constexpr (kMotion) tm = time[lane];
    h = sweep_closest_at<kMotion>(soup, tris1, tiles, r, tm, live);
  }
  const ShadeConsts sc{p.max_depth, p.num_lights, p.light_stride,
                       p.power, p.params_base, p.shadow_tmin, p.shadow_eps,
                       p.pick_pdf, {p.bg[0], p.bg[1], p.bg[2]}};
  const Shaded o = shade_lane<false, kTex, kDispatch>(
      sc, r, h, m, attr_t + (int)fmaxf(h.prim, 0.0f), p.attr_stride,
      lights_t, tex, [&](const Ray& sr, bool want, float st) {
        return sweep_any_at<kMotion>(soup, tris1, tiles, sr, st, live,
                                        want);
      });

  if (threadIdx.x % LANE_GROUP != 0) return;  // the leader writes the lane
  float4* rp = reinterpret_cast<float4*>(rays_out + 8 * (size_t)lane);
  rp[0] = make_float4(o.survive ? o.px : r.ox, o.survive ? o.py : r.oy,
                      o.survive ? o.pz : r.oz, o.survive ? o.ndx : r.dx);
  rp[1] = make_float4(o.survive ? o.ndy : r.dy, o.survive ? o.ndz : r.dz,
                      r.tmin, r.tmax);
  float4* mo = reinterpret_cast<float4*>(misc_out + MW * (size_t)lane);
  mo[0] = make_float4(__uint_as_float(o.seed), o.new_at[0], o.new_at[1],
                      o.new_at[2]);
  mo[1] = make_float4(o.new_last[0], o.new_last[1], o.new_last[2],
                      o.pdelta_new);
  mo[2] = make_float4(o.depth_new, o.alive_b ? 1.0f : 0.0f, o.accs[0],
                      o.accs[1]);
  mo[3] = make_float4(o.accs[2], m[13], m[14], o.want_shadow ? 1.0f : 0.0f);
  if constexpr (kAov) {
    float aov[6];
    aov_rows(o, m, aov);
    store_aov(mo, aov);
  }
}

// Calls launch(kMotion, kTex, kDispatch, tex params) with the variant's
// compile-time switches.
template <class Launch>
int launch_variant(bool motion, const TexParams* tex, bool dispatch,
                   Launch launch) {
  const TexParams none{nullptr, nullptr, 0, 0, 0, 0};
  const auto with_dispatch = [&](auto kMotion, auto kTex, const TexParams& t) {
    if (dispatch) launch(kMotion, kTex, std::true_type{}, t);
    else launch(kMotion, kTex, std::false_type{}, t);
  };
  const auto with_tex = [&](auto kMotion) {
    if (tex) with_dispatch(kMotion, std::true_type{}, *tex);
    else with_dispatch(kMotion, std::false_type{}, none);
  };
  if (motion) with_tex(std::true_type{});
  else with_tex(std::false_type{});
  return (int)cudaGetLastError();
}

// The launches of K4 and K5 in their kAov half, arguments as the C entry
// points' (megakernel.cu), after validation (and, for K4, seed_stats), on
// the stream s.
template <bool kAov>
int launch_refill(const RefillParams* p, float* rays, float* misc,
                  float* stash, float* time, int n_lanes, const int* stats_in,
                  int* stats_out, const Soup& soup, const float* tris1,
                  const float* attr_t, const float* lights_t,
                  const unsigned int* jump, const TexParams* tex,
                  cudaStream_t s) {
  const int grid = n_lanes / RAY_TILE;
  return launch_variant(p->motion, tex, p->params_base > 0,
                        [&](auto kMotion, auto kTex, auto kDispatch,
                            const TexParams& t) {
    refill_kernel<decltype(kMotion)::value, decltype(kTex)::value,
                  decltype(kDispatch)::value, kAov>
        <<<grid, RAY_TILE * LANE_GROUP, 0, s>>>(
            *p, rays, misc, stash, time, stats_in, stats_out, soup, tris1,
            attr_t, lights_t, jump, t);
  });
}

template <bool kAov>
int launch_trace_shade(const TraceShadeParams* p, const float* rays,
                       const float* misc, const float* time,
                       const float* hit4, int n_lanes,
                       const int* count, const Soup& soup, const float* tris1,
                       const float* attr_t, const float* lights_t,
                       float* rays_out, float* misc_out, const TexParams* tex,
                       cudaStream_t s) {
  const int grid = n_lanes / RAY_TILE;
  return launch_variant(p->motion, tex, p->params_base > 0,
                        [&](auto kMotion, auto kTex, auto kDispatch,
                            const TexParams& t) {
    trace_shade_kernel<decltype(kMotion)::value, decltype(kTex)::value,
                       decltype(kDispatch)::value, kAov>
        <<<grid, RAY_TILE * LANE_GROUP, 0, s>>>(
            *p, rays, misc, time, hit4, count, soup, tris1, attr_t, lights_t,
            rays_out, misc_out, t);
  });
}

// The kAov = true halves, compiled in megakernel_aov.cu.
int launch_refill_aov(const RefillParams* p, float* rays, float* misc,
                      float* stash, float* time, int n_lanes,
                      const int* stats_in, int* stats_out, const Soup& soup,
                      const float* tris1, const float* attr_t,
                      const float* lights_t, const unsigned int* jump,
                      const TexParams* tex, cudaStream_t s);
int launch_trace_shade_aov(const TraceShadeParams* p, const float* rays,
                           const float* misc, const float* time,
                           const float* hit4, int n_lanes, const int* count,
                           const Soup& soup, const float* tris1,
                           const float* attr_t, const float* lights_t,
                           float* rays_out, float* misc_out,
                           const TexParams* tex, cudaStream_t s);

}  // namespace rt3c
