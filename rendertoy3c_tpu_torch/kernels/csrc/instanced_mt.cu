// K7: static two-level (instance -> mesh) Moller-Trumbore closest-hit and
// any-hit over a trace-time instanced scene.
//
// Replaces rendertoy3c_tpu/trace/pallas_instanced.py _trace_instanced
// (:236, the pallas_call at :244): the kernel of _make_kernel (:189) with
// the instance sweep _instance_sweep (:76) and its updates _closest_update
// (:162) and _any_update (:182).
//
// Bound: latency on the trace-time path, the MT tests on large meshes.
// The TPU kernel culls per 256-ray tile (a tile enters an instance when
// any of its rays' slab tests admits it) and tests all 128 faces of every
// mesh tile, most of them the zero padding of INST_FACE_ALIGN: on the
// trace-time Cornell (six 2-face meshes, 15 instances) a ray's own test
// admits 1.1 instances, the tile's vote 3.5, and 126 of each tile's 128
// faces are padding. One 256-thread block per ray tile gave the pool's
// 32768 rays 128 blocks, each thread's tests serial, so the card waited
// on latency, not work.
//
// The kernel culls ray by ray: a live ray enters an instance when its
// slab test of the instance's world box grown by BOX_PAD of its size and
// place admits it (the soup's `cull` rows, padded once at build as
// trace/mt.py pads the MT sweeps' tile boxes: two 16-byte loads an
// instance). An entering ray moves into object space in the reference's
// float order (the direction is not normalized: t stays world-parametric)
// and tests each mesh tile face by face up to the tile's real face count
// (`tile_faces`: 1 + the index of its last face that is not all zero; an
// all-zero face has det = 0 and never hits, a degenerate face inside a
// mesh is still tested).
//
// One thread per ray, K7_THREADS a CTA, no shared memory and no
// block-wide synchronisation, so the pool's 32768 rays run in 512 CTAs.
// Each ray walks the instances in table order, its box test bounded by
// its best t so far (closest) or its tmax (any-hit); a warp runs an
// instance's tests only when one of its rays enters (the branch is then
// warp-uniform and skipped). The faces are read through L1 from the
// [T, 9, 128] soup; the entering lanes of a warp read the same face at
// once, one broadcast load. Each ray keeps its best in registers with
// strict `<` updates in face order, so the reference's order holds
// without a key: the least t; at equal t the earlier instance, then the
// lower prim; u and v as the reference's masked sums give them (+ 0.0f).
// An any-hit ray stops at its first hit.
//
// Timed in turns (tools/ab.py instanced-mt, PERF.md): 32- and 128-thread
// CTAs within 1.5% of 64; the padded boxes precomputed 19% faster than
// padding each box per ray on the 66-instance field, alike on the path;
// faces read as three float4 rows no faster than nine broadcast words. A
// binned schedule (rays listed per instance, (instance, tile, chunk)
// items, a 64-bit key merge, as mt_kernels.cu) was 1.75x slower on the
// trace-time path's recorded calls and 2x on the grid-8 field's floor
// rays, and faster only on rays into the field's 972-face towers, which
// no path traces through K7: it was not kept.
//
// Exactness of the cull. Skipping a (ray, instance) pair changes nothing
// unless the ray has an MT hit in the instance's object space with tmin < t <
// its bound there; the block vote tests such pairs and more, and a pair
// without such a hit leaves the ray's best (or occlusion) as it is. The world
// point o + t d of such a hit lies on the instance's world box up to rounding:
// the object-space ray (each coordinate a 4-term sum of products), the MT
// solve and the box (the float min / max of the transformed vertices) each
// round by a few eps = 2^-24 of the magnitudes involved, so the point lies
// within about d = 16 eps k (|o| + |t d| + |box|) ~ 1e-6 k (...) of the box, k
// the condition of the instance's 3 x 3 part. BOX_PAD grows the box by 1e-3 (1
// + max(size, |lo|, |hi|)) on each side, above d while k (|o| + |t d|) stays
// under ~1000 (1 + max(size, |lo|, |hi|)): ~70 times d on the trace-time
// Cornell (k = 1, |o| + |t d| < 20), over 100 times on the fields (k = 1, rays
// within ~100 units of a box ~10 from the origin). The hit point then lies
// inside the padded box, so the padded slab interval [tn, tf] holds t up to
// the rounding of tn and tf (a few eps of |t|, again far below the pad): t <
// bound gives tn <= bound + pad, t > tmin gives tf >= tmin - pad. A box of
// zero thickness (a Cornell wall, lo = hi on one axis) is padded like any
// other to 2 pad; a ray along the wall (that direction component 0, inv_dir
// 1e30) gets all of t from that slab when its origin lies inside it and none
// otherwise; a ray exactly in the plane of an axis-aligned face under an
// axis-aligned transform (the Cornell's and the fields') has det exactly 0 and
// never hits. Rays far outside that range fall outside the argument: the
// pool's shadow rays of lanes that missed start at o + 1e16 d, where neither
// the slab nor the MT test resolves a unit box; the pool reads none of their
// occlusion (it needs a hit), and there the cull's answer and the block vote's
// differ. The argument needs a determinant above its own rounding: a ray
// within rounding of a face's plane under a rotated transform can get a "hit"
// of any t from a determinant that is a rounding residue above DET_EPS; the
// reference's answer there depends on the other rays of its tile, and this
// kernel's equals its plain version's. A NaN in o or d makes every
// object-space coordinate NaN (each is a sum over all three), so det or u is
// NaN and no test passes: the cull's fminf / fmaxf may admit or drop such a
// ray to no effect. A ray with tmax above 1e30 that hits nothing in a tested
// tile keeps the miss row here, where the reference's tile minimum, seeded at
// 1e30, gives (1e30, the tile's first prim, ...); the tracer decodes both as a
// miss.
//
// Output [R, 8]: closest (t, prim, u, v, instance, 0, 0, 0), prim and
// instance as floats, miss = (tmax, -1, 0, 0, -1); any (occluded, 0, ...).
// Rays of 256-ray tiles at or past `count`, and rays with tmax <= tmin,
// write the initial row; rays past `count` inside a live tile are traced.
#include "mt.cuh"

namespace rt3c {

constexpr int ITILE = 128;
constexpr int INST_W = 20;
constexpr int K7_THREADS = 64;

struct K7Args {
  const float* rays;
  const int* count;
  const float* tris;        // [T, 9, ITILE]
  const float* table;       // [n_inst, INST_W]
  const int* inst_tiles;    // [n_inst, 2]
  const float4* cull;       // [n_inst, 2] padded boxes
  const int* tile_faces;    // [T]
  int n_inst;
  float* out;
};

// The ray's padded slab test of instance j's box (`cull`: lo - pad, pad;
// hi + pad, ordered), bounded by tcur.
__device__ __forceinline__ bool enters(const float4* cull, int j,
                                       const Ray& r, float ix, float iy,
                                       float iz, float tcur) {
  const float4 lo = __ldg(cull + 2 * j), hi = __ldg(cull + 2 * j + 1);
  const float t0x = (lo.x - r.ox) * ix, t1x = (hi.x - r.ox) * ix;
  const float t0y = (lo.y - r.oy) * iy, t1y = (hi.y - r.oy) * iy;
  const float t0z = (lo.z - r.oz) * iz, t1z = (hi.z - r.oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return hi.w != 0.0f && tn <= tf && tf >= r.tmin - lo.w &&
         tn <= tcur + lo.w;
}

// The ray in instance j's object space, in the reference's float order.
__device__ __forceinline__ Ray to_object(const float* table, int j,
                                         const Ray& r) {
  float a[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) a[c] = __ldg(table + INST_W * j + c);
  Ray q;
  q.ox = a[0] * r.ox + a[1] * r.oy + a[2] * r.oz + a[3];
  q.oy = a[4] * r.ox + a[5] * r.oy + a[6] * r.oz + a[7];
  q.oz = a[8] * r.ox + a[9] * r.oy + a[10] * r.oz + a[11];
  q.dx = a[0] * r.dx + a[1] * r.dy + a[2] * r.dz;
  q.dy = a[4] * r.dx + a[5] * r.dy + a[6] * r.dz;
  q.dz = a[8] * r.dx + a[9] * r.dy + a[10] * r.dz;
  q.tmin = r.tmin;
  q.tmax = r.tmax;
  return q;
}

__device__ __forceinline__ bool live_ray(const K7Args& s, int i,
                                         const Ray& r) {
  return (i / RAY_TILE) * RAY_TILE < __ldg(s.count) && r.tmax > r.tmin;
}

// One thread walks its ray through the instances.
template <bool kAny>
__global__ void __launch_bounds__(K7_THREADS)
    instanced_mt_kernel(K7Args s) {
  const int lane = blockIdx.x * K7_THREADS + threadIdx.x;
  const Ray r = load_ray(s.rays, lane);
  float best_t = r.tmax, best_prim = -1.0f, best_u = 0.0f, best_v = 0.0f,
        best_inst = -1.0f;
  bool occ = false;
  if (live_ray(s, lane, r)) {
    const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
    for (int j = 0; j < s.n_inst && !occ; ++j) {
      if (!enters(s.cull, j, r, ix, iy, iz, kAny ? r.tmax : best_t))
        continue;
      const Ray q = to_object(s.table, j, r);
      const int start = __ldg(s.inst_tiles + 2 * j);
      const int end = start + __ldg(s.inst_tiles + 2 * j + 1);
      for (int k = start; k < end && !occ; ++k) {
        const float* tile = s.tris + (size_t)k * 9 * ITILE;
        const int nf = __ldg(s.tile_faces + k);
        for (int f = 0; f < nf; ++f) {
          float t, u, v;
          const bool h = mt_test_tri(
              q, kAny ? r.tmax : best_t, __ldg(tile + f),
              __ldg(tile + ITILE + f), __ldg(tile + 2 * ITILE + f),
              __ldg(tile + 3 * ITILE + f), __ldg(tile + 4 * ITILE + f),
              __ldg(tile + 5 * ITILE + f), __ldg(tile + 6 * ITILE + f),
              __ldg(tile + 7 * ITILE + f), __ldg(tile + 8 * ITILE + f), t, u,
              v);
          if (!h) continue;
          if (kAny) {
            occ = true;
            break;
          }
          best_t = t;
          best_prim = (float)(k * ITILE + f);
          best_u = u + 0.0f;
          best_v = v + 0.0f;
          best_inst = (float)j;
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(s.out + 8 * (size_t)lane);
  if (kAny)
    o[0] = make_float4(occ ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
  else
    o[0] = make_float4(best_t, best_prim, best_u, best_v);
  o[1] = make_float4(kAny ? 0.0f : best_inst, 0.0f, 0.0f, 0.0f);
}

}  // namespace rt3c

// rays [n_rays, 8], n_rays a multiple of 256; count int32 [1] on the
// device; tris [T, 9, 128] the object-space soup; table [n_inst, 20];
// inst_tiles int32 [n_inst, 2] (first tile, tile count) of each instance's
// mesh; cull [n_inst, 8] each instance's padded world box (lo - pad, pad,
// hi + pad, ordered); tile_faces int32 [T] the real faces of each tile;
// out [n_rays, 8].
extern "C" int rt3c_instanced_mt(int device, int any, const float* rays,
                                 int n_rays, const int* count,
                                 const float* tris, const float* table,
                                 const int* inst_tiles, const float* cull,
                                 const int* tile_faces, int n_inst,
                                 float* out, void* stream) {
  if (n_rays % rt3c::RAY_TILE != 0 || n_inst < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const rt3c::K7Args s{rays,       count, tris, table, inst_tiles,
                       reinterpret_cast<const float4*>(cull), tile_faces,
                       n_inst,     out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_rays / rt3c::K7_THREADS);
  if (any)
    rt3c::instanced_mt_kernel<true><<<grid, rt3c::K7_THREADS, 0, st>>>(s);
  else
    rt3c::instanced_mt_kernel<false><<<grid, rt3c::K7_THREADS, 0, st>>>(s);
  return (int)cudaGetLastError();
}
