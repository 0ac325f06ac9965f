// Moller-Trumbore test and the two-level tile-culled sweep, shared by the
// MT kernels (mt_kernels.cu) and the refill megakernel (megakernel.cu).
//
// Replaces the Pallas helpers of rendertoy3c_tpu/trace/pallas_mt.py:
// _mt_test_cols (:119), _tile_box_hits (:175), _culled_sweep (:195) and
// _inv_cols (:247). One thread carries one ray; a 256-thread block is one
// ray tile (RAY_TILE), and the block walks the triangle tiles in order,
// staging each [9, CT] tile in shared memory so every thread reads the
// same triangle at the same time (a broadcast, no bank conflicts).
//
// Float order: every expression keeps the left-to-right order of the JAX
// code, and the build passes --fmad=false, so no a*b+c is contracted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt3c {

constexpr int RAY_TILE = 256;
constexpr int SUPER_TILE = 8;
constexpr int MAX_CT = 512;
constexpr float BIG = 1e30f;
constexpr float DET_EPS = 1e-10f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// Triangle soup of build_tri_soup: tris [n_tiles, 9, ct] component-major
// (v0.xyz e1.xyz e2.xyz rows), per-tile boxes aabb [ceil8(n_tiles), 8]
// (lo.xyz hi.xyz pad2) and supertile boxes [ceil8(n_tiles)/8, 8].
struct Soup {
  const float* tris;
  const float* aabb;
  const float* super_aabb;
  int n_tiles;
  int ct;
};

__device__ __forceinline__ Ray load_ray(const float* rays, int i) {
  const float4* p = reinterpret_cast<const float4*>(rays + 8 * (size_t)i);
  float4 a = p[0];
  float4 b = p[1];
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : BIG;
}

// One ray x one triangle of a staged tile (tile = smem [9][ct]).
// Returns the hit predicate of _mt_test_cols with `tmax` as the upper bound.
__device__ __forceinline__ bool mt_test(const Ray& r, float tmax,
                                        const float* tile, int ct, int j,
                                        float& t, float& u, float& v) {
  const float v0x = tile[0 * ct + j], v0y = tile[1 * ct + j],
              v0z = tile[2 * ct + j];
  const float e1x = tile[3 * ct + j], e1y = tile[4 * ct + j],
              e1z = tile[5 * ct + j];
  const float e2x = tile[6 * ct + j], e2y = tile[7 * ct + j],
              e2z = tile[8 * ct + j];
  // pvec = d x e2
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > DET_EPS;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  // tvec = o - v0
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > r.tmin) && (t < tmax);
}

// Slab test of _tile_box_hits for one ray. The min/max form alone passes
// an inverted box (an empty tile: lo = +1e30, hi = -1e30) as an infinite
// box, so the box must also be ordered (lo <= hi) to count.
__device__ __forceinline__ bool box_hit(const float* box, const Ray& r,
                                        float ix, float iy, float iz,
                                        float tcur) {
  const float t0x = (box[0] - r.ox) * ix;
  const float t1x = (box[3] - r.ox) * ix;
  const float t0y = (box[1] - r.oy) * iy;
  const float t1y = (box[4] - r.oy) * iy;
  const float t0z = (box[2] - r.oz) * iz;
  const float t1z = (box[5] - r.oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  const bool ordered = box[0] <= box[3];
  return ordered && (tn <= tf) && (tf >= r.tmin) && (tn <= tcur);
}

// Does any ray of the block hit the box? Must be reached by every thread.
__device__ __forceinline__ bool block_box_vote(const float* box, const Ray& r,
                                               float ix, float iy, float iz,
                                               float tcur) {
  return __syncthreads_or(box_hit(box, r, ix, iy, iz, tcur)) != 0;
}

// Stage tile k of the soup into shared memory (every thread participates).
__device__ __forceinline__ void stage_tile(const Soup& s, int k, float* smem) {
  const int n = 9 * s.ct;
  const float* src = s.tris + (size_t)k * n;
  __syncthreads();  // the previous tile's readers are done
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = src[i];
  __syncthreads();
}

// _culled_sweep: visits the triangle tiles a block's rays may hit, in tile
// order. `live` (block-uniform) is the compaction gate: tiles of rays at or
// past the live count skip the whole sweep. tcur() is the ray's current
// upper t bound, visit(tile_smem, k) runs the per-thread test of tile k.
// The specialisation by tile count matches the JAX sweep: one tile runs
// unconditionally, up to 16 tiles use one cull level, more use two.
template <class Tcur, class Visit>
__device__ __forceinline__ void culled_sweep(const Soup& s, float* smem,
                                             const Ray& r, float ix, float iy,
                                             float iz, bool live, Tcur tcur,
                                             Visit visit) {
  if (!live) return;
  if (s.n_tiles == 1) {
    stage_tile(s, 0, smem);
    visit(smem, 0);
    return;
  }
  if (s.n_tiles <= 2 * SUPER_TILE) {
    for (int k = 0; k < s.n_tiles; ++k) {
      if (block_box_vote(s.aabb + 8 * k, r, ix, iy, iz, tcur())) {
        stage_tile(s, k, smem);
        visit(smem, k);
      }
    }
    return;
  }
  const int n_super = (s.n_tiles + SUPER_TILE - 1) / SUPER_TILE;
  for (int ks = 0; ks < n_super; ++ks) {
    if (!block_box_vote(s.super_aabb + 8 * ks, r, ix, iy, iz, tcur()))
      continue;
    for (int j = 0; j < SUPER_TILE; ++j) {
      const int k = ks * SUPER_TILE + j;
      if (block_box_vote(s.aabb + 8 * k, r, ix, iy, iz, tcur()) &&
          k < s.n_tiles) {
        stage_tile(s, k, smem);
        visit(smem, k);
      }
    }
  }
}

// Closest hit of one ray (carried in `best`): min t, lowest prim at
// equal t. The running best_t bounds each test, so a later triangle at the
// same t never replaces an earlier (lower) prim.
struct ClosestHit {
  float t, prim, u, v;
};

__device__ __forceinline__ void closest_tile(const Ray& r, const float* tile,
                                             int ct, int prim_base,
                                             ClosestHit& best) {
  for (int j = 0; j < ct; ++j) {
    float t, u, v;
    if (mt_test(r, best.t, tile, ct, j, t, u, v)) {
      best.t = t;
      best.prim = (float)(prim_base + j);
      best.u = u;
      best.v = v;
    }
  }
}

__device__ __forceinline__ bool any_tile(const Ray& r, const float* tile,
                                         int ct) {
  for (int j = 0; j < ct; ++j) {
    float t, u, v;
    if (mt_test(r, r.tmax, tile, ct, j, t, u, v)) return true;
  }
  return false;
}

// Full closest sweep (the _closest_kernel body). Miss lanes keep t = tmax.
__device__ __forceinline__ ClosestHit sweep_closest(const Soup& s, float* smem,
                                                    const Ray& r, bool live) {
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  ClosestHit best{r.tmax, -1.0f, 0.0f, 0.0f};
  culled_sweep(
      s, smem, r, ix, iy, iz, live, [&]() { return best.t; },
      [&](const float* tile, int k) {
        closest_tile(r, tile, s.ct, k * s.ct, best);
      });
  return best;
}

// Full any-hit sweep (the _any_kernel body). `test` (per thread) skips the
// triangle tests of a ray that cannot hit anything (tmax <= tmin); the ray
// still takes part in the block's cull votes, as in the JAX sweep.
__device__ __forceinline__ bool sweep_any(const Soup& s, float* smem,
                                          const Ray& r, bool live, bool test) {
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  bool occ = false;
  culled_sweep(
      s, smem, r, ix, iy, iz, live, [&]() { return r.tmax; },
      [&](const float* tile, int) {
        if (test && !occ) occ = any_tile(r, tile, s.ct);
      });
  return occ;
}

}  // namespace rt3c
