// Moller-Trumbore tests and the two-level tile-culled sweep. The test
// (mt_test_tri) serves every MT kernel; the in-block sweep (culled_sweep,
// stage_tile, mt_test, box_hit) serves the megakernels (megakernel.cuh:
// K4/K5), whose soups are a few tiles. K1/K2 and K3 (mt_kernels.cu) bin
// rays by tile instead, and K7 (instanced_mt.cu) culls instances ray by
// ray: both test padded boxes, ray by ray, where a block's vote was.
//
// Replaces the Pallas helpers of rendertoy3c_tpu/trace/pallas_mt.py:
// _mt_test_cols (:119), _mt_test_motion (:502), _tile_box_hits (:175),
// _culled_sweep (:195) and _inv_cols (:247). In the sweep a group of G
// threads (consecutive in a warp) carries one ray; a block is one ray
// tile (RAY_TILE = 256 rays of G threads each), and the block walks the
// triangle tiles in order, staging each [9, CT] tile (both keys' tiles
// for motion) in shared memory so every thread reads the same triangle
// at the same time (a broadcast, no bank conflicts). Only a tile's real
// faces are staged and tested: the soup's columns past its face count are
// all zero (checked when the megakernels' tables are built), so det = 0
// and they never hit. Thread g of a group tests the columns j = g mod G
// in order, bounded by its own best t; after each tile the group merges
// its hits to the least (t, prim) with shuffles. That is the serial
// scan's answer (min t, the lowest prim at equal t: the strict t < best
// keeps the first), and every thread of the group carries it into the
// next tile's cull vote, as the serial scan would. An any-hit group ORs
// its threads' results after each tile.
//
// Float order: every expression keeps the left-to-right order of the JAX
// code, and the build passes --fmad=false, so no a*b+c is contracted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt3c {

constexpr int RAY_TILE = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MOTION_RAY_TILE = 128;
constexpr int SUPER_TILE = 8;
constexpr int MAX_CT = 512;
constexpr float BIG = 1e30f;
constexpr float DET_EPS = 1e-10f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// Triangle soup of build_tri_soup: tris [n_tiles, 9, ct] component-major
// (v0.xyz e1.xyz e2.xyz rows), per-tile boxes aabb [ceil8(n_tiles), 8]
// (lo.xyz hi.xyz pad2) and supertile boxes [ceil8(n_tiles)/8, 8];
// n_faces real faces, the columns past them all zero.
struct Soup {
  const float* tris;
  const float* aabb;
  const float* super_aabb;
  int n_tiles;
  int ct;
  int n_faces;
};

// The 2-key soup of build_motion_soup: both keys tiled alike, and the
// union of both keys' boxes for the cull.
struct MotionSoup {
  const float* tris0;
  const float* tris1;
  const float* aabb;
  const float* super_aabb;
  int n_tiles;
  int ct;
  int n_faces;
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

// One ray x one triangle (v0, e1, e2). Returns the hit predicate of
// _mt_test_cols with `tmax` as the upper bound.
__device__ __forceinline__ bool mt_test_tri(const Ray& r, float tmax,
                                            float v0x, float v0y, float v0z,
                                            float e1x, float e1y, float e1z,
                                            float e2x, float e2y, float e2z,
                                            float& t, float& u, float& v) {
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

// Triangle j of a staged tile (tile = smem [9][ct]).
__device__ __forceinline__ bool mt_test(const Ray& r, float tmax,
                                        const float* tile, int ct, int j,
                                        float& t, float& u, float& v) {
  return mt_test_tri(r, tmax, tile[0 * ct + j], tile[1 * ct + j],
                     tile[2 * ct + j], tile[3 * ct + j], tile[4 * ct + j],
                     tile[5 * ct + j], tile[6 * ct + j], tile[7 * ct + j],
                     tile[8 * ct + j], t, u, v);
}

// _mt_test_motion: triangle j lerped to the ray's time, component by
// component, r0 + (r1 - r0) * time.
__device__ __forceinline__ bool mt_test_motion(const Ray& r, float tmax,
                                               float time, const float* tile0,
                                               const float* tile1, int ct,
                                               int j, float& t, float& u,
                                               float& v) {
  float c[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float r0 = tile0[q * ct + j];
    const float r1 = tile1[q * ct + j];
    c[q] = r0 + (r1 - r0) * time;
  }
  return mt_test_tri(r, tmax, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7],
                     c[8], t, u, v);
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

// The real faces of tile k: the columns below n_faces.
__device__ __forceinline__ int tile_faces(int n_faces, int k, int ct) {
  return min(ct, n_faces - k * ct);
}

// Stage the real faces nf of tile k of a [n_tiles, 9, ct] table into
// shared memory, in the tile's [9, ct] layout (every thread participates).
__device__ __forceinline__ void stage_tile(const float* tris, int k, int ct,
                                           int nf, float* smem) {
  const int n = 9 * nf;
  const float* src = tris + (size_t)k * 9 * ct;
  __syncthreads();  // the previous tile's readers are done
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = i / nf, j = i - q * nf;
    smem[q * ct + j] = src[q * ct + j];
  }
  __syncthreads();
}

// _culled_sweep: visits the triangle tiles a block's rays may hit, in tile
// order. `live` (block-uniform) is the compaction gate: tiles of rays at or
// past the live count skip the whole sweep. tcur() is the ray's current
// upper t bound, stage(k) stages tile k, visit(k) runs the per-thread test
// of the staged tile k. The specialisation by tile count matches the JAX
// sweep: one tile runs unconditionally, up to 16 tiles use one cull level,
// more use two.
template <class Tcur, class Stage, class Visit>
__device__ __forceinline__ void culled_sweep(const float* aabb,
                                             const float* super_aabb,
                                             int n_tiles, const Ray& r,
                                             bool live, Tcur tcur,
                                             Stage stage, Visit visit) {
  if (!live) return;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  if (n_tiles == 1) {
    stage(0);
    visit(0);
    return;
  }
  if (n_tiles <= 2 * SUPER_TILE) {
    for (int k = 0; k < n_tiles; ++k) {
      if (block_box_vote(aabb + 8 * k, r, ix, iy, iz, tcur())) {
        stage(k);
        visit(k);
      }
    }
    return;
  }
  const int n_super = (n_tiles + SUPER_TILE - 1) / SUPER_TILE;
  for (int ks = 0; ks < n_super; ++ks) {
    if (!block_box_vote(super_aabb + 8 * ks, r, ix, iy, iz, tcur()))
      continue;
    for (int j = 0; j < SUPER_TILE; ++j) {
      const int k = ks * SUPER_TILE + j;
      if (block_box_vote(aabb + 8 * k, r, ix, iy, iz, tcur()) &&
          k < n_tiles) {
        stage(k);
        visit(k);
      }
    }
  }
}

// Closest hit of one ray: min t, lowest prim at equal t. The running
// best_t bounds each test, so a later triangle at the same t never
// replaces an earlier (lower) prim. test(j, tmax, t, u, v) tests triangle
// j of the staged tile. Miss lanes keep t = tmax.
struct ClosestHit {
  float t, prim, u, v;
};

// The group's least hit by (t, prim), on every thread of the group (G
// consecutive threads of a warp; every thread of the warp takes part).
template <int G>
__device__ __forceinline__ void group_min(ClosestHit& b) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float t = __shfl_xor_sync(FULL_MASK, b.t, off);
    const float p = __shfl_xor_sync(FULL_MASK, b.prim, off);
    const float u = __shfl_xor_sync(FULL_MASK, b.u, off);
    const float v = __shfl_xor_sync(FULL_MASK, b.v, off);
    if (t < b.t || (t == b.t && p < b.prim)) b = ClosestHit{t, p, u, v};
  }
}

template <int G>
__device__ __forceinline__ bool group_any(bool x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const int o = __shfl_xor_sync(FULL_MASK, (int)x, off);
    x = x || o != 0;
  }
  return x;
}

template <int G, class Stage, class Test>
__device__ __forceinline__ ClosestHit sweep_closest_with(
    const float* aabb, const float* super_aabb, int n_tiles, int ct,
    int n_faces, const Ray& r, bool live, Stage stage, Test test) {
  ClosestHit best{r.tmax, -1.0f, 0.0f, 0.0f};
  const int g = threadIdx.x % G;
  culled_sweep(
      aabb, super_aabb, n_tiles, r, live, [&]() { return best.t; },
      [&](int k) { stage(k, tile_faces(n_faces, k, ct)); },
      [&](int k) {
        const int nf = tile_faces(n_faces, k, ct);
        for (int j = g; j < nf; j += G) {
          float t, u, v;
          if (test(j, best.t, t, u, v)) {
            best.t = t;
            best.prim = (float)(k * ct + j);
            best.u = u;
            best.v = v;
          }
        }
        group_min<G>(best);
      });
  return best;
}

// Any hit of one ray below its tmax. `want` (per ray) skips the triangle
// tests of a ray that needs none (a lane with no shadow ray); the ray
// still takes part in the block's cull votes, as in the JAX sweep.
template <int G, class Stage, class Test>
__device__ __forceinline__ bool sweep_any_with(const float* aabb,
                                               const float* super_aabb,
                                               int n_tiles, int ct,
                                               int n_faces, const Ray& r,
                                               bool live, bool want,
                                               Stage stage, Test test) {
  bool occ = false;
  const int g = threadIdx.x % G;
  culled_sweep(
      aabb, super_aabb, n_tiles, r, live, [&]() { return r.tmax; },
      [&](int k) { stage(k, tile_faces(n_faces, k, ct)); },
      [&](int k) {
        if (want && !occ) {
          const int nf = tile_faces(n_faces, k, ct);
          for (int j = g; j < nf; j += G) {
            float t, u, v;
            if (test(j, r.tmax, t, u, v)) {
              occ = true;
              break;
            }
          }
        }
        occ = group_any<G>(occ);
      });
  return occ;
}

// The static sweeps (the _closest_kernel / _any_kernel bodies).
template <int G>
__device__ __forceinline__ ClosestHit sweep_closest(const Soup& s, float* smem,
                                                    const Ray& r, bool live) {
  return sweep_closest_with<G>(
      s.aabb, s.super_aabb, s.n_tiles, s.ct, s.n_faces, r, live,
      [&](int k, int nf) { stage_tile(s.tris, k, s.ct, nf, smem); },
      [&](int j, float tmax, float& t, float& u, float& v) {
        return mt_test(r, tmax, smem, s.ct, j, t, u, v);
      });
}

template <int G>
__device__ __forceinline__ bool sweep_any(const Soup& s, float* smem,
                                          const Ray& r, bool live, bool want) {
  return sweep_any_with<G>(
      s.aabb, s.super_aabb, s.n_tiles, s.ct, s.n_faces, r, live, want,
      [&](int k, int nf) { stage_tile(s.tris, k, s.ct, nf, smem); },
      [&](int j, float tmax, float& t, float& u, float& v) {
        return mt_test(r, tmax, smem, s.ct, j, t, u, v);
      });
}

// The motion sweeps (the _closest_kernel_motion / _any_kernel_motion
// bodies): both keys' tiles staged, triangles lerped to `time`.
template <int G>
__device__ __forceinline__ ClosestHit sweep_closest_motion(
    const MotionSoup& s, float* smem0, float* smem1, const Ray& r, float time,
    bool live) {
  return sweep_closest_with<G>(
      s.aabb, s.super_aabb, s.n_tiles, s.ct, s.n_faces, r, live,
      [&](int k, int nf) {
        stage_tile(s.tris0, k, s.ct, nf, smem0);
        stage_tile(s.tris1, k, s.ct, nf, smem1);
      },
      [&](int j, float tmax, float& t, float& u, float& v) {
        return mt_test_motion(r, tmax, time, smem0, smem1, s.ct, j, t, u, v);
      });
}

template <int G>
__device__ __forceinline__ bool sweep_any_motion(const MotionSoup& s,
                                                 float* smem0, float* smem1,
                                                 const Ray& r, float time,
                                                 bool live, bool want) {
  return sweep_any_with<G>(
      s.aabb, s.super_aabb, s.n_tiles, s.ct, s.n_faces, r, live, want,
      [&](int k, int nf) {
        stage_tile(s.tris0, k, s.ct, nf, smem0);
        stage_tile(s.tris1, k, s.ct, nf, smem1);
      },
      [&](int j, float tmax, float& t, float& u, float& v) {
        return mt_test_motion(r, tmax, time, smem0, smem1, s.ct, j, t, u, v);
      });
}

}  // namespace rt3c
