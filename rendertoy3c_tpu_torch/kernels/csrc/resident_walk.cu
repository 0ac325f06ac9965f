// K8: the resident-table block walk, closest and any hit.
//
// Replaces rendertoy3c_tpu/trace/pallas_walk.py `_walk_call` (pallas_call
// :338) with its kernels `_closest_kernel` (:196) and `_any_kernel` (:271).
// Its plain versions are trace/residentwalk.py `walk_closest_ref` and
// `walk_any_ref`; the pass loops around a launch are trace_closest_walk
// and trace_any_walk there.
//
// One warp is one block of 32 rays (lane = ray); a CTA holds WARPS such
// blocks. Per block:
//   1. the block's rays (origin, 1 / direction, tmin, tmax) go to shared
//      memory; lane j then takes leaves j, j + 32, ... and for each the
//      minimum over the 32 rays of their slab entries (BIG on a miss), in
//      ray order, into the block's row emin [Lp] in shared memory;
//   2. a dead block (its first ray at or past *count) has a row of BIG;
//      leaves at or below the resume cursor (entry er, id ir,
//      lexicographic) are masked to BIG;
//   3. up to T rounds: the row's minimum m and its first leaf lid (warp
//      reductions); the closest walk stops once m is not below the largest
//      best t of the block's rays, the any walk once m is BIG or every ray
//      is occluded. The leaf's 9 x 128 row goes to shared memory, each
//      lane runs Moller-Trumbore over its 128 faces in order (closest:
//      tmax = its best t, the first face at the least t; any: tmax = tmin
//      once occluded), the leaf leaves the row and becomes the cursor;
//   4. each lane writes its ray's row (t, prim, u, v or occlusion, 0, 0,
//      0), lane 0 the block's cursor row (done, last m, last lid).
// A round whose condition fails changes nothing, so the walk stops at the
// first such round, where the reference skips the remaining ones.
//
// Agreement with the plain version, bit for bit: the same float
// operations in the same order under --fmad=false and IEEE division
// (1 / d where |d| > 1e-20 else BIG, 1 / det where |det| > 1e-10 else 0);
// min and max propagate NaN and return their first operand at a tie, as
// torch.minimum / torch.maximum (fminf / fmaxf drop NaN); the row minimum
// runs in ray order; the hit's u and v are the reference's masked sums,
// which turn -0.0 into +0.0 (u + 0.0f).
//
// Bound: the slab pass, ~30 operations per (ray, leaf box) pair, and the
// rounds, ~40 per (ray, triangle) test; the bytes of the rays, the table
// (rows ~1.77 MB at 49k faces, in L2) and the outputs.
#include <cstdint>

#include <cuda_runtime.h>

namespace rt3c {

namespace rw {

constexpr int RT = 32;     // rays per block: the warp
constexpr int LEAF = 128;  // faces per leaf row
constexpr float BIG = 1e30f;
constexpr float DET_EPS = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum: NaN propagates, the first operand wins a
// tie
__device__ __forceinline__ float tmin2(float a, float b) {
  if (isnan(a) || isnan(b)) return qnan();
  return b < a ? b : a;
}
__device__ __forceinline__ float tmax2(float a, float b) {
  if (isnan(a) || isnan(b)) return qnan();
  return b > a ? b : a;
}

// warp-wide NaN-propagating min / max of one value per lane
__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = tmin2(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = tmax2(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ int warp_imin(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// The shared memory of one warp: its rays, its row, one leaf row.
struct WarpSmem {
  float* ray;   // [8][RT]: ox oy oz ix iy iz tmin tmax
  float* emin;  // [lp]
  float* leaf;  // [9][LEAF]
};

// Steps 1-2: the block's masked row emin in shared memory.
__device__ void block_row(const WarpSmem& sm, const float* aabb, int lp,
                          bool live, float er, int ir, int lane) {
  for (int l = lane; l < lp; l += RT) {
    const float lo[3] = {aabb[l], aabb[lp + l], aabb[2 * lp + l]};
    const float hi[3] = {aabb[3 * lp + l], aabb[4 * lp + l], aabb[5 * lp + l]};
    float e = BIG;
    for (int r = 0; r < RT; ++r) {
      float tn = 0.f, tf = 0.f;
      for (int c = 0; c < 3; ++c) {
        const float o = sm.ray[c * RT + r];
        const float inv = sm.ray[(3 + c) * RT + r];
        const float t0 = (lo[c] - o) * inv;
        const float t1 = (hi[c] - o) * inv;
        const float cn = tmin2(t0, t1);
        const float cf = tmax2(t0, t1);
        tn = c == 0 ? cn : tmax2(tn, cn);
        tf = c == 0 ? cf : tmin2(tf, cf);
      }
      const float rtmin = sm.ray[6 * RT + r];
      const float rtmax = sm.ray[7 * RT + r];
      const bool ok = (tn <= tf) && (tf > rtmin) && (tn < rtmax);
      const float ent = ok ? tmax2(tn, rtmin) : BIG;
      // the minimum over the rays, in ray order (NaN propagates)
      if (r == 0)
        e = ent;
      else
        e = tmin2(e, ent);
    }
    if (!live) e = BIG;
    if ((e < er) || ((e == er) && (l <= ir))) e = BIG;
    sm.emin[l] = e;
  }
  __syncwarp();
}

// The row's minimum and its first leaf (lp where no entry is <= m).
__device__ __forceinline__ void row_argmin(const WarpSmem& sm, int lp,
                                           int lane, float* m_out,
                                           int* lid_out) {
  float m = sm.emin[lane];
  for (int l = lane + RT; l < lp; l += RT) m = tmin2(m, sm.emin[l]);
  m = warp_min(m);
  int idx = lp;
  for (int l = lane; l < lp; l += RT)
    if (sm.emin[l] <= m) {
      idx = l;
      break;
    }
  *m_out = m;
  *lid_out = warp_imin(idx);
}

__device__ __forceinline__ void load_leaf(const WarpSmem& sm,
                                          const float* rows, int lid,
                                          int lane) {
  const float* src = rows + (size_t)lid * 9 * LEAF;
  for (int k = lane; k < 9 * LEAF; k += RT) sm.leaf[k] = src[k];
  __syncwarp();
}

// Moller-Trumbore of one ray against face k of the shared leaf row, in the
// reference's operation order (pallas_walk.py `_mt_block`).
struct Mt {
  float t, u, v;
  bool hit;
};

__device__ __forceinline__ Mt mt_face(const float* leaf, int k, float ox,
                                      float oy, float oz, float dx, float dy,
                                      float dz, float tmin, float tmax) {
  const float v0x = leaf[0 * LEAF + k], v0y = leaf[1 * LEAF + k],
              v0z = leaf[2 * LEAF + k];
  const float e1x = leaf[3 * LEAF + k], e1y = leaf[4 * LEAF + k],
              e1z = leaf[5 * LEAF + k];
  const float e2x = leaf[6 * LEAF + k], e2y = leaf[7 * LEAF + k],
              e2z = leaf[8 * LEAF + k];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > DET_EPS;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  Mt r;
  r.u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  r.v = (dx * qx + dy * qy + dz * qz) * inv_det;
  r.t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  r.hit = ok && (r.u >= 0.0f) && (r.v >= 0.0f) && (r.u + r.v <= 1.0f) &&
          (r.t > tmin) && (r.t < tmax);
  return r;
}

template <bool kAny>
__global__ void resident_walk_kernel(const int* __restrict__ count,
                                     const float* __restrict__ er_in,
                                     const int* __restrict__ ir_in,
                                     const float* __restrict__ rays, int n_blk,
                                     const float* __restrict__ rows,
                                     const float* __restrict__ aabb, int lp,
                                     int t_rounds, float* __restrict__ out,
                                     float* __restrict__ cur) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / RT;
  const int lane = threadIdx.x % RT;
  const int blk = blockIdx.x * (blockDim.x / RT) + warp;
  if (blk >= n_blk) return;  // the whole warp leaves together
  float* base = smem + (size_t)warp * (8 * RT + lp + 9 * LEAF);
  const WarpSmem sm{base, base + 8 * RT, base + 8 * RT + lp};

  const int ray = blk * RT + lane;
  const float* rr = rays + (size_t)ray * 8;
  const float ox = rr[0], oy = rr[1], oz = rr[2];
  const float dx = rr[3], dy = rr[4], dz = rr[5];
  const float tmin = rr[6], tmax = rr[7];
  const float d3[3] = {dx, dy, dz};
  const float o3[3] = {ox, oy, oz};
  for (int c = 0; c < 3; ++c) {
    sm.ray[c * RT + lane] = o3[c];
    sm.ray[(3 + c) * RT + lane] =
        fabsf(d3[c]) > 1e-20f ? 1.0f / d3[c] : BIG;
  }
  sm.ray[6 * RT + lane] = tmin;
  sm.ray[7 * RT + lane] = tmax;
  __syncwarp();

  const float er = er_in[blk];
  const int ir = ir_in[blk];
  block_row(sm, aabb, lp, blk * RT < count[0], er, ir, lane);

  float ce = er;
  float ci = (float)ir;
  // closest: best t (the ray's tmax on entry), prim, u, v; any: occlusion
  float best_t = tmax, prim = -1.0f, bu = 0.0f, bv = 0.0f;
  float occ = 0.0f;
  for (int j = 0; j < t_rounds; ++j) {
    float m;
    int lid;
    row_argmin(sm, lp, lane, &m, &lid);
    const bool todo = kAny ? (m < BIG) && (warp_min(occ) < 1.0f)
                           : m < warp_max(best_t);
    if (!todo) break;  // the state is unchanged: every later round skips
    load_leaf(sm, rows, lid, lane);
    if (kAny) {
      if (!(occ > 0.0f)) {
        bool any = false;
        for (int k = 0; k < LEAF && !any; ++k)
          any = mt_face(sm.leaf, k, ox, oy, oz, dx, dy, dz, tmin, tmax).hit;
        if (any) occ = 1.0f;
      }
    } else {
      // the first face at the least t (BIG where none is hit)
      Mt f = mt_face(sm.leaf, 0, ox, oy, oz, dx, dy, dz, tmin, best_t);
      float t_c = f.hit ? f.t : BIG;
      int lane_c = 0;
      float u_c = f.u, v_c = f.v;
      for (int k = 1; k < LEAF; ++k) {
        f = mt_face(sm.leaf, k, ox, oy, oz, dx, dy, dz, tmin, best_t);
        const float tt = f.hit ? f.t : BIG;
        if (tt < t_c) {
          t_c = tt;
          lane_c = k;
          u_c = f.u;
          v_c = f.v;
        }
      }
      if (t_c < best_t) {
        best_t = t_c;
        prim = (float)LEAF * (float)lid + (float)lane_c;
        bu = u_c + 0.0f;
        bv = v_c + 0.0f;
      }
    }
    __syncwarp();
    if (lane == 0) sm.emin[lid] = BIG;
    __syncwarp();
    ce = m;
    ci = (float)lid;
  }

  float row_min = sm.emin[lane];
  for (int l = lane + RT; l < lp; l += RT) row_min = tmin2(row_min, sm.emin[l]);
  row_min = warp_min(row_min);
  float done;
  float* o = out + (size_t)ray * 4;
  if (kAny) {
    done = ((row_min < BIG) && (warp_min(occ) < 1.0f)) ? 0.0f : 1.0f;
    o[0] = occ;
    o[1] = 0.0f;
    o[2] = 0.0f;
    o[3] = 0.0f;
  } else {
    done = row_min < warp_max(best_t) ? 0.0f : 1.0f;
    o[0] = best_t;
    o[1] = prim;
    o[2] = bu;
    o[3] = bv;
  }
  if (lane < 8) {
    const float vals[3] = {done, ce, ci};
    cur[(size_t)blk * 8 + lane] = lane < 3 ? vals[lane] : 0.0f;
  }
}

}  // namespace rw

}  // namespace rt3c

// One K8 launch over n_blk blocks of 32 rays [n_blk * 32, 8]. rows: [L, 9,
// 128] leaf rows; aabb: [8, lp] leaf boxes; er/ir: the blocks' cursors;
// count: the live ray count on the device. Writes out [n_blk * 32, 4] and
// cur [n_blk, 8]. Returns a cudaError_t.
extern "C" int rt3c_resident_walk(int device, int any, const int* count,
                                  const float* er, const int* ir,
                                  const float* rays, int n_blk,
                                  const float* rows, const float* aabb,
                                  int lp, int t_rounds, float* out,
                                  float* cur, void* stream) {
  using namespace rt3c::rw;
  if (lp < RT || lp % RT != 0 || t_rounds < 0 || n_blk < 0)
    return (int)cudaErrorInvalidValue;
  if (n_blk == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t per_warp = (size_t)(8 * RT + lp + 9 * LEAF) * sizeof(float);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  if (warps * per_warp > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_blk + warps - 1) / warps);
  const dim3 block(warps * RT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any)
    resident_walk_kernel<true><<<grid, block, warps * per_warp, s>>>(
        count, er, ir, rays, n_blk, rows, aabb, lp, t_rounds, out, cur);
  else
    resident_walk_kernel<false><<<grid, block, warps * per_warp, s>>>(
        count, er, ir, rays, n_blk, rows, aabb, lp, t_rounds, out, cur);
  return (int)cudaGetLastError();
}
