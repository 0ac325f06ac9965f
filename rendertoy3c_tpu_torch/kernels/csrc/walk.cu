// K9: the walk pool's rounds between two phase boundaries.
//
// Replaces the per-ray walk of the hierwalk band, which the TPU runs as a
// jnp loop and not as a Pallas kernel: rendertoy3c_tpu/integrate/
// walkpool.py `_walk_round` (:363) inside `_render_pipepool`'s pipe_round
// (:1169-1306), the same round as trace/hierwalk.py `_walk` (:526). Its
// plain version is integrate/walkpool.py `_pipe_rounds_ref`.
//
// One thread per pool lane runs `rounds` rounds; a lane's rounds touch
// only its own state, so the launch needs no synchronisation. A round:
//   1. launch: a free scratch (cur < 0) takes the pending walk of the
//      lane's first path that has one (ray, time, mode; best t = the
//      ray's tmax, no prim, root row);
//   2. the walk round: fetch the 128-f32 row of the current node; on a
//      leaf, 14 Moller-Trumbore tests (7 on a 2-key leaf, the row lerped
//      by the walk's time first), the lowest lane winning at equal t; on
//      a directory, the slab tests of its 16 or 20 children against the
//      pruning cut, written as the pending entries of its level; then the
//      ordered pop of the nearest entry at the deepest level (the lowest
//      slot at a tie), every entry past the cut and the popped slot
//      written back as _BIG. A shadow lane that found an occluder cuts at
//      _prune_cut(0) and pops nothing;
//   3. stash: a finished closest walk parks its ray and hit in its path's
//      columns for the boundary's shade (K6);
//   4. inline gate: a finished shadow walk adds its path's pending NEE term
//      unless occluded, and a live path pends its bounce ray at the
//      bounce time drawn at shade.
// The arithmetic is the plain version's in the same order, compiled with
// --fmad=false and IEEE division (1 / det, 1 / d): the two agree bit for
// bit.
//
// State: the lane's scalars live in registers across the rounds; its
// pending entries (n_levels x fanout floats, 60 at fanout 20 and 3
// levels) and bases live in shared memory for the launch, [slot][thread],
// so a popped slot is a dynamic index without local memory and without
// bank conflicts; they are loaded from and stored to the [L, F, W]
// tensors once per launch, coalesced. The paths' columns are read and
// written in global memory where a round needs them.
//
// Bound: the row gathers, 512 B per walking lane-round (the table, ~1.9
// MB at 50000 faces, sits in the 50 MB L2), and on leaf rows ~40
// operations per triangle test, on directory rows ~20 per child.
#include <cstdint>

#include <cuda_runtime.h>

namespace rt3c {

constexpr int WALK_BLOCK = 128;
constexpr int WALK_MAX_LEVELS = 8;
constexpr int ROW = 128;
constexpr int L_FIRST = 126;  // leaf: first face / directory: first child
constexpr int L_TYPE = 127;   // 1 = leaf, 0 = directory
constexpr float BIG = 1e30f;
constexpr float DET_EPS = 1e-10f;

// Launch parameters; mirrored field for field by kernels/build.py, the
// pointers in the field order of integrate/walkpool.py WalkState.
struct WalkParams {
  int w, n_levels, fanout, paths, misc_w, rounds, motion, pad;
  int level_lo[WALK_MAX_LEVELS], level_hi[WALK_MAX_LEVELS];
  float* ray;              // [W, 8]
  float* wtime;            // [W]
  int* cur;                // [W]
  int* wslot;              // [W]
  unsigned char* wmode;    // [W]
  unsigned char* wfound;   // [W]
  float* wb_t;             // [W]
  int* wb_prim;            // [W]
  float* wb_u;             // [W]
  float* wb_v;             // [W]
  float* ents;             // [L, F, W]
  int* bases;              // [L, W]
  float* mc;               // [P, MW, W]
  const float* nrays;      // [P, W, 8]
  const float* nee;        // [P, 3, W]
  float* pray;             // [P, W, 8]
  float* ptime;            // [P, W]
  unsigned char* pmode;    // [P, W]
  unsigned char* pvalid;   // [P, W]
  const float* btime;      // [P, W]
  float* hray;             // [P, W, 8]
  float* ht;               // [P, W]
  int* hprim;              // [P, W]
  float* hu;               // [P, W]
  float* hv;               // [P, W]
  unsigned char* hfound;   // [P, W]
  unsigned char* hmode;    // [P, W]
  unsigned char* hvalid;   // [P, W]
  unsigned long long* rows;  // [1] walking lane-rounds (rows gathered)
};

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float* src) {
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(src[0], src[1], src[2], src[3]);
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(src[4], src[5], src[6], src[7]);
}

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : BIG;
}

__global__ void __launch_bounds__(WALK_BLOCK)
    walk_kernel(const WalkParams p, const float* __restrict__ table) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * WALK_BLOCK + tid;
  if (i >= p.w) return;  // no block-wide synchronisation below
  const int W = p.w, L = p.n_levels, F = p.fanout;
  float* ents = smem;                                        // [L*F][B]
  int* bases = reinterpret_cast<int*>(smem + L * F * WALK_BLOCK);  // [L][B]
  for (int q = 0; q < L * F; ++q)
    ents[q * WALK_BLOCK + tid] = p.ents[q * (size_t)W + i];
  for (int lv = 0; lv < L; ++lv)
    bases[lv * WALK_BLOCK + tid] = p.bases[lv * (size_t)W + i];

  float ray[8];
  load8(p.ray + 8 * (size_t)i, ray);
  float wtime = p.wtime[i];
  int cur = p.cur[i];
  int wslot = p.wslot[i];
  bool wmode = p.wmode[i] != 0;
  bool wfound = p.wfound[i] != 0;
  float wb_t = p.wb_t[i];
  int wb_prim = p.wb_prim[i];
  float wb_u = p.wb_u[i];
  float wb_v = p.wb_v[i];
  unsigned long long walked = 0;
  const int cap = p.motion ? 7 : 14;

  for (int r = 0; r < p.rounds; ++r) {
    // ---- 1. launch
    if (cur < 0) {
      for (int q = 0; q < p.paths; ++q) {
        const size_t pq = (size_t)q * W + i;
        if (!p.pvalid[pq]) continue;
        p.pvalid[pq] = 0;
        load8(p.pray + 8 * pq, ray);
        wtime = p.ptime[pq];
        wmode = p.pmode[pq] != 0;
        wslot = q;
        wfound = false;
        wb_t = ray[7];
        wb_prim = -1;
        cur = 0;
        break;
      }
    }

    // ---- 2. the walk round
    const bool walking = cur >= 0;
    walked += walking ? 1 : 0;
    if (walking) {
      const float* row = table + (size_t)cur * ROW;
      const bool is_leaf = row[L_TYPE] > 0.5f;
      const float first = row[L_FIRST];
      const float ox = ray[0], oy = ray[1], oz = ray[2];
      const float dx = ray[3], dy = ray[4], dz = ray[5];
      const float tmin = ray[6];
      if (is_leaf) {
        const float tcur = wfound ? 0.0f : wb_t;
        float t_leaf = BIG, u_sel = 0.0f, v_sel = 0.0f;
        int lane_sel = 0;
        bool any = false;
        for (int k = 0; k < cap; ++k) {
          float c[9];
          for (int j = 0; j < 9; ++j) {
            const float a = row[j * cap + k];
            c[j] = p.motion ? a + wtime * (row[9 * cap + j * cap + k] - a)
                            : a;
          }
          const float px = dy * c[8] - dz * c[7];
          const float py = dz * c[6] - dx * c[8];
          const float pz = dx * c[7] - dy * c[6];
          const float det = c[3] * px + c[4] * py + c[5] * pz;
          const bool ok = fabsf(det) > DET_EPS;
          const float inv_det = ok ? 1.0f / det : 0.0f;
          const float tx = ox - c[0], ty = oy - c[1], tz = oz - c[2];
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * c[5] - tz * c[4];
          const float qy = tz * c[3] - tx * c[5];
          const float qz = tx * c[4] - ty * c[3];
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (c[6] * qx + c[7] * qy + c[8] * qz) * inv_det;
          const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                           t > tmin && t < tcur;
          if (hit) {
            any = true;
            if (t < t_leaf) {
              t_leaf = t;
              lane_sel = k;
              u_sel = u;
              v_sel = v;
            }
          }
        }
        wfound = wfound || (wmode && any);
        if (!wmode && t_leaf < wb_t) {
          wb_t = t_leaf;
          wb_prim = (int)first + lane_sel;
          // + 0: the plain version sums the selected lane with zeros,
          // which turns a -0 into +0
          wb_u = u_sel + 0.0f;
          wb_v = v_sel + 0.0f;
        }
      }
      const float cut = (wfound ? 0.0f : wb_t) * 1.00001f + 1e-6f;
      if (!is_leaf) {
        int lv = 0;
        while (lv < L && !(cur >= p.level_lo[lv] && cur < p.level_hi[lv]))
          ++lv;
        if (lv < L) {
          const float inv[3] = {safe_inv(dx), safe_inv(dy), safe_inv(dz)};
          const float o[3] = {ox, oy, oz};
          for (int k = 0; k < F; ++k) {
            float tn = -BIG, tf = BIG;
            for (int c = 0; c < 3; ++c) {
              const float t0 = (row[c * F + k] - o[c]) * inv[c];
              const float t1 = (row[(c + 3) * F + k] - o[c]) * inv[c];
              tn = fmaxf(tn, fminf(t0, t1));
              tf = fminf(tf, fmaxf(t0, t1));
            }
            const bool ok = tn <= tf && tf > tmin && tn < cut;
            ents[(lv * F + k) * WALK_BLOCK + tid] = ok ? fmaxf(tn, tmin) : BIG;
          }
          bases[lv * WALK_BLOCK + tid] = (int)first;
        }
      }
    }

    // ---- the ordered pop (and the pruning write-back on every lane)
    const float cut = (wfound ? 0.0f : wb_t) * 1.00001f + 1e-6f;
    int nxt = -1;
    for (int lv = L - 1; lv >= 0; --lv) {
      float e_min = BIG;
      int j = 0;
      for (int k = 0; k < F; ++k) {
        float* e = &ents[(lv * F + k) * WALK_BLOCK + tid];
        const float ee = *e < cut ? *e : BIG;
        *e = ee;
        if (ee < e_min) {
          e_min = ee;
          j = k;
        }
      }
      if (e_min < BIG && walking && nxt < 0 && !wfound) {
        nxt = bases[lv * WALK_BLOCK + tid] + j;
        ents[(lv * F + j) * WALK_BLOCK + tid] = BIG;
      }
    }
    if (walking) cur = nxt;

    // ---- 3./4. stash a finished closest walk, gate a shadow walk
    if (cur < 0 && wslot >= 0) {
      const size_t pq = (size_t)wslot * W + i;
      if (wmode) {
        float* m = p.mc + (size_t)wslot * p.misc_w * W + i;
        if (!wfound) {
          for (int c = 0; c < 3; ++c)
            m[(10 + c) * (size_t)W] += p.nee[((size_t)wslot * 3 + c) * W + i];
        }
        if (m[9 * (size_t)W] > 0.0f) {
          float nr[8];
          load8(p.nrays + 8 * pq, nr);
          store8(p.pray + 8 * pq, nr);
          p.ptime[pq] = p.btime[pq];
          p.pmode[pq] = 0;
          p.pvalid[pq] = 1;
        }
      } else {
        store8(p.hray + 8 * pq, ray);
        p.ht[pq] = wb_t;
        p.hprim[pq] = wb_prim;
        p.hu[pq] = wb_u;
        p.hv[pq] = wb_v;
        p.hfound[pq] = wfound ? 1 : 0;
        p.hmode[pq] = 0;
        p.hvalid[pq] = 1;
      }
      wslot = -1;
    }
  }

  store8(p.ray + 8 * (size_t)i, ray);
  p.wtime[i] = wtime;
  p.cur[i] = cur;
  p.wslot[i] = wslot;
  p.wmode[i] = wmode ? 1 : 0;
  p.wfound[i] = wfound ? 1 : 0;
  p.wb_t[i] = wb_t;
  p.wb_prim[i] = wb_prim;
  p.wb_u[i] = wb_u;
  p.wb_v[i] = wb_v;
  for (int q = 0; q < L * F; ++q)
    p.ents[q * (size_t)W + i] = ents[q * WALK_BLOCK + tid];
  for (int lv = 0; lv < L; ++lv)
    p.bases[lv * (size_t)W + i] = bases[lv * WALK_BLOCK + tid];
  if (walked) atomicAdd(p.rows, walked);
}

}  // namespace rt3c

// table: the hier table [n_rows, 128] f32. Returns a CUDA error code.
extern "C" int rt3c_walk_rounds(int device, const rt3c::WalkParams* p,
                                const float* table, void* stream) {
  if (p->w < 0 || p->n_levels < 0 ||
      p->n_levels > rt3c::WALK_MAX_LEVELS || p->fanout < 1 ||
      p->paths < 0 || p->rounds < 0 || p->misc_w < 16)
    return (int)cudaErrorInvalidValue;
  if (p->w == 0 || p->rounds == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t smem = (size_t)p->n_levels * (p->fanout + 1) *
                      rt3c::WALK_BLOCK * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rt3c::walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (p->w + rt3c::WALK_BLOCK - 1) / rt3c::WALK_BLOCK;
  rt3c::walk_kernel<<<grid, rt3c::WALK_BLOCK, smem,
                      static_cast<cudaStream_t>(stream)>>>(*p, table);
  return (int)cudaGetLastError();
}
