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
// K9-inst (kInst, p.n_world > 0) is the same launch over the instanced
// table of trace/hier_instanced.py, replacing walkpool.py
// `_walk_round_inst` (:456-576) and hier_instanced.py `_walk_inst` (:494);
// its plain version is integrate/walkpool.py `_walk_round_inst`. Its rows
// are world directories, instance rows (type 2), shared mesh directories
// and 14-triangle leaves. The lane keeps the ray of the space it walks in
// (o_cur, d_cur) and that space's instance (inst_cur, -1 = world) in
// registers: the leaf and slab tests run in it; an instance row moves it
// into object space (a static row's inverse affine in lanes 0-11, its id
// in lane 12; a 2-key row's forward keys in lanes 0-23, its id in lane 24,
// lerped to the walk's time and inverted by cofactors, 1 / det where
// |det| > 1e-30 and 0 else) and jumps to the mesh's root (lane 126) without
// a pop, unless a shadow walk already found an occluder; a pop from a world
// level restores the world ray and instance -1. The best hit records its
// instance (wb_inst), the stash parks it in hinst. Directories of fanout 32
// hold bf16 pairs, lo = u << 16 and hi = u & 0xFFFF0000 of each lane's
// bits. The pop writes the pruned entries back as the static round does
// (the reference's instanced round does not: ROADMAP C9).
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
  int w, n_levels, fanout, paths, misc_w, rounds, motion;
  int n_world;  // > 0: K9-inst over an instanced table of n_world levels
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
  float* o_cur;            // [W, 3] K9-inst: the ray in the walk's space
  float* d_cur;            // [W, 3]
  int* inst_cur;           // [W] that space's instance, -1 = world
  int* wb_inst;            // [W] the best hit's instance
  int* hinst;              // [P, W] a finished closest walk's instance
};

constexpr int L_INST = 12;    // static instance row: its id
constexpr int L_INST_M = 24;  // 2-key instance row: its id

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

// An instance row's object-space ray (hier_instanced.py `_inst_space`).
__device__ __forceinline__ void inst_space(const float* row, bool motion,
                                           float time, const float* o,
                                           const float* d, float* o_t,
                                           float* d_t) {
  if (!motion) {
    for (int i = 0; i < 3; ++i) {
      const float* l = row + 3 * i;
      o_t[i] = l[0] * o[0] + l[1] * o[1] + l[2] * o[2] + row[9 + i];
      d_t[i] = l[0] * d[0] + l[1] * d[1] + l[2] * d[2];
    }
    return;
  }
  float mt[12];
  for (int q = 0; q < 12; ++q) {
    const float a = row[q];
    mt[q] = a + (row[12 + q] - a) * time;
  }
  const float a = mt[0], b = mt[1], c = mt[2];
  const float d0 = mt[4], e = mt[5], f = mt[6];
  const float g = mt[8], h = mt[9], k = mt[10];
  const float cof[9] = {e * k - f * h, c * h - b * k, b * f - c * e,
                        f * g - d0 * k, a * k - c * g, c * d0 - a * f,
                        d0 * h - e * g, b * g - a * h, a * e - b * d0};
  const float det = a * cof[0] + b * cof[3] + c * cof[6];
  const float r = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
  const float x[3] = {o[0] - mt[3], o[1] - mt[7], o[2] - mt[11]};
  for (int i = 0; i < 3; ++i) {
    const float l0 = cof[3 * i] * r, l1 = cof[3 * i + 1] * r,
                l2 = cof[3 * i + 2] * r;
    o_t[i] = l0 * x[0] + l1 * x[1] + l2 * x[2];
    d_t[i] = l0 * d[0] + l1 * d[1] + l2 * d[2];
  }
}

template <bool kInst>
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
  // K9-inst's leaves are static (its motion is in the instance rows)
  const bool leaf_motion = !kInst && p.motion;
  const int cap = leaf_motion ? 7 : 14;
  float o_cur[3] = {0.0f, 0.0f, 0.0f}, d_cur[3] = {0.0f, 0.0f, 0.0f};
  int inst_cur = -1, wb_inst = -1;
  if constexpr (kInst) {
    for (int c = 0; c < 3; ++c) {
      o_cur[c] = p.o_cur[3 * (size_t)i + c];
      d_cur[c] = p.d_cur[3 * (size_t)i + c];
    }
    inst_cur = p.inst_cur[i];
    wb_inst = p.wb_inst[i];
  }

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
        if constexpr (kInst) {
          for (int c = 0; c < 3; ++c) {
            o_cur[c] = ray[c];
            d_cur[c] = ray[3 + c];
          }
          inst_cur = -1;
          wb_inst = -1;
        }
        break;
      }
    }

    // ---- 2. the walk round
    const bool walking = cur >= 0;
    walked += walking ? 1 : 0;
    bool is_inst = false;
    float first = 0.0f;
    if (walking) {
      const float* row = table + (size_t)cur * ROW;
      const float typ = row[L_TYPE];
      if constexpr (kInst) is_inst = typ > 1.5f;
      const bool is_leaf = typ > 0.5f && !is_inst;
      first = row[L_FIRST];
      const float ox = kInst ? o_cur[0] : ray[0];
      const float oy = kInst ? o_cur[1] : ray[1];
      const float oz = kInst ? o_cur[2] : ray[2];
      const float dx = kInst ? d_cur[0] : ray[3];
      const float dy = kInst ? d_cur[1] : ray[4];
      const float dz = kInst ? d_cur[2] : ray[5];
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
            c[j] = leaf_motion
                       ? a + wtime * (row[9 * cap + j * cap + k] - a)
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
          if constexpr (kInst) wb_inst = inst_cur;
        }
      }
      const float cut = (wfound ? 0.0f : wb_t) * 1.00001f + 1e-6f;
      if (is_inst) {
        // switch into the instance's object space
        inst_space(row, p.motion != 0, wtime, ray, ray + 3, o_cur, d_cur);
        inst_cur = (int)row[p.motion ? L_INST_M : L_INST];
      } else if (!is_leaf) {
        int lv = 0;
        while (lv < L && !(cur >= p.level_lo[lv] && cur < p.level_hi[lv]))
          ++lv;
        if (lv < L) {
          const float inv[3] = {safe_inv(dx), safe_inv(dy), safe_inv(dz)};
          const float o[3] = {ox, oy, oz};
          for (int k = 0; k < F; ++k) {
            float tn = -BIG, tf = BIG;
            for (int c = 0; c < 3; ++c) {
              float lo, hi;
              if (kInst && F == 32) {
                const unsigned u = __float_as_uint(row[c * F + k]);
                lo = __uint_as_float(u << 16);
                hi = __uint_as_float(u & 0xFFFF0000u);
              } else {
                lo = row[c * F + k];
                hi = row[(c + 3) * F + k];
              }
              const float t0 = (lo - o[c]) * inv[c];
              const float t1 = (hi - o[c]) * inv[c];
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
    int nxt = -1, pop_lv = -1;
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
      if (e_min < BIG && walking && !is_inst && nxt < 0 && !wfound) {
        nxt = bases[lv * WALK_BLOCK + tid] + j;
        pop_lv = lv;
        ents[(lv * F + j) * WALK_BLOCK + tid] = BIG;
      }
    }
    if constexpr (kInst) {
      // an instance row jumps to its mesh's root; a world pop leaves it
      if (walking && is_inst && !wfound) nxt = (int)first;
      if (pop_lv >= 0 && pop_lv < p.n_world) {
        for (int c = 0; c < 3; ++c) {
          o_cur[c] = ray[c];
          d_cur[c] = ray[3 + c];
        }
        inst_cur = -1;
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
        if constexpr (kInst) p.hinst[pq] = wb_inst;
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
  if constexpr (kInst) {
    for (int c = 0; c < 3; ++c) {
      p.o_cur[3 * (size_t)i + c] = o_cur[c];
      p.d_cur[3 * (size_t)i + c] = d_cur[c];
    }
    p.inst_cur[i] = inst_cur;
    p.wb_inst[i] = wb_inst;
  }
  if (walked) atomicAdd(p.rows, walked);
}

}  // namespace rt3c

// table: the hier table [n_rows, 128] f32, or (p->n_world > 0) the
// instanced table, which K9-inst walks. Returns a CUDA error code.
extern "C" int rt3c_walk_rounds(int device, const rt3c::WalkParams* p,
                                const float* table, void* stream) {
  if (p->w < 0 || p->n_levels < 0 ||
      p->n_levels > rt3c::WALK_MAX_LEVELS || p->fanout < 1 ||
      p->paths < 0 || p->rounds < 0 || p->misc_w < 16 ||
      p->n_world < 0 || p->n_world > p->n_levels)
    return (int)cudaErrorInvalidValue;
  if (p->w == 0 || p->rounds == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t smem = (size_t)p->n_levels * (p->fanout + 1) *
                      rt3c::WALK_BLOCK * sizeof(float);
  const auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int grid = (p->w + rt3c::WALK_BLOCK - 1) / rt3c::WALK_BLOCK;
    kernel<<<grid, rt3c::WALK_BLOCK, smem,
             static_cast<cudaStream_t>(stream)>>>(*p, table);
    return (int)cudaGetLastError();
  };
  return p->n_world > 0 ? run(rt3c::walk_kernel<true>)
                        : run(rt3c::walk_kernel<false>);
}
