// K9: the walk pool's rounds between two phase boundaries.
//
// Replaces the per-ray walk of the hierwalk band, which the TPU runs as a
// jnp loop and not as a Pallas kernel: rendertoy3c_tpu/integrate/
// walkpool.py `_walk_round` (:363) inside `_render_pipepool`'s pipe_round
// (:1169-1306), the same round as trace/hierwalk.py `_walk` (:526). Its
// plain version is integrate/walkpool.py `_pipe_rounds_ref`.
//
// A launch runs `rounds` rounds on every pool lane; a lane's rounds touch
// only its own state. A round:
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
// (o_cur, d_cur) and that space's instance (inst_cur, -1 = world): the
// leaf and slab tests run in it; an instance row moves it into object
// space (a static row's inverse affine in lanes 0-11, its id in lane 12; a
// 2-key row's forward keys in lanes 0-23, its id in lane 24, lerped to the
// walk's time and inverted by cofactors, 1 / det where |det| > 1e-30 and
// 0 else) and jumps to the mesh's root (lane 126) without a pop, unless a
// shadow walk already found an occluder; a pop from a world level restores
// the world ray and instance -1. The best hit records its instance
// (wb_inst), the stash parks it in hinst. Directories of fanout 32 hold
// bf16 pairs, lo = u << 16 and hi = u & 0xFFFF0000 of each lane's bits.
// The pop writes the pruned entries back as the static round does (the
// reference's instanced round does not: ROADMAP C9).
//
// What bounds it: the row gathers, 512 B per walking lane-round (the
// table, ~1.9 MB at 50000 faces, sits in the 50 MB L2), and the tests, ~54
// operations per triangle on a leaf and ~29 per child on a directory; the
// pop's prune is a few operations per pending entry.
//
// What held the first design (one thread per lane) back:
//   1. too few threads: the pool is 16384 lanes (8192 on the 2-key
//      instance field), 128 CTAs of 128 threads, ~6% of the card's
//      resident threads, 68 of 132 SMs idle at 8192;
//   2. scattered, dependent gathers: each thread read its own 512-B row in
//      scalar loads, so one warp load touched 32 rows, and every round
//      waited on an L2 round trip per load chain with 4 warps an SM to
//      hide it;
//   3. serial work and divergence: 14 (7) MT tests, then 16-32 slab tests,
//      then an L x F scan of shared memory, in one thread, and a warp whose
//      lanes sat on a leaf, a directory and an instance row ran all three;
//   4. L x (F + 1) x 4 B of shared memory per thread for the entries.
//
// The design: a warp per lane. 16384 lanes are 524288 threads, about
// four waves of a full card (32 lanes an SM at 64 registers a thread,
// 8192 lanes two). Two lanes a warp (G = 16)
// were timed against it in turns on the recorded pool states
// (`tools/ab.py walk-round`, PERF.md) and were no faster: the two lanes of
// a warp diverge between leaf, directory and instance rows, and each
// thread holds two entries of a level. A warp runs its lane's rounds with
// no block-wide synchronisation (`__syncwarp`, shuffles, votes, redux):
//   - the row is fetched once per round, coalesced: thread k loads float4 k
//     into the lane's row in shared memory; the next row's load is issued
//     as soon as the pop has chosen it, before the stash and gate, and
//     lands by the next round;
//   - a leaf: thread k tests triangle k; a directory: thread k slab-tests
//     child k (fanout <= 32) with the lane's 1 / d, computed when its ray
//     or space changes and not every round; an instance row: every thread
//     computes the object-space ray from the same row floats in the same
//     order, so all hold the same bits and nothing is broadcast;
//   - the pending entries live in registers: thread k holds slot k of
//     every level (read from and written to the [L, F, W] state once per
//     launch), thread lv the base of level lv; the per-level loops unroll
//     over 4 or 8 levels (the table's count, rounded up), so no shared or
//     local memory holds them;
//   - the scalars (ray, best hit, cursor) are held by every thread alike;
//     thread 0 alone reads and writes the paths' columns (the launch's
//     pick, the stash and the gate), and a lane that is idle with nothing
//     pending leaves the round loop, its later rounds being no-ops;
//   - CTAs of 4 lanes, at most 64 registers a thread (8 CTAs an SM; the
//     compiler's own 75 made K9 15% slower); `rows` gets one atomicAdd per
//     CTA.
//
// Why the warp's rules give the sequential scan's answers:
//   - the leaf: the scan keeps the first triangle with t < the best so far,
//     starting from _BIG: the smallest t below _BIG and, at equal t, the
//     lowest lane, with that lane's own t, u, v. The warp takes the
//     minimum of an order-preserving key of t (-0 folded into +0, which
//     compares equal to it) over the hits below _BIG, then the lowest lane
//     holding that key, and shuffles its t, u, v: the same lane. No hit
//     below _BIG leaves t = _BIG, lane 0, u = v = 0, as the scan; u and v
//     keep the `+ 0.0f` that turns -0 into +0, as the plain version's sum;
//     `any` is a vote over every hit, as the scan's flag;
//   - the pop: every entry of every level is pruned (an entry not below the
//     cut becomes _BIG) on every lane, walking or not; the deepest level
//     holding an entry below _BIG is found by an OR of per-thread level
//     bits; its minimum is taken by the same key (entries are never NaN:
//     a NaN fails `< cut`), then the lowest slot holding it: the scan's
//     first minimum. No pop after an occluder or at an instance row; the
//     slot's owner writes _BIG into it.
// K9 and K9-inst run the same rounds per lane as before; only who does
// which part of a round changed.
//
// N-key motion (kSeg, p.wseg not null): a bare walk (no paths) over the
// stacked segment tables of trace/hierwalk.py `build_hier_table_nkey`,
// replacing the per-ray row offset of the reference's `_walk`
// (hierwalk.py:563-564). Lane i's every row gather reads row cur +
// wseg[i] of its segment; cur, the level bounds and the child pointers
// (lane 126) stay segment-local, so the offset goes on at the gather and
// nowhere else. Its time is the segment's local time. A null wseg
// compiles the kernels without it, as they were.
#include <cstdint>

#include <cuda_runtime.h>

namespace rt3c {

constexpr int WALK_BLOCK = 128;   // threads per CTA: 4 lanes, a warp each
constexpr int WALK_MIN_CTAS = 8;  // per SM: at most 64 registers a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_MAX_LEVELS = 8;
constexpr int WALK_MAX_FANOUT = 32;
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
  const int* wseg;         // [W] segment row offset (N-key), or null
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

// An unsigned key in the order of the float x (never NaN here), -0 folded
// into +0 so that the two zeros tie as they compare equal.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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

// Lane k's Moller-Trumbore test of a leaf row (hierwalk.py `_leaf_mt`):
// its triangle's 9 floats at row[j * cap + k], lerped by the walk's time
// toward the second key's at row[9 * cap + j * cap + k] on a 2-key leaf.
// Returns the hit flag and sets t, u, v.
__device__ __forceinline__ bool mt_lane(const float* row, int cap, int k,
                                        bool motion, float time,
                                        const float* o, const float* d,
                                        float tmin, float tcur, float& t,
                                        float& u, float& v) {
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = d[0], dy = d[1], dz = d[2];
  float c[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float a = row[j * cap + k];
    c[j] = motion ? a + time * (row[9 * cap + j * cap + k] - a) : a;
  }
  const float px = dy * c[8] - dz * c[7];
  const float py = dz * c[6] - dx * c[8];
  const float pz = dx * c[7] - dy * c[6];
  const float det = c[3] * px + c[4] * py + c[5] * pz;
  const bool ok = fabsf(det) > DET_EPS;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tx = ox - c[0], ty = oy - c[1], tz = oz - c[2];
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * c[5] - tz * c[4];
  const float qy = tz * c[3] - tx * c[5];
  const float qz = tx * c[4] - ty * c[3];
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (c[6] * qx + c[7] * qy + c[8] * qz) * inv_det;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
         t < tcur;
}

// Child k's entry distance of a directory row: the slab test against
// the pruning cut, _BIG where missed (hierwalk.py `_dir_entries`). fminf
// and fmaxf order -0 below +0 on this card, as the plain version's _min0
// and _max0 and the reference's jnp.minimum and jnp.maximum.
template <bool kInst>
__device__ __forceinline__ float slab_entry(const float* row, int F, int k,
                                            const float* o, const float* inv,
                                            float tmin, float cut) {
  float tn = -BIG, tf = BIG;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float lo, hi;
    if (kInst && F == 32) {
      const unsigned b = __float_as_uint(row[c * F + k]);
      lo = __uint_as_float(b << 16);
      hi = __uint_as_float(b & 0xFFFF0000u);
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
  return ok ? fmaxf(tn, tmin) : BIG;
}

// A ray's 1 / d for the slab tests (safe_inv of each component).
__device__ __forceinline__ void inverse(const float* d, float* inv) {
  for (int c = 0; c < 3; ++c) inv[c] = safe_inv(d[c]);
}

// Thread k's float4 of row r: the warp's loads cover its 512 bytes.
__device__ __forceinline__ float4 row_part(const float* __restrict__ table,
                                           int r, int k) {
  return reinterpret_cast<const float4*>(table + (size_t)r * ROW)[k];
}

// ML: the levels a launch may hold (4 or 8, the table's n_levels or more):
// the per-level loops unroll over ML, so the entries stay in registers.
// kSeg: each lane's gathers add its segment offset p.wseg[i].
template <bool kInst, int ML, bool kSeg = false>
__global__ void __launch_bounds__(WALK_BLOCK, WALK_MIN_CTAS)
    walk_kernel(const WalkParams p, const float* __restrict__ table) {
  constexpr int LANES = WALK_BLOCK / 32;
  __shared__ __align__(16) float rows[LANES][ROW];
  __shared__ unsigned long long cta_rows;
  const int k = threadIdx.x & 31;  // the triangle, child or level it holds
  const int i = blockIdx.x * LANES + threadIdx.x / 32;
  float* row = rows[threadIdx.x / 32];
  if (threadIdx.x == 0) cta_rows = 0;
  __syncthreads();
  unsigned long long walked = 0;

  if (i < p.w) {
    const int W = p.w, L = p.n_levels, F = p.fanout;
    // thread k holds slot k of every level, thread lv level lv's base
    float ent[ML];
#pragma unroll
    for (int lv = 0; lv < ML; ++lv)
      ent[lv] = lv < L && k < F ? p.ents[((size_t)lv * F + k) * W + i] : BIG;
    int base = k < L ? p.bases[(size_t)k * W + i] : 0;

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
    // 1 / d of the space the lane walks in, for its slab tests
    float inv[3];
    inverse(kInst ? d_cur : ray + 3, inv);
    // the lane's segment rows: added at the gather only
    const int seg = kSeg ? p.wseg[i] : 0;

    // the row of max(cur, 0): the launch below starts a walk at row 0
    float4 next = row_part(table, (cur > 0 ? cur : 0) + seg, k);

    for (int r = 0; r < p.rounds; ++r) {
      // the warp's last reads of the row and the leader's writes to the
      // paths' columns come before this round
      __syncwarp();
      reinterpret_cast<float4*>(row)[k] = next;

      // ---- 1. launch: the leader picks the first pending path
      bool idle = false;
      if (cur < 0) {
        int q = -1;
        if (k == 0) {
          for (int pk = 0; pk < p.paths; ++pk) {
            const size_t at = (size_t)pk * W + i;
            if (p.pvalid[at]) {
              p.pvalid[at] = 0;
              q = pk;
              break;
            }
          }
        }
        q = __shfl_sync(FULL, q, 0);
        if (q >= 0) {
          const size_t pq = (size_t)q * W + i;
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
          inverse(ray + 3, inv);
        } else {
          idle = true;
        }
      }
      __syncwarp();  // the row is in shared memory

      // ---- 2. the walk round
      const bool walking = cur >= 0;
      walked += walking && k == 0 ? 1 : 0;
      bool is_inst = false;
      int first = 0;
      if (walking) {
        const float typ = row[L_TYPE];
        if constexpr (kInst) is_inst = typ > 1.5f;
        const bool is_leaf = typ > 0.5f && !is_inst;
        first = (int)row[L_FIRST];
        const float o[3] = {kInst ? o_cur[0] : ray[0],
                            kInst ? o_cur[1] : ray[1],
                            kInst ? o_cur[2] : ray[2]};
        const float* d = kInst ? d_cur : ray + 3;
        const float tmin = ray[6];
        if (is_leaf) {
          // thread k tests triangle k; the warp keeps the scan's first
          // minimum below _BIG
          unsigned key = order_key(BIG);
          float t = BIG, u = 0.0f, v = 0.0f;
          bool hit = false;
          if (k < cap) {
            float tt, uu, vv;
            hit = mt_lane(row, cap, k, leaf_motion, wtime, o, d, tmin,
                          wfound ? 0.0f : wb_t, tt, uu, vv);
            if (hit && tt < BIG) {
              key = order_key(tt);
              t = tt;
              u = uu;
              v = vv;
            }
          }
          const bool any = __any_sync(FULL, hit);
          const unsigned k_min = __reduce_min_sync(FULL, key);
          const unsigned sel =
              __reduce_min_sync(FULL, key == k_min ? (unsigned)k : 32u);
          float t_leaf = BIG, u_sel = 0.0f, v_sel = 0.0f;
          int lane_sel = 0;
          if (k_min != order_key(BIG)) {
            t_leaf = __shfl_sync(FULL, t, sel);
            u_sel = __shfl_sync(FULL, u, sel);
            v_sel = __shfl_sync(FULL, v, sel);
            lane_sel = (int)sel;
          }
          wfound = wfound || (wmode && any);
          if (!wmode && t_leaf < wb_t) {
            wb_t = t_leaf;
            wb_prim = first + lane_sel;
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
          inverse(d_cur, inv);
          inst_cur = (int)row[p.motion ? L_INST_M : L_INST];
        } else if (!is_leaf) {
          int lv = 0;
          while (lv < L && !(cur >= p.level_lo[lv] && cur < p.level_hi[lv]))
            ++lv;
          if (lv < L) {
            // thread k slab-tests child k
            const float e = k < F ? slab_entry<kInst>(row, F, k, o, inv,
                                                      tmin, cut)
                                  : BIG;
#pragma unroll
            for (int l = 0; l < ML; ++l)
              if (l == lv) ent[l] = e;
            if (k == lv) base = first;
          }
        }
      }

      // ---- the ordered pop (and the pruning write-back on every lane;
      // levels at or past L hold _BIG only)
      const float cut = (wfound ? 0.0f : wb_t) * 1.00001f + 1e-6f;
      unsigned alive = 0;
#pragma unroll
      for (int lv = 0; lv < ML; ++lv) {
        ent[lv] = ent[lv] < cut ? ent[lv] : BIG;
        alive |= ent[lv] < BIG ? 1u << lv : 0u;
      }
      int nxt = -1, pop_lv = -1;
      if (walking && !is_inst && !wfound) {
        const unsigned levels = __reduce_or_sync(FULL, alive);
        if (levels) {
          const int lv = 31 - __clz(levels);
          float e = BIG;
#pragma unroll
          for (int l = 0; l < ML; ++l)
            if (l == lv) e = ent[l];
          const unsigned key = e < BIG ? order_key(e) : 0xffffffffu;
          const unsigned k_min = __reduce_min_sync(FULL, key);
          const unsigned j =
              __reduce_min_sync(FULL, key == k_min ? (unsigned)k : 32u);
          nxt = __shfl_sync(FULL, base, lv) + (int)j;
          pop_lv = lv;
          if (k == (int)j) {
#pragma unroll
            for (int l = 0; l < ML; ++l)
              if (l == lv) ent[l] = BIG;
          }
        }
      }
      if constexpr (kInst) {
        // an instance row jumps to its mesh's root; a world pop leaves it
        if (walking && is_inst && !wfound) nxt = first;
        if (pop_lv >= 0 && pop_lv < p.n_world) {
          for (int c = 0; c < 3; ++c) {
            o_cur[c] = ray[c];
            d_cur[c] = ray[3 + c];
          }
          inverse(d_cur, inv);
          inst_cur = -1;
        }
      }
      if (walking) cur = nxt;
      next = row_part(table, (cur > 0 ? cur : 0) + seg, k);

      // ---- 3./4. stash a finished closest walk, gate a shadow walk
      const bool stash = cur < 0 && wslot >= 0;
      if (stash && k == 0) {
        const size_t pq = (size_t)wslot * W + i;
        if (wmode) {
          float* m = p.mc + (size_t)wslot * p.misc_w * W + i;
          if (!wfound) {
            for (int c = 0; c < 3; ++c)
              m[(10 + c) * (size_t)W] +=
                  p.nee[((size_t)wslot * 3 + c) * W + i];
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
      }
      if (stash) wslot = -1;
      // idle with nothing pending and nothing stashed: the later rounds
      // would find the same (the prune above is idempotent)
      if (idle && !stash) break;
    }

#pragma unroll
    for (int lv = 0; lv < ML; ++lv)
      if (lv < L && k < F) p.ents[((size_t)lv * F + k) * W + i] = ent[lv];
    if (k < L) p.bases[(size_t)k * W + i] = base;
    if (k == 0) {
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
      if constexpr (kInst) {
        for (int c = 0; c < 3; ++c) {
          p.o_cur[3 * (size_t)i + c] = o_cur[c];
          p.d_cur[3 * (size_t)i + c] = d_cur[c];
        }
        p.inst_cur[i] = inst_cur;
        p.wb_inst[i] = wb_inst;
      }
    }
  }

  if (walked) atomicAdd(&cta_rows, walked);
  __syncthreads();
  if (threadIdx.x == 0 && cta_rows) atomicAdd(p.rows, cta_rows);
}

}  // namespace rt3c

// table: the hier table [n_rows, 128] f32 (the stacked segment tables
// where p->wseg is not null), or (p->n_world > 0) the instanced table,
// which K9-inst walks. Returns a CUDA error code.
extern "C" int rt3c_walk_rounds(int device, const rt3c::WalkParams* p,
                                const float* table, void* stream) {
  if (p->w < 0 || p->n_levels < 0 ||
      p->n_levels > rt3c::WALK_MAX_LEVELS || p->fanout < 1 ||
      p->fanout > rt3c::WALK_MAX_FANOUT || p->paths < 0 || p->rounds < 0 ||
      p->misc_w < 16 || p->n_world < 0 || p->n_world > p->n_levels ||
      (p->wseg && (p->n_world > 0 || p->paths > 0)))
    return (int)cudaErrorInvalidValue;
  if (p->w == 0 || p->rounds == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  using rt3c::walk_kernel;
  const auto run = [&](auto kernel) {
    constexpr int lanes = rt3c::WALK_BLOCK / 32;
    kernel<<<(p->w + lanes - 1) / lanes, rt3c::WALK_BLOCK, 0,
             static_cast<cudaStream_t>(stream)>>>(*p, table);
    return (int)cudaGetLastError();
  };
  const bool few = p->n_levels <= 4;
  if (p->wseg)
    return few ? run(walk_kernel<false, 4, true>)
               : run(walk_kernel<false, 8, true>);
  if (p->n_world > 0)
    return few ? run(walk_kernel<true, 4>) : run(walk_kernel<true, 8>);
  return few ? run(walk_kernel<false, 4>) : run(walk_kernel<false, 8>);
}
