// K8: the resident-table block walk, closest and any hit.
//
// Replaces rendertoy3c_tpu/trace/pallas_walk.py `_walk_call` (pallas_call
// :338) with its kernels `_closest_kernel` (:196) and `_any_kernel` (:271),
// and the pass loops of `trace_closest_walk` and `trace_any_walk` around
// them (:404-423, :454-470). Its plain versions are trace/residentwalk.py
// `walk_closest_blocks_ref` and `walk_any_blocks_ref` (one pass from a
// cursor: `walk_closest_ref`, `walk_any_ref`).
//
// What bounds it on this card. The work is the slab test of each block's
// 32 rays against every leaf box once per pass (~30 operations a pair) and
// the Moller-Trumbore test of each round's (ray, face) pairs (~45): a few
// microseconds of the card's fp32 rate per walk; the table (1.77 MB of
// leaf rows at 49k faces) stays in L2. What held the first design back was
// latency, not either rate: a host-read pass loop that relaunched every
// block while any one was open, one warp per block with 128 dependent
// tests a lane per round, and a serial argmin and leaf fetch per round.
//
// The design. One launch per walk; one CTA of NT threads per block of 32
// rays (RT), 256 for the closest walk, 512 for the any walk (threads());
// each block runs its own passes:
//   1. a pass builds the block's row [lp] in shared memory: thread l takes
//      leaves l, l + NT, ... and for each the minimum over the 32 rays of
//      their slab entries (BIG on a miss), in ray order, with tmax = each
//      ray's best t (closest) or its tmax (any); BIG for a dead block (its
//      first ray at or past *count) and for leaves at or below the cursor
//      (entry, id), lexicographic;
//   2. the row's entries below BIG are compacted by a shared counter and
//      ranked by (entry, id): the T smallest are the pass's visit order,
//      taken once (the row changes within a pass only by masking visited
//      leaves); a NaN entry stops the block, as the reference's NaN row
//      minimum does; past the ranked entries the next round would need an
//      entry of at least BIG, which only a closest walk whose rays' best t
//      exceeds BIG takes, from a block-wide argmin of the row;
//   3. rounds: the next leaf's row is staged by cp.async into one of two
//      shared buffers while the current one is tested. The closest walk
//      tests all 32 x 128 (ray, face) pairs (warp w takes faces w, w + 8,
//      ...; lane = ray), each warp's first face at the least t merged
//      lexicographically on (t, face): the reference's first face at the
//      least t. The any walk tests only the rays unoccluded when the round
//      starts, (slot, face) pairs spread over the CTA, and ORs the hits
//      (a ray that hit a leaf skips its remaining faces).
//      Every warp then resolves the round from the shared results (the
//      same operations on the same values: each warp holds the block's
//      state, lane = ray): the round's condition (closest: entry below
//      the largest best t; any: entry below BIG and a ray unoccluded), the
//      hit, the cursor, the leaf masked in the row;
//   4. after a pass the row's minimum gives the done flag as the
//      reference's cursor row; the block stops at its own done flag, or
//      after max_passes passes (the reference's cap ceil(n_leaves / T) + 1
//      after the first);
//   5. out rows (t, prim, u, v or occlusion, 0, 0, 0), the cursor row
//      (done, entry, id) and the counts (passes, rounds) of the block.
// max_passes = 1 is the single-pass form: out and cursor rows bit-equal to
// one reference launch from the given cursor.
//
// Why the one-launch walk gives the pass loop's results:
//   - a done block that the reference relaunches changes no output;
//   - closest: a relaunch only revisits leaves whose every face was tested
//     at a tmax no smaller than the current best t; a hit needs t <
//     best_t, strictly, so no better hit appears;
//   - any: a relaunched block's rays are all 1 in the combined maximum, or
//     the block has no leaf left below BIG;
//   - up to its own done flag a block's visit sequence is the reference's
//     (its passes read only its own rays, state and cursor). With
//     occlusion kept across passes the any block tests a subset of the
//     reference's rays, those still unoccluded overall, with the same
//     tests and so the same hits.
//
// Windows. Rounds depend on each other only through the closest walk's
// best t and the stop, so WINDOW consecutive leaves of the visit order can
// be tested at once and resolved in order, exactly: the closest hits at
// the window's first tmax are a superset, and a leaf's first face at the
// least t lies below the round's best t iff it is the reference's t_c;
// otherwise the reference's round has no hit and takes t_c = BIG at face 0
// with face 0's u and v (which matters only for a best t above BIG). The
// any walk ORs. WINDOW = 2, timed against 1 in turns (tools/ab.py
// resident-walk, PERF.md): the any walk's time is its longest block,
// which walks every leaf of its row one round after another, and a window
// halves the syncs and resolutions per leaf there (-7%); the closest
// walk, bound by the card's issue rate over all blocks, does not change.
//
// Agreement with the plain version, bit for bit: the same float
// operations in the same order under --fmad=false and IEEE division
// (1 / d where |d| > 1e-20 else BIG, 1 / det where |det| > 1e-10 else 0);
// min and max propagate NaN and return their first operand at a tie, as
// torch.minimum / torch.maximum (fminf / fmaxf drop NaN); the row minimum
// runs in ray order; the hit's u and v are the reference's masked sums,
// which turn -0.0 into +0.0 (u + 0.0f).
#include <cstdint>

#include <cuda_runtime.h>

namespace rt3c {

namespace rw {

constexpr int RT = 32;     // rays per block
constexpr int LEAF = 128;  // faces per leaf row
constexpr int LEAF_N = 9 * LEAF;
// threads per CTA: the closest walk is bound by the card's issue rate
// over all blocks, the any walk by its longest block (a ray that nothing
// occludes walks every leaf its block's row holds), which more threads
// shorten; 256 / 512 as timed in turns (tools/ab.py resident-walk,
// PERF.md)
template <bool kAny>
__host__ __device__ constexpr int threads() {
  return kAny ? 512 : 256;
}
constexpr int WINDOW = 2;  // leaves tested at once
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const int* count;   // [1] live rays
  const float* er;    // [n_blk] cursor entries
  const int* ir;      // [n_blk] cursor leaf ids
  const float* rays;  // [n_blk * RT, 8]: o, d, tmin, tmax
  const float* rows;  // [n_rows, 9, LEAF]
  const float* aabb;  // [8, lp]: lo xyz, hi xyz
  float* out;         // [n_blk * RT, 4]
  float* cur;         // [n_blk, 8]
  int* stat;          // [n_blk, 2]: passes, rounds
  int n_rows, lp, t_rounds, max_passes;
};

// The shared memory of one CTA, 4-byte words; the leaf buffers first (16-
// byte aligned for cp.async). Each walk carves only its own arrays: the
// others stay null.
struct Smem {
  float* leaf;    // [2][WINDOW][LEAF_N]
  float* part_t;  // closest, [WINDOW][nwarp][RT]: each warp's first face
  int* part_f;    //   at the least t of a window leaf, and its u, v
  float* part_u;
  float* part_v;
  float* u0;     // closest, [WINDOW][RT]: face 0's u, v
  float* v0;
  int* hitw;     // any, [WINDOW][RT]: the window's stamp where a ray hit
  int* slots;    // any, [RT]: the window's unoccluded rays
  float* ray;    // [8][RT]: ox oy oz ix iy iz tmin tmax
  float* dir;    // [3][RT]
  float* bt;     // [RT]: best t, the closest row's tmax
  float* row;    // [lp]
  float* cand_e;  // [lp]: entries below BIG, compacted
  int* cand_i;
  float* ord_e;  // [t_rounds]: the pass's visit order
  int* ord_i;
  float* red;    // [nwarp]
  int* red_i;
  int* ctl;      // [2]: candidates, a NaN entry
};

template <bool kAny>
__host__ __device__ inline size_t smem_words(int lp, int t_rounds,
                                            int nwarp) {
  const size_t own = kAny ? (size_t)WINDOW * RT + RT
                          : (size_t)4 * WINDOW * nwarp * RT + 2 * WINDOW * RT;
  return (size_t)2 * WINDOW * LEAF_N + own + 12 * RT + 3 * (size_t)lp +
         2 * (size_t)t_rounds + 2 * nwarp + 2;
}

template <bool kAny>
__device__ inline Smem carve(float* s, int lp, int t_rounds, int nwarp) {
  Smem m{};
  m.leaf = s;
  s += 2 * WINDOW * LEAF_N;
  if (kAny) {
    m.hitw = reinterpret_cast<int*>(s);
    s += WINDOW * RT;
    m.slots = reinterpret_cast<int*>(s);
    s += RT;
  } else {
    m.part_t = s;
    s += WINDOW * nwarp * RT;
    m.part_f = reinterpret_cast<int*>(s);
    s += WINDOW * nwarp * RT;
    m.part_u = s;
    s += WINDOW * nwarp * RT;
    m.part_v = s;
    s += WINDOW * nwarp * RT;
    m.u0 = s;
    s += WINDOW * RT;
    m.v0 = s;
    s += WINDOW * RT;
  }
  m.ray = s;
  s += 8 * RT;
  m.dir = s;
  s += 3 * RT;
  m.bt = s;
  s += RT;
  m.row = s;
  s += lp;
  m.cand_e = s;
  s += lp;
  m.cand_i = reinterpret_cast<int*>(s);
  s += lp;
  m.ord_e = s;
  s += t_rounds;
  m.ord_i = reinterpret_cast<int*>(s);
  s += t_rounds;
  m.red = s;
  s += nwarp;
  m.red_i = reinterpret_cast<int*>(s);
  s += nwarp;
  m.ctl = reinterpret_cast<int*>(s);
  return m;
}

// Step 1: the block's masked row, its candidates below BIG and a NaN flag.
template <bool kAny, int NT>
__device__ void build_row(const Smem& sm, const float* aabb, int lp,
                          bool live, float er, int ir) {
  for (int l = threadIdx.x; l < lp; l += NT) {
    float e = BIG;
    if (live) {
      const float lo[3] = {aabb[l], aabb[lp + l], aabb[2 * lp + l]};
      const float hi[3] = {aabb[3 * lp + l], aabb[4 * lp + l],
                           aabb[5 * lp + l]};
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
        const float rtmax = kAny ? sm.ray[7 * RT + r] : sm.bt[r];
        const bool ok = (tn <= tf) && (tf > rtmin) && (tn < rtmax);
        const float ent = ok ? tmax2(tn, rtmin) : BIG;
        e = r == 0 ? ent : tmin2(e, ent);  // in ray order
      }
    }
    if ((e < er) || ((e == er) && (l <= ir))) e = BIG;
    sm.row[l] = e;
    if (isnan(e)) {
      sm.ctl[1] = 1;
    } else if (e < BIG) {
      const int s = atomicAdd(&sm.ctl[0], 1);
      sm.cand_e[s] = e;
      sm.cand_i[s] = l;
    }
  }
}

// Step 2: the candidates' ranks by (entry, id); those below t_rounds are
// the pass's visit order.
template <int NT>
__device__ void rank_order(const Smem& sm, int n, int t_rounds) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const float ei = sm.cand_e[i];
    const int ii = sm.cand_i[i];
    int rank = 0;
    for (int j = 0; j < n && rank < t_rounds; ++j) {
      const float ej = sm.cand_e[j];
      rank += (ej < ei) || ((ej == ei) && (sm.cand_i[j] < ii));
    }
    if (rank < t_rounds) {
      sm.ord_e[rank] = ei;
      sm.ord_i[rank] = ii;
    }
  }
}

// The row's NaN-propagating minimum, block-wide (every thread returns it).
template <int NT>
__device__ float row_min(const Smem& sm, int lp) {
  __syncthreads();
  float m = __int_as_float(0x7f800000);  // +inf: tmin2's identity
  for (int l = threadIdx.x; l < lp; l += NT) m = tmin2(m, sm.row[l]);
  m = warp_min(m);
  if (threadIdx.x % RT == 0) sm.red[threadIdx.x / RT] = m;
  __syncthreads();
  m = sm.red[0];
  for (int w = 1; w < NT / RT; ++w) m = tmin2(m, sm.red[w]);
  __syncthreads();  // red is free again
  return m;
}

// The row's minimum and its first leaf (lp where no entry is <= m).
template <int NT>
__device__ void row_argmin(const Smem& sm, int lp, float* m_out,
                           int* lid_out) {
  const float m = row_min<NT>(sm, lp);
  int idx = lp;
  for (int l = threadIdx.x; l < lp; l += NT)
    if (sm.row[l] <= m) {
      idx = l;
      break;
    }
  idx = warp_imin(idx);
  if (threadIdx.x % RT == 0) sm.red_i[threadIdx.x / RT] = idx;
  __syncthreads();
  for (int w = 0; w < NT / RT; ++w) idx = min(idx, sm.red_i[w]);
  __syncthreads();
  *m_out = m;
  *lid_out = idx;
}

// Start the copy of leaf row lid into dst (a lid past the table, which
// only a degenerate row can name, reads its last row).
template <int NT>
__device__ __forceinline__ void stage_leaf(float* dst, const float* rows,
                                          int n_rows, int lid) {
  const float* src = rows + (size_t)min(lid, n_rows - 1) * LEAF_N;
  for (int q = 4 * threadIdx.x; q < LEAF_N; q += 4 * NT)
    cp_async16(dst + q, src + q);
}

// Moller-Trumbore of one ray against face k of a shared leaf row, in the
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
__global__ void __launch_bounds__(threads<kAny>())
    resident_walk_kernel(const Params p) {
  constexpr int NT = threads<kAny>();
  constexpr int NWARP = NT / RT;
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve<kAny>(smem, p.lp, p.t_rounds, NWARP);
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / RT;
  const int lane = tid % RT;

  // this lane's ray: lane = ray in every warp
  const float* rr = p.rays + ((size_t)blk * RT + lane) * 8;
  const float ox = rr[0], oy = rr[1], oz = rr[2];
  const float dx = rr[3], dy = rr[4], dz = rr[5];
  const float tmin = rr[6], tmax = rr[7];
  if (warp == 0) {
    const float d3[3] = {dx, dy, dz};
    const float o3[3] = {ox, oy, oz};
    for (int c = 0; c < 3; ++c) {
      sm.ray[c * RT + lane] = o3[c];
      sm.ray[(3 + c) * RT + lane] =
          fabsf(d3[c]) > 1e-20f ? 1.0f / d3[c] : BIG;
      sm.dir[c * RT + lane] = d3[c];
    }
    sm.ray[6 * RT + lane] = tmin;
    sm.ray[7 * RT + lane] = tmax;
  }
  if (kAny && tid < WINDOW * RT) sm.hitw[tid] = 0;
  const bool live = blk * RT < p.count[0];

  // the block's state, the same in every warp
  float ce = p.er[blk];
  int ci = p.ir[blk];
  float bt = tmax, prim = -1.0f, bu = 0.0f, bv = 0.0f;  // closest
  float occ = 0.0f;                                      // any
  int passes = 0, rounds = 0, stamp = 0;
  float done = 1.0f;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int pass = 0; pass < p.max_passes; ++pass) {
    if (tid == 0) {
      sm.ctl[0] = 0;
      sm.ctl[1] = 0;
    }
    if (!kAny && warp == 0) sm.bt[lane] = bt;
    __syncthreads();
    build_row<kAny, NT>(sm, p.aabb, p.lp, live, ce, ci);
    __syncthreads();
    const int n_c = sm.ctl[0];
    const int n_sel = sm.ctl[1] ? 0 : min(n_c, p.t_rounds);
    rank_order<NT>(sm, n_c, p.t_rounds);
    __syncthreads();
    ++passes;

    if (n_sel > 0)
      for (int k = 0; k < min(WINDOW, n_sel); ++k)
        stage_leaf<NT>(sm.leaf + k * LEAF_N, p.rows, p.n_rows,
                       sm.ord_i[k]);
    cp_async_commit();
    int j = 0, buf = 0;
    while (j < p.t_rounds) {
      int nw = 1, fb_lid = 0;
      float m0;
      if (j < n_sel) {
        nw = min(WINDOW, min(n_sel - j, p.t_rounds - j));
        m0 = sm.ord_e[j];
      } else {
        // past the ranked entries the next entry is at least BIG (or the
        // row holds a NaN): only a best t above BIG can take it
        const float max_bt = warp_max(bt);
        if (kAny || !(BIG < max_bt)) break;
        row_argmin<NT>(sm, p.lp, &m0, &fb_lid);
      }
      // votes outside any short-circuit: every lane reaches them
      const bool unocc = __ballot_sync(FULL, occ < 1.0f) != 0u;
      const float max_bt = warp_max(bt);
      if (!(kAny ? (m0 < BIG) && unocc : m0 < max_bt)) break;
      float* cur_leaves = sm.leaf + buf * WINDOW * LEAF_N;
      if (j >= n_sel) {
        stage_leaf<NT>(cur_leaves, p.rows, p.n_rows, fb_lid);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        // the next window, in flight while this one is tested
        const int nj = j + nw;
        float* next = sm.leaf + (buf ^ 1) * WINDOW * LEAF_N;
        for (int k = 0; k < min(WINDOW, n_sel - nj); ++k)
          stage_leaf<NT>(next + k * LEAF_N, p.rows, p.n_rows,
                         sm.ord_i[nj + k]);
        cp_async_commit();
        cp_async_wait<1>();
      }
      ++stamp;
      const unsigned open = __ballot_sync(FULL, occ < 1.0f);
      if (kAny && warp == 0 && occ < 1.0f)
        sm.slots[__popc(open & lanes_below)] = lane;
      __syncthreads();  // the leaves and the slots are in place

      if (kAny) {
        // (slot, face) pairs q = slot + n_u * face of the rays unoccluded
        // at the window's start; thread tid takes q = tid, tid + NT, ...,
        // stepped without a division
        const int n_u = __popc(open);
        const int total = n_u * nw * LEAF;
        const int d_slot = NT % n_u, d_face = NT / n_u;
        int slot = tid % n_u, f = tid / n_u;
        for (int q = tid; q < total; q += NT) {
          const int k = f / LEAF;
          const int ray = sm.slots[slot];
          volatile int* hw = sm.hitw + k * RT + ray;
          if (*hw != stamp) {  // else this ray already hit this leaf
            const Mt h = mt_face(cur_leaves + k * LEAF_N, f % LEAF,
                                 sm.ray[ray], sm.ray[RT + ray],
                                 sm.ray[2 * RT + ray], sm.dir[ray],
                                 sm.dir[RT + ray], sm.dir[2 * RT + ray],
                                 sm.ray[6 * RT + ray], sm.ray[7 * RT + ray]);
            if (h.hit) *hw = stamp;
          }
          slot += d_slot;
          f += d_face;
          if (slot >= n_u) {
            slot -= n_u;
            ++f;
          }
        }
      } else {
        // warp w: faces w, w + NWARP, ... of each window leaf, in order
        for (int k = 0; k < nw; ++k) {
          const float* leaf = cur_leaves + k * LEAF_N;
          Mt f = mt_face(leaf, warp, ox, oy, oz, dx, dy, dz, tmin, bt);
          float tc = f.hit ? f.t : BIG;
          int fc = warp;
          float uc = f.u, vc = f.v;
          if (warp == 0) {
            sm.u0[k * RT + lane] = f.u;
            sm.v0[k * RT + lane] = f.v;
          }
          for (int face = warp + NWARP; face < LEAF; face += NWARP) {
            f = mt_face(leaf, face, ox, oy, oz, dx, dy, dz, tmin, bt);
            const float tt = f.hit ? f.t : BIG;
            if (tt < tc) {
              tc = tt;
              fc = face;
              uc = f.u;
              vc = f.v;
            }
          }
          const int at = (k * NWARP + warp) * RT + lane;
          sm.part_t[at] = tc;
          sm.part_f[at] = fc;
          sm.part_u[at] = uc;
          sm.part_v[at] = vc;
        }
      }
      __syncthreads();  // the window's results are in place

      // resolve the window's rounds in visit order, in every warp
      bool stop = false;
      for (int k = 0; k < nw; ++k) {
        const float m = j < n_sel ? sm.ord_e[j + k] : m0;
        const int lid = j < n_sel ? sm.ord_i[j + k] : fb_lid;
        if (k > 0) {
          const bool unocc_k = __ballot_sync(FULL, occ < 1.0f) != 0u;
          const float max_bt_k = warp_max(bt);
          if (!(kAny ? (m < BIG) && unocc_k : m < max_bt_k)) {
            stop = true;
            break;
          }
        }
        if (kAny) {
          if (sm.hitw[k * RT + lane] == stamp) occ = 1.0f;
        } else {
          float tc = sm.part_t[k * NWARP * RT + lane];
          int fc = sm.part_f[k * NWARP * RT + lane];
          int wc = 0;
          for (int w = 1; w < NWARP; ++w) {
            const float t = sm.part_t[(k * NWARP + w) * RT + lane];
            const int f = sm.part_f[(k * NWARP + w) * RT + lane];
            if (t < tc || (t == tc && f < fc)) {
              tc = t;
              fc = f;
              wc = w;
            }
          }
          if (tc < bt) {
            const int at = (k * NWARP + wc) * RT + lane;
            bt = tc;
            prim = (float)LEAF * (float)lid + (float)fc;
            bu = sm.part_u[at] + 0.0f;
            bv = sm.part_v[at] + 0.0f;
          } else if (BIG < bt) {
            // the reference's round without a hit: BIG at face 0
            bt = BIG;
            prim = (float)LEAF * (float)lid + 0.0f;
            bu = sm.u0[k * RT + lane] + 0.0f;
            bv = sm.v0[k * RT + lane] + 0.0f;
          }
        }
        if (tid == 0) sm.row[lid] = BIG;
        ce = m;
        ci = lid;
        ++rounds;
      }
      if (stop) break;
      j += nw;
      buf ^= 1;
    }
    cp_async_wait<0>();  // no copy outlives its pass

    const float rm = row_min<NT>(sm, p.lp);
    const bool unocc = __ballot_sync(FULL, occ < 1.0f) != 0u;
    const float max_bt = warp_max(bt);
    done = (kAny ? (rm < BIG) && unocc : rm < max_bt) ? 0.0f : 1.0f;
    if (done != 0.0f) break;
  }

  if (warp == 0) {
    float4* o = reinterpret_cast<float4*>(p.out) + (size_t)blk * RT + lane;
    *o = kAny ? make_float4(occ, 0.0f, 0.0f, 0.0f)
              : make_float4(bt, prim, bu, bv);
    if (lane < 8) {
      const float vals[3] = {done, ce, (float)ci};
      p.cur[(size_t)blk * 8 + lane] = lane < 3 ? vals[lane] : 0.0f;
    }
    if (lane == 0) {
      p.stat[2 * blk] = passes;
      p.stat[2 * blk + 1] = rounds;
    }
  }
}

template <bool kAny>
int launch(const Params& p, int n_blk, cudaStream_t s) {
  const size_t bytes =
      smem_words<kAny>(p.lp, p.t_rounds, threads<kAny>() / RT) *
      sizeof(float);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resident_walk_kernel<kAny>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  resident_walk_kernel<kAny><<<n_blk, threads<kAny>(), bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace rw

}  // namespace rt3c

// One K8 launch: n_blk blocks of 32 rays [n_blk * 32, 8], each running up
// to max_passes passes of t_rounds rounds from its cursor (er, ir) until
// its own done flag. rows: [n_rows, 9, 128] leaf rows; aabb: [8, lp] leaf
// boxes; count: the live ray count on the device. Writes out [n_blk * 32,
// 4], cur [n_blk, 8] and stat [n_blk, 2] (int32: passes, rounds). Returns
// a cudaError_t.
extern "C" int rt3c_resident_walk(int device, int any, const int* count,
                                  const float* er, const int* ir,
                                  const float* rays, int n_blk,
                                  const float* rows, int n_rows,
                                  const float* aabb, int lp, int t_rounds,
                                  int max_passes, float* out, float* cur,
                                  int* stat, void* stream) {
  using namespace rt3c::rw;
  if (lp < RT || lp % RT != 0 || t_rounds < 0 || n_blk < 0 ||
      max_passes < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (n_blk == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Params p{count, er,   ir,     rays, rows,   aabb,     out,
                 cur,   stat, n_rows, lp,   t_rounds, max_passes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any ? launch<true>(p, n_blk, s) : launch<false>(p, n_blk, s);
}
