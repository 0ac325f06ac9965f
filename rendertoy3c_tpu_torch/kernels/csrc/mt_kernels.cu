// K1/K2: Moller-Trumbore closest-hit and any-hit over a tiled triangle
// soup; K3: the same for 2-key motion, triangles lerped to each ray's time.
//
// Replaces rendertoy3c_tpu/trace/pallas_mt.py _closest_kernel (:256) and
// _any_kernel (:302), launched by _mt_pallas_call (:340), and
// _closest_kernel_motion (:545) and _any_kernel_motion (:593), launched by
// _mt_motion_call (:632).
//
// Bound: arithmetic. A ray-triangle pair costs ~54 operations (81 lerped)
// and no memory traffic once the tile sits in shared memory. The TPU
// kernel walks the triangle tiles in order for a block of 256 (128) rays
// and stages a tile whenever any ray of the block enters its box: on the
// 16054-face towns that vote admits nearly all 32 tiles while a ray's own
// box test admits 3.5 (static) or 6.4 (2-key), and one thread per ray fills
// only 8 warps of an SM at the pool's 32768 rays. So a sweep here is three
// launches on the caller's stream, with no host synchronisation:
//
//  1. mt_bin_kernel, one thread per ray: a live ray runs its own two-level
//     box test (supertile, then tile) at its tmax, with the plain versions'
//     padded slab test in their float order (trace/mt.py `_slabs`), and
//     appends its index to the list of every tile it enters (one atomicAdd
//     on the tile's counter per warp). Ray tiles of `ray_tile` at or past
//     `count` bin nothing; rays past `count` inside a live tile are traced.
//  2. mt_test_kernel, persistent blocks over the items (tile k, chunk c of
//     k's list), tile-major: a block stages tile k (both keys' tiles for
//     K3) with 16-byte cp.async into one of two shared-memory stages while
//     it tests the previous item from the other; each thread loads
//     test_rays rays of the chunk by index (two for closest, one for
//     any-hit) and tests every face of the tile against them, one
//     broadcast load of a face serving both.
//  3. mt_epilogue_kernel, one thread per ray, writes [R, 4].
//
// Closest: min t, lowest prim at equal t, in whatever order the tiles are
// tested. A thread keeps its tile-local best in face order (strict <, the
// bound its best so far, as the sequential sweep), then merges it into the
// ray's 64-bit key by atomicMin: t's order-preserving bits (-0 as +0) in
// the high word, the prim in the low word (hit_key). The epilogue
// recomputes the winning face's test for t, u and v: the same arithmetic,
// so the same bits. Any-hit: a ray's key drops to 0 at its first hit; a
// ray found occluded from another tile skips its tests.
//
// Float order: every expression keeps the left-to-right order of the JAX
// code, and the build passes --fmad=false, so no a*b+c is contracted.
//
// Output [R, 4]: closest (t, prim as float, u, v), miss = (tmax, -1, 0, 0);
// any (occluded, 0, 0, 0). `count` is read on the device only.
//
// Workspace (int32 words, allocated by the wrapper, `workspace_words` in
// trace/mt.py): R 64-bit keys, n_tiles counters, then each tile's list of
// R ray indices: a ray enters a tile's list at most once.
#include <algorithm>

#include "mt.cuh"

namespace rt3c {

constexpr int BIN_THREADS = 256;
constexpr int TEST_THREADS = 128;
// rays per thread of mt_test_kernel: two share each face's loads in a
// closest sweep; an any-hit thread stops at its ray's first hit, so one
__host__ __device__ constexpr int test_rays(bool any) { return any ? 1 : 2; }
constexpr float BOX_PAD = 1e-3f;  // trace/mt.py BOX_PAD
constexpr unsigned long long NO_HIT = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

struct Sweep {
  const float* rays;
  const float* time;  // [R] ray times (K3), else null
  int n_rays;
  int ray_tile;
  const int* count;
  const float* tris0;  // [n_tiles, 9, ct]
  const float* tris1;  // the key-1 tiles (K3), else null
  const float* aabb;
  const float* super_aabb;
  int n_tiles;
  int ct;
  unsigned long long* keys;  // [R]
  int* cnt;                  // [n_tiles]
  int* lists;                // [n_tiles, R]
  float* out;                // [R, 4]
};

// The ray's closest-hit key: (t, prim) in lexicographic order as unsigned.
__device__ __forceinline__ unsigned long long hit_key(float t, int prim) {
  unsigned b = __float_as_uint(t == 0.0f ? 0.0f : t);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) |
         static_cast<unsigned>(prim);
}

// The plain versions' slab test of one box (`_slabs` and `own` of
// trace/mt.py) at the ray's tmax: the box grown by BOX_PAD of its size and
// place, an inverted (empty) box entering no ray.
__device__ __forceinline__ bool padded_box_hit(const float* box, const Ray& r,
                                               float ix, float iy, float iz) {
  const float lx = box[0], ly = box[1], lz = box[2];
  const float hx = box[3], hy = box[4], hz = box[5];
  const float mx = fmaxf(hx - lx, fmaxf(fabsf(lx), fabsf(hx)));
  const float my = fmaxf(hy - ly, fmaxf(fabsf(ly), fabsf(hy)));
  const float mz = fmaxf(hz - lz, fmaxf(fabsf(lz), fabsf(hz)));
  const float pad = BOX_PAD * (1.0f + fmaxf(fmaxf(mx, my), mz));
  const float t0x = ((lx - pad) - r.ox) * ix;
  const float t1x = ((hx + pad) - r.ox) * ix;
  const float t0y = ((ly - pad) - r.oy) * iy;
  const float t1y = ((hy + pad) - r.oy) * iy;
  const float t0z = ((lz - pad) - r.oz) * iz;
  const float t1z = ((hz + pad) - r.oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return (lx <= hx) && (ly <= hy) && (lz <= hz) && (tn <= tf) &&
         (tf >= r.tmin - pad) && (tn <= r.tmax + pad);
}

__global__ void __launch_bounds__(BIN_THREADS) mt_bin_kernel(Sweep s) {
  const int i = blockIdx.x * BIN_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in = i < s.n_rays;
  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (in) {
    r = load_ray(s.rays, i);
    s.keys[i] = NO_HIT;
  }
  const bool live =
      in && (i / s.ray_tile) * s.ray_tile < *s.count && r.tmax > r.tmin;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  const int n_super = (s.n_tiles + SUPER_TILE - 1) / SUPER_TILE;
  // every lane of the warp reaches each ballot
  for (int ks = 0; ks < n_super; ++ks) {
    const bool in_super =
        live && padded_box_hit(s.super_aabb + 8 * ks, r, ix, iy, iz);
    if (!__any_sync(FULL, in_super)) continue;
    const int k_end = min((ks + 1) * SUPER_TILE, s.n_tiles);
    for (int k = ks * SUPER_TILE; k < k_end; ++k) {
      const bool enter =
          in_super && padded_box_hit(s.aabb + 8 * k, r, ix, iy, iz);
      const unsigned m = __ballot_sync(FULL, enter);
      if (m == 0) continue;
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(s.cnt + k, __popc(m));
      base = __shfl_sync(FULL, base, leader);
      if (enter)
        s.lists[(size_t)k * s.n_rays + base +
                __popc(m & ((1u << lane) - 1u))] = i;
    }
  }
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

// Start the copy of tile k ([9, ct] per key) into a shared-memory stage.
template <bool kMotion>
__device__ __forceinline__ void stage_async(const Sweep& s, int k,
                                            float* dst) {
  const int n = 9 * s.ct;
  const float* src0 = s.tris0 + (size_t)k * n;
  for (int q = 4 * threadIdx.x; q < n; q += 4 * TEST_THREADS)
    cp_async16(dst + q, src0 + q);
  if (kMotion) {
    const float* src1 = s.tris1 + (size_t)k * n;
    for (int q = 4 * threadIdx.x; q < n; q += 4 * TEST_THREADS)
      cp_async16(dst + n + q, src1 + q);
  }
}

// Chunk c of tile k's list against the staged tile: every face, in order,
// for each of the thread's rays; then the merge into the rays' keys.
template <bool kAny, bool kMotion>
__device__ __forceinline__ void test_chunk(const Sweep& s, int k, int c,
                                           const float* tile) {
  constexpr int TEST_RAYS = test_rays(kAny);
  constexpr int CHUNK = TEST_THREADS * TEST_RAYS;
  const int ct = s.ct;
  const int n = s.cnt[k];
  const int* list = s.lists + (size_t)k * s.n_rays;
  Ray r[TEST_RAYS];
  float tm[TEST_RAYS], best[TEST_RAYS];
  int idx[TEST_RAYS], best_j[TEST_RAYS];
  bool todo[TEST_RAYS];
  bool any_todo = false;
#pragma unroll
  for (int a = 0; a < TEST_RAYS; ++a) {
    const int slot = c * CHUNK + a * TEST_THREADS + threadIdx.x;
    idx[a] = slot < n ? list[slot] : -1;
    todo[a] = idx[a] >= 0;
    if (kAny && todo[a])
      todo[a] = *reinterpret_cast<volatile unsigned long long*>(
                    s.keys + idx[a]) == NO_HIT;
    // a ray with tmin = tmax = 0 hits nothing
    r[a] = todo[a] ? load_ray(s.rays, idx[a])
                   : Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    tm[a] = (kMotion && todo[a]) ? s.time[idx[a]] : 0.0f;
    best[a] = r[a].tmax;
    best_j[a] = -1;
    any_todo |= todo[a];
  }
  if (!any_todo) return;
  for (int j = 0; j < ct; ++j) {
    float c0[9], dc[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      c0[q] = tile[q * ct + j];
      if (kMotion) dc[q] = tile[(9 + q) * ct + j] - c0[q];
    }
#pragma unroll
    for (int a = 0; a < TEST_RAYS; ++a) {
      if (kAny && !todo[a]) continue;
      float e[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) e[q] = kMotion ? c0[q] + dc[q] * tm[a] : c0[q];
      float t, u, v;
      if (mt_test_tri(r[a], best[a], e[0], e[1], e[2], e[3], e[4], e[5], e[6],
                      e[7], e[8], t, u, v)) {
        best[a] = t;
        best_j[a] = j;
        if (kAny) todo[a] = false;
      }
    }
    if (kAny) {
      bool left = false;
#pragma unroll
      for (int a = 0; a < TEST_RAYS; ++a) left |= todo[a];
      if (!left) break;
    }
  }
#pragma unroll
  for (int a = 0; a < TEST_RAYS; ++a) {
    if (best_j[a] < 0) continue;
    if (kAny)
      s.keys[idx[a]] = 0ull;
    else
      atomicMin(s.keys + idx[a], hit_key(best[a], k * ct + best_j[a]));
  }
}

template <bool kAny, bool kMotion>
__global__ void __launch_bounds__(TEST_THREADS) mt_test_kernel(Sweep s) {
  extern __shared__ __align__(16) float stages[];
  constexpr int CHUNK = TEST_THREADS * test_rays(kAny);
  const int stage_floats = (kMotion ? 18 : 9) * s.ct;
  // item -> (tile, chunk), tile-major; a block's items only grow, so the
  // scan over the tiles' counters resumes where it stopped
  int scan_k = 0, scan_base = 0;
  auto find = [&](int item, int& k, int& c) {
    while (scan_k < s.n_tiles) {
      const int chunks = (s.cnt[scan_k] + CHUNK - 1) / CHUNK;
      if (item < scan_base + chunks) {
        k = scan_k;
        c = item - scan_base;
        return true;
      }
      scan_base += chunks;
      ++scan_k;
    }
    return false;
  };
  int item = blockIdx.x, k = 0, c = 0, buf = 0;
  bool have = find(item, k, c);
  if (have) stage_async<kMotion>(s, k, stages);
  cp_async_commit();
  while (have) {
    int k2 = 0, c2 = 0;
    item += gridDim.x;
    const bool have2 = find(item, k2, c2);
    if (have2) stage_async<kMotion>(s, k2, stages + (buf ^ 1) * stage_floats);
    cp_async_commit();
    cp_async_wait<1>();  // this item's stage has landed
    __syncthreads();
    test_chunk<kAny, kMotion>(s, k, c, stages + buf * stage_floats);
    __syncthreads();  // its stage is free for the item after next
    k = k2;
    c = c2;
    have = have2;
    buf ^= 1;
  }
}

template <bool kAny, bool kMotion>
__global__ void __launch_bounds__(BIN_THREADS) mt_epilogue_kernel(Sweep s) {
  const int i = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (i >= s.n_rays) return;
  const unsigned long long key = s.keys[i];
  float4 res;
  if (kAny) {
    res = make_float4(key != NO_HIT ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    const Ray r = load_ray(s.rays, i);
    if (key == NO_HIT) {
      res = make_float4(r.tmax, -1.0f, 0.0f, 0.0f);
    } else {
      const int prim = static_cast<int>(key & 0xffffffffu);
      const int k = prim / s.ct, j = prim - k * s.ct;
      const float* f0 = s.tris0 + (size_t)k * 9 * s.ct + j;
      float e[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        e[q] = f0[q * s.ct];
        if (kMotion) {
          const float r1 = s.tris1[(size_t)k * 9 * s.ct + j + q * s.ct];
          e[q] = e[q] + (r1 - e[q]) * s.time[i];
        }
      }
      float t, u, v;
      mt_test_tri(r, r.tmax, e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7],
                  e[8], t, u, v);
      res = make_float4(t, static_cast<float>(prim), u, v);
    }
  }
  reinterpret_cast<float4*>(s.out)[i] = res;
}

template <bool kAny, bool kMotion>
cudaError_t launch_sweep(const Sweep& s, cudaStream_t st) {
  const int rows = (s.n_rays + BIN_THREADS - 1) / BIN_THREADS;
  const size_t smem = 2 * (kMotion ? 18 : 9) * (size_t)s.ct * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mt_test_kernel<kAny, kMotion>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, n_sm = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mt_test_kernel<kAny, kMotion>, TEST_THREADS, smem);
  if (e != cudaSuccess) return e;
  // persistent: every block resident, none without an item to start
  constexpr int CHUNK = TEST_THREADS * test_rays(kAny);
  const long long items =
      (long long)s.n_tiles * ((s.n_rays + CHUNK - 1) / CHUNK);
  const int grid =
      (int)std::min<long long>((long long)std::max(per_sm, 1) * n_sm, items);
  mt_test_kernel<kAny, kMotion><<<grid, TEST_THREADS, smem, st>>>(s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mt_epilogue_kernel<kAny, kMotion><<<rows, BIN_THREADS, 0, st>>>(s);
  return cudaGetLastError();
}

}  // namespace rt3c

// mode 0: closest, 1: any-hit, 2: the binning alone (the tiles' list
// lengths are left in the workspace's counters). tris1 is given for K3 and
// null for K1/K2; time likewise, except that the binning needs none.
extern "C" int rt3c_mt_sweep(int device, int mode, const float* rays,
                             const float* time, int n_rays, int ray_tile,
                             const int* count, const float* tris0,
                             const float* tris1, const float* aabb,
                             const float* super_aabb, int n_tiles, int ct,
                             int* ws, float* out, void* stream) {
  const bool motion = tris1 != nullptr;
  if ((ray_tile != rt3c::RAY_TILE && ray_tile != rt3c::MOTION_RAY_TILE) ||
      n_rays < 0 || n_rays % ray_tile != 0 || ct > rt3c::MAX_CT || ct < 1 ||
      ct % 4 != 0 || n_tiles < 1 || mode < 0 || mode > 2 ||
      (mode != 2 && motion != (time != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto* keys = reinterpret_cast<unsigned long long*>(ws);
  int* cnt = ws + 2 * (size_t)n_rays;
  const rt3c::Sweep s{rays,   time,       n_rays,  ray_tile, count,
                      tris0,  tris1,      aabb,    super_aabb, n_tiles,
                      ct,     keys,       cnt,     cnt + n_tiles, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(cnt, 0, sizeof(int) * n_tiles, st);
  if (e != cudaSuccess) return (int)e;
  rt3c::mt_bin_kernel<<<(n_rays + rt3c::BIN_THREADS - 1) / rt3c::BIN_THREADS,
                        rt3c::BIN_THREADS, 0, st>>>(s);
  e = cudaGetLastError();
  if (e != cudaSuccess || mode == 2) return (int)e;
  if (mode == 1)
    e = motion ? rt3c::launch_sweep<true, true>(s, st)
               : rt3c::launch_sweep<true, false>(s, st);
  else
    e = motion ? rt3c::launch_sweep<false, true>(s, st)
               : rt3c::launch_sweep<false, false>(s, st);
  return (int)e;
}
