"""The agreement rule of K6's plain version (`external_shade_ref`) against
the reference's external shader in interpret mode, for one teacher-forced
iteration (tests/test_torch_walk_shade.py, tests/test_torch_inst_shade.py).

Both compute every lane in float32 in the same operation order, but XLA on
the CPU contracts a + b * c into FMAs where the host has them and brings
its own sin, cos and sqrt; torch does neither. Their results differ by a
few ulps before any amplification, and by how many depends on the host.
On a lane whose result is ill-conditioned, the difference is amplified:
the Lambertian weight divides by the sampled cosine (1 - x^2 - y^2
cancels, amplification 1 / wz^2), the NEE term by the light's and the
surface's cosines (dot products that cancel), and the shadow ray's
direction normalises lp - p (cancels where the hit lies near the light).
A fixed tolerance on a fixed share of lanes sits on the edge of that
spread, so the rule holds each lane to what the port guarantees:

- the integer columns (seed bits, depth, pixel, sample) bit-equal on every
  lane: integer arithmetic, no float decides them;
- the draws pinned: every lane's light-pick and Russian-roulette draws
  equal the LCG draws computed here from its input seed, and its light
  index the pick computed here from that draw (uniform or power CDF);
- the decisions (alive after Russian roulette, want_shadow) equal on every
  lane, except edge lanes, whose deciding float lies within EDGE times its
  amplified rounding of its threshold (u_rr against p_rr, n.l against 0):
  a last-ulp difference may flip them, and a flip changes the lane wholly;
- every float of every live lane off an edge within rtol = atol = EPS x
  kappa, kappa the lane's amplification (at least 1) from the plain
  version's own intermediates; where kappa is unbounded (a cosine of
  exactly 0: the hit lies in the light's plane, whose sample is then
  degenerate and its NEE term 0; at most 20 of ~500 live lanes), the
  float is held exact. Measured over every case of both files (4
  iterations, 512 lanes), with XLA's FMAs and without them
  (`--xla_cpu_max_isa=AVX` or `SSE4_2`): the worst lane of the
  instanced field's cases reaches 0.40-0.52 of its bound (a hit point at
  y = 20 - 20, half an ulp of 20), every other case stays below 0.17.

The rule cannot pass by calling every lane ill-conditioned: at most
LOOSE_SHARE of the live lanes may have kappa above LOOSE, and at most
EDGE_SHARE may sit on an edge.

The cause (XLA's FMAs and its own sin and cos) is inferred, not
confirmed: on the hosts where these cases were measured they pass under
the old fixed share too, and no XLA or ATen setting tried there
reproduced the failures seen on other hosts (PERF.md, open questions)."""
import numpy as np
import torch

from rendertoy3c_tpu_torch.trace import shade

INT_COLS = (0, 8, 13, 14)  # seed bits, depth, pixel, sample
DECISION_COLS = (9, 15)  # alive after Russian roulette, want_shadow
EPS = 1e-6  # ~8 float32 ulps of 1
EDGE = 10.0  # a decision's margin, in amplified EPS
LOOSE, LOOSE_SHARE = 100.0, 0.4  # measured: at most 0.34 (material Cornell)
EDGE_SHARE = 0.1  # measured: at most 0.066 (the instanced field)


def pinned_draws(seed_bits: np.ndarray, adv: np.ndarray, n: int = 8):
    """[n, R] float32 draws of each lane's LCG stream from its input seed
    (uint32 bits): the stream advances only on `adv` lanes (rnd_masked)."""
    s = seed_bits.astype(np.uint64)
    out = []
    for _ in range(n):
        nxt = (1664525 * s + 1013904223) & 0xFFFFFFFF
        out.append((nxt & 0xFFFFFF).astype(np.float32)
                   * np.float32(1.0 / 16777216.0))
        s = np.where(adv, nxt, s)
    return np.stack(out)


def _pick(u: np.ndarray, config, lights_t: np.ndarray) -> np.ndarray:
    n = config.num_lights
    if config.power:
        idx = np.searchsorted(lights_t[17, :n], u, side="right")
    else:
        idx = np.floor(u * np.float32(n)).astype(np.int64)
    return np.minimum(idx, n - 1)


def check_iteration(rays, hit4, misc, got, want, tables, config,
                    transposed: bool, inst=None) -> dict:
    """Asserts the rule on one iteration: rays [R, 8], hit4 [R, 4] and misc
    (C-major [MW, R] if `transposed`, else [R, MW]) as numpy, the outputs
    `got` (the port's plain version) and `want` (the reference's) as lists
    of numpy arrays in their own layout. Returns the shares."""
    m = misc if transposed else misc.T  # [MW, R]
    g1, w1 = (got[1], want[1]) if transposed else (got[1].T, want[1].T)
    rt, ht = torch.as_tensor(rays), torch.as_tensor(hit4)
    a = tables.attr[torch.clamp(ht[:, 1], min=0.0).to(torch.int64)].T
    it = (None if tables.inst_rows is None
          else shade.gather_inst_rows(tables.inst_rows, torch.as_tensor(inst)))
    r = shade._shade_lanes(rt, ht, torch.as_tensor(np.ascontiguousarray(m.T)),
                           a, tables.lights_t, config, tex=tables.tex,
                           params_base=tables.params_base, it=it)
    c = {k: v.numpy() for k, v in r["cond"].items()}
    n = rays.shape[0]
    live = m[9] > 0
    adv = live & (hit4[:, 1] >= 0)

    # the integer columns, every lane
    bits_g, bits_w = g1.view(np.uint32), w1.view(np.uint32)
    bad = [k for k in INT_COLS if (bits_g[k] != bits_w[k]).any()]
    assert not bad, f"integer columns {bad} differ"

    # the draws pinned, and the light pick they make
    u = pinned_draws(m[0].view(np.uint32), adv)
    assert np.array_equal(c["u_pick"], u[4]) and np.array_equal(
        c["u_rr"], u[7]), "the pick or roulette draw is not the pinned one"
    assert np.array_equal(c["lidx"].astype(np.int64), _pick(
        u[4], config, tables.lights_t.numpy())), "light pick"

    # each lane's amplification of a last-ulp difference: the hit point's
    # (o + t d cancels), the Lambertian weight's (and so p_rr's), the
    # shadow direction's (lp - p cancels), the NEE term's
    o, d, t = rays[:, 0:3], rays[:, 3:6], hit4[:, :1]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        span = np.linalg.norm(o, axis=1) + np.linalg.norm(t * d, axis=1)
        k_p = np.maximum(1.0, span / (1.0 + np.linalg.norm(o + t * d,
                                                           axis=1)))
        k_bsdf = np.maximum(1.0, 1.0 / np.square(c["wz"]))
        k_dir = np.maximum(1.0, (span + 1.0) / c["ldist"])
        k_nee = k_dir * np.maximum.reduce([
            np.ones(n), 1.0 / np.abs(c["cos_l"]), 1.0 / np.abs(c["n_dl"])])
    if tables.params_base:
        # a principled lane's GGX terms divide by a2 = roughness^4
        rough = a[tables.params_base + 1].numpy()
        prin = a[tables.params_base].numpy() == 3.0
        k_mat = np.where(prin, 1.0 / np.square(np.maximum(
            np.square(rough), 1e-4)), 1.0)
        k_bsdf, k_nee = k_bsdf * k_mat, k_nee * k_mat
    k_p, k_bsdf, k_dir, k_nee = (np.nan_to_num(k, nan=np.inf)
                                 for k in (k_p, k_bsdf, k_dir, k_nee))

    # the decisions, off their edges: where the roulette flips, the bounce
    # ray and the attenuation differ wholly; where want_shadow does, the
    # NEE term and the shadow ray's tmax
    rr_edge = adv & (np.abs(c["u_rr"] - c["p_rr"]) <= EDGE * EPS * k_bsdf
                     * np.maximum(np.abs(c["p_rr"]), 1.0))
    nee_edge = adv & (np.abs(c["n_dl"]) <= EDGE * EPS * k_dir)
    for k, edge in zip(DECISION_COLS, (rr_edge, nee_edge)):
        diff = np.where((g1[k] != w1[k]) & ~edge)[0]
        assert diff.size == 0, f"column {k} differs off an edge: {diff}"

    # every float of every live lane within EPS x its column's kappa, off
    # the edge that decides the column
    one = np.ones(n)
    mw = m.shape[0]
    misc_k = [(one, None)] * g1.shape[0]
    for k in (1, 2, 3):
        misc_k[k] = (k_bsdf, rr_edge)
    for k in (4, 5, 6):
        misc_k[k] = (k_bsdf, None)
    for k in INT_COLS + DECISION_COLS:
        misc_k[k] = (None, None)  # checked above
    for k in range(mw, mw + 3):
        misc_k[k] = (k_nee, nee_edge)
    # the bounce direction carries wz's own error, 1 / wz
    rays_k = ([(k_p, rr_edge)] * 3 + [(np.sqrt(k_bsdf), rr_edge)] * 3
              + [(one, None)] * 2)
    shadow_k = ([(k_p, None)] * 3 + [(k_dir, None)] * 3 + [(one, None)]
                + [(k_dir, nee_edge)] + [(one, None)] * (got[2].shape[1] - 8))
    worst = (0.0, None, None)
    for name, g, w, ks in (("rays", got[0].T, want[0].T, rays_k),
                           ("misc", g1, w1, misc_k),
                           ("shadow", got[2].T, want[2].T, shadow_k)):
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        with np.errstate(invalid="ignore", over="ignore"):
            err = np.where(same, 0.0, np.nan_to_num(
                np.abs(g - w) / (1.0 + np.abs(w)), nan=np.inf))
        for col, (kappa, edge) in enumerate(ks):
            if kappa is None:
                continue
            on = live if edge is None else live & ~edge
            e, k = err[col][on], kappa[on]
            with np.errstate(invalid="ignore"):
                ratio = np.where(np.isinf(k), np.where(e > 0, np.inf, 0.0),
                                 e / (EPS * k))
            bad = np.where(on)[0][ratio > 1.0]
            assert bad.size == 0, (
                f"{name} column {col}: lanes {bad[:8]} beyond EPS x kappa "
                f"(error {err[col][bad[:8]]}, kappa {kappa[bad[:8]]})")
            if ratio.size and ratio.max() > worst[0]:
                worst = (float(ratio.max()), name, col)
    loose = float((np.maximum(k_bsdf, k_nee)[live] > LOOSE).mean())
    edges = float((rr_edge | nee_edge)[live].mean())
    assert loose <= LOOSE_SHARE and edges <= EDGE_SHARE, (loose, edges)
    return dict(loose=loose, edges=edges, worst=worst)
