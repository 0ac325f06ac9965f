"""tools/ab.py's summary: the mean of each turn number per checkout, and
the agreement of the checkouts' outputs; its workloads' usage and
argument check; the inputs of `instanced-mt` gathered on the CPU at a
small size. The turns themselves need a CUDA card."""
import sys

import pytest

from rendertoy3c_tpu_torch.tools import ab


def _run(root, ms, identity):
    return dict(root=root, subframe_s=2 * ms, identity=identity,
                means={"closest_device_ms": ms, "any_device_ms": 3 * ms})


@pytest.mark.parametrize("identity_b, same", [("x", True), ("y", False)])
def test_summary_means_per_checkout_and_agreement(identity_b, same):
    runs = [_run("A", 1.0, "x"), _run("B", 2.0, identity_b),
            _run("B", 4.0, identity_b), _run("A", 3.0, "x")]
    got = ab.summary(["A", "B"], runs)
    assert got["same_outputs"] is same
    assert got["mean_per_checkout"] == {
        "A": {"closest_device_ms": 2.0, "any_device_ms": 6.0,
              "subframe_s": 4.0},
        "B": {"closest_device_ms": 3.0, "any_device_ms": 9.0,
              "subframe_s": 6.0}}


def test_every_workload_is_listed_in_the_usage():
    for name in ab.WORKLOADS:
        assert name in ab.__doc__


@pytest.mark.parametrize("argv", [["walk-round"], ["walk-rounds", "."]],
                         ids=["no_root", "unknown_workload"])
def test_walk_round_is_listed_and_its_arguments_checked(argv, monkeypatch,
                                                        capsys):
    """Without a root, or with a workload's name misspelt, the tool
    prints the usage, which lists `walk-round`, and exits 2 before it
    looks for a card."""
    monkeypatch.setattr(sys, "argv", ["ab.py", *argv])
    assert ab.main() == 2
    assert "walk-round" in capsys.readouterr().err


def test_instanced_mt_inputs():
    """`instanced-mt`'s inputs at 32^2, 1 spp, depth 3, a pool of 512
    and 2048 field rays on the CPU: PICKS recorded calls of each kind,
    each with at least half a pool live, and the field's rays, each
    traced by K7's plain version to a hit somewhere; the spread field
    rays enter the towers, the first pixels' only the floor."""
    import torch

    from rendertoy3c_tpu_torch.trace import instanced_mt as im

    cfg = dict(width=32, height=32, samples_per_launch=1, max_depth=3,
               ray_block=512, integrator="pool", pool_pixel_major=True)
    inputs, soups, accum, _ = ab._k7_inputs(torch.device("cpu"), cfg,
                                            field_rays=2048, every=2)
    assert accum > 0.0
    assert sorted(inputs) == [("field", "any"), ("field", "closest"),
                              ("field_spread", "any"),
                              ("field_spread", "closest"),
                              ("path", "any"), ("path", "closest")]
    for (where, kind), launches in inputs.items():
        assert len(launches) == (ab.PICKS if where == "path" else 1)
        for rays, count in launches:
            assert rays.shape == ((512, 8) if where == "path" else (2048, 8))
            assert int(count) >= rays.shape[0] // 2
            out = im.trace_instanced(rays, count, soups[where],
                                     kind == "any")
            assert bool((out[:, 0 if kind == "any" else 1] > 0).any())
            if kind == "closest" and where != "path":
                inst = out[:, 4].long()
                hit = inst >= 0
                # the tower mesh is the one of more than one tile
                tiles = soups[where].inst_tiles[inst[hit], 1]
                assert bool((tiles > 1).any()) == (where == "field_spread")


def test_megakernel_inputs_and_digests(tmp_path):
    """`megakernel`'s inputs at 48^2, 2 spp, depth 3 and a pool of 512 on
    the CPU: PICKS recorded calls of each path, each with at least half
    the pool live, each K4 call with a pool's worth of pixels left; a
    recorded call run twice gives one digest; a later turn's picks take
    the first turn's saved states; and K4's digest does not move when the
    lanes that claimed pixels trade their rows."""
    import torch

    cfg = dict(width=48, height=48, samples_per_launch=2, max_depth=3,
               ray_block=512, integrator="pool", pool_pixel_major=True)
    inputs, sums, _ = ab._mega_inputs(torch.device("cpu"), cfg, every=1)
    assert list(inputs) == [name for name, _, _ in ab.MEGA_PATHS]
    assert all(s > 0.0 for s in sums.values())
    for name, (launch, picks) in inputs.items():
        assert len(picks) == ab.PICKS
        for args, kw in picks:
            if name.startswith("k4"):
                assert int(args[3][2]) >= 256
                assert int(args[3][0]) + 512 <= kw["rc"].n_pix
            else:
                assert int(args[2]) >= 256
        digests = []
        for _ in range(2):
            calls, digest = launch(picks[0], 2)
            for call in calls:
                call()
            digests.append(digest())
        assert digests[0] == digests[1]
    path = str(tmp_path / "picks.pt")
    assert ab._shared_picks(inputs, path) is inputs
    other = {name: (launch, [(tuple(a.clone() + 1 if isinstance(
        a, torch.Tensor) and a.is_floating_point() else a for a in args),
        kw) for args, kw in picks]) for name, (launch, picks) in
        inputs.items()}
    back = ab._shared_picks(other, path)
    for name, (_, picks) in back.items():
        for (args, _), (want, _) in zip(picks, inputs[name][1]):
            for a, w in zip(args, want):  # seeds may read as NaN
                assert a is w or torch.equal(a.view(torch.int32),
                                             w.view(torch.int32))
    launch, picks = inputs["k4"]
    runs = []
    for args, kw in picks:
        calls, _ = launch((args, kw))
        calls[0]()
        after = calls[0].args[0]
        claimed = ((after[1][:, 13] != args[1][:, 13])
                   & (after[1][:, 13] >= 0)).nonzero()[:, 0]
        runs.append((claimed.numel(), args, after, claimed))
    _, args, after, claimed = max(runs, key=lambda r: r[0])
    assert claimed.numel() > 1
    swapped = [x.clone() if isinstance(x, torch.Tensor) else x
               for x in after]
    turn = claimed.roll(1)
    swapped[0][claimed] = after[0][turn]
    # misc but column 15 (the finished path's want_shadow) follows the pixel
    swapped[1][claimed, :15] = after[1][turn, :15]
    swapped[1][claimed, 16:] = after[1][turn, 16:]
    assert ab._k4_digest(args, swapped) == ab._k4_digest(args, after)
    swapped[0][claimed[0], 0] += 1.0
    assert ab._k4_digest(args, swapped) != ab._k4_digest(args, after)
