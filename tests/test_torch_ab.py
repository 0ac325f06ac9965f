"""tools/ab.py's summary: the mean of each turn number per checkout, and
the agreement of the checkouts' outputs; its workloads' usage and
argument check. The turns themselves need a CUDA card."""
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
