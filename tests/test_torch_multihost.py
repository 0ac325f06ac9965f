"""The port's multi-process render (parallel/multihost.py): two gloo
processes on loopback, each one rank of a 2 x 1 (tile, spp) mesh, must
assemble the single-process image bit for bit with equal ray counts, as
tests/test_multihost.py asks of the reference. Meshes with an spp axis,
1 x 2 over two processes and 2 x 2 over four (tools/mesh_check.py), run
the step's collectives (the spp groups' all_reduce and the division, the
counters' sum, the gather's choice of bands): their image is bit-equal
to the same ranks' work in one process with equal ray counts, and keeps
to one device's mean. The workers run in subprocesses with a timeout of
their own, on a free port, so that test workers running side by side do
not collide."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(width=32, height=32, samples_per_launch=2, max_depth=3,
           ray_block=256, integrator="pool")

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
pid, port, outdir, kind = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.parallel.multihost import (
    assemble_film, init_multihost, make_render_fn_multihost)
from rendertoy3c_tpu_torch.scene.builtin import cornell_box
from rendertoy3c_tpu_torch.scene.scene import build_scene

init_multihost("127.0.0.1:" + port, 2, pid, device="cpu")
cfg = RenderConfig(**%r)
meshes, camera = cornell_box()
camera.aspect_ratio = 1.0
step, mesh, film = make_render_fn_multihost(
    build_scene(meshes), cfg, tracer_kind=kind, device="cpu")
assert mesh.shape == {"tile": 2, "spp": 1} and mesh.rank == pid
rays = [0, 0]
for _ in range(2):
    film, stats = step(camera.params(), film)
    rays[0] += int(stats.radiance_rays)
    rays[1] += int(stats.shadow_rays)
img = assemble_film(film.accum, mesh)
np.save(outdir + "/img%%d.npy" %% pid, img.numpy())
np.save(outdir + "/rays%%d.npy" %% pid, np.asarray(rays))
torch.distributed.destroy_process_group()
print("worker", pid, "ok", flush=True)
""" % CFG


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@pytest.mark.parametrize("kind", ["brute", "auto"])
def test_two_process_render_bit_identical(tmp_path, kind):
    """brute: the brute pair under the general pool; auto: the fused
    pipeline (the plain K4 on the CPU)."""
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import render_frame
    from rendertoy3c_tpu_torch.parallel.dist import prepare_tracer_factory
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(pid), port, str(tmp_path), kind],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    outs = []
    for pr in procs:
        try:
            outs.append(pr.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    img0, img1 = (np.load(tmp_path / f"img{p}.npy") for p in (0, 1))
    np.testing.assert_array_equal(img0, img1)
    rays = np.load(tmp_path / "rays0.npy")
    np.testing.assert_array_equal(rays, np.load(tmp_path / "rays1.npy"))

    cfg = RenderConfig(**CFG)
    meshes, camera = cornell_box()
    camera.aspect_ratio = 1.0
    scene, fac = prepare_tracer_factory(build_scene(meshes), cfg, kind,
                                        device="cpu")
    film, stats = render_frame(scene, camera.params(), cfg, subframes=2,
                               tracer=fac(scene, None, cfg), device="cpu")
    want = film.accum.numpy()
    assert img0.shape == want.shape
    np.testing.assert_array_equal(img0.view(np.int32), want.view(np.int32))
    assert rays.tolist() == [int(stats.radiance_rays),
                             int(stats.shadow_rays)]
    assert torch.isfinite(torch.from_numpy(img0)).all()


def test_cli_mesh_shape_two_processes(tmp_path):
    """`--mesh-shape 2x1 --num-hosts 2`: two CLI processes on loopback;
    process 0 writes the image, byte-equal to one process's (the EXR holds
    the linear floats); a mesh that does not match the process count
    exits 2."""
    args = ["--scene", "cornell", "--size", "32x32", "--spp", "2",
            "--subframes", "2", "--max-depth", "3", "--device", "cpu"]
    cli = [sys.executable, "-m", "rendertoy3c_tpu_torch.app.cli"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    one = tmp_path / "one.exr"
    subprocess.run(cli + args + ["-o", str(one)], env=env, cwd=REPO,
                   check=True, timeout=240, capture_output=True)
    port = _free_port()
    out = tmp_path / "mesh.exr"
    procs = [subprocess.Popen(
        cli + args + ["--mesh-shape", "2x1", "--num-hosts", "2",
                      "--host-id", str(pid), "--coordinator",
                      f"127.0.0.1:{port}", "-o", str(out)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    logs = []
    for pr in procs:
        try:
            logs.append(pr.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("CLI process timed out")
    assert [pr.returncode for pr in procs] == [0, 0], logs
    assert "wrote" in logs[0] and "wrote" not in logs[1]
    assert out.read_bytes() == one.read_bytes()
    bad = subprocess.run(cli + args + ["--mesh-shape", "2x1", "-o",
                                       str(tmp_path / "x.png")],
                         env=env, cwd=REPO, timeout=240,
                         capture_output=True, text=True)
    assert bad.returncode == 2 and "needs 2 processes" in bad.stderr


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_spp_mesh_processes_match_in_process(tmp_path, shape):
    """tools/mesh_check.py over gloo: the fused pipeline (the plain K4)
    at 32^2, 2 spp, 2 subframes; its checks pass, and the gathered image
    is bit-equal to render_mesh_in_process's here, the rays equal."""
    import dataclasses

    from rendertoy3c_tpu_torch.film.film import film_accumulate, film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.parallel.dist import (prepare_tracer_factory,
                                                     render_mesh_in_process)
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "rendertoy3c_tpu_torch.tools.mesh_check",
         "--mesh-shape", shape, "--device", "cpu", "--out", str(tmp_path),
         "--timeout", "200"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["backend"] == "gloo", result
    assert "mean_within_5pct" in result["checks"]

    n_tile, n_spp = (int(x) for x in shape.split("x"))
    cfg = RenderConfig(**dict(CFG, pool_pixel_major=True))
    meshes, camera = cornell_box()
    camera.aspect_ratio = 1.0
    scene, fac = prepare_tracer_factory(build_scene(meshes), cfg, "auto",
                                        device="cpu")
    tracer = fac(scene, None, dataclasses.replace(
        cfg, samples_per_launch=cfg.samples_per_launch // n_spp))
    film = film_create(cfg.height, cfg.width, device="cpu")
    rays = [0, 0]
    for k in range(2):
        rgb, _, rad, shad, _ = render_mesh_in_process(
            scene, cfg, n_tile, n_spp, tracer, camera.params(), k, "cpu")
        film = film_accumulate(film, rgb)
        rays = [rays[0] + rad, rays[1] + shad]
    img = np.load(tmp_path / "img.npy")
    np.testing.assert_array_equal(img.view(np.int32),
                                  film.accum.numpy().view(np.int32))
    assert result["rays"] == rays
