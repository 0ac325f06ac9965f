"""The port never imports jax or the reference package. Checked in a fresh
interpreter: tests/conftest.py has already imported jax in this one."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "rendertoy3c_tpu_torch", "rendertoy3c_tpu_torch.accel",
    "rendertoy3c_tpu_torch.accel.lbvh", "rendertoy3c_tpu_torch.accel.morton",
    "rendertoy3c_tpu_torch.app.cli",
    "rendertoy3c_tpu_torch.film", "rendertoy3c_tpu_torch.film.image",
    "rendertoy3c_tpu_torch.film.film", "rendertoy3c_tpu_torch.film.denoise",
    "rendertoy3c_tpu_torch.integrate",
    "rendertoy3c_tpu_torch.integrate.config",
    "rendertoy3c_tpu_torch.integrate.path",
    "rendertoy3c_tpu_torch.integrate.walkpool",
    "rendertoy3c_tpu_torch.integrate.bsdf",
    "rendertoy3c_tpu_torch.io", "rendertoy3c_tpu_torch.io.genassets",
    "rendertoy3c_tpu_torch.io.obj",
    "rendertoy3c_tpu_torch.kernels.build", "rendertoy3c_tpu_torch.math",
    "rendertoy3c_tpu_torch.math.onb", "rendertoy3c_tpu_torch.math.sampling",
    "rendertoy3c_tpu_torch.math.vec", "rendertoy3c_tpu_torch.math.microfacet",
    "rendertoy3c_tpu_torch.scene",
    "rendertoy3c_tpu_torch.scene.builtin", "rendertoy3c_tpu_torch.scene.town",
    "rendertoy3c_tpu_torch.scene.material", "rendertoy3c_tpu_torch.scene.scene",
    "rendertoy3c_tpu_torch.scene.texture",
    "rendertoy3c_tpu_torch.trace", "rendertoy3c_tpu_torch.trace.auto",
    "rendertoy3c_tpu_torch.trace.bsdf", "rendertoy3c_tpu_torch.scene.light",
    "rendertoy3c_tpu_torch.trace.intersect", "rendertoy3c_tpu_torch.trace.mt",
    "rendertoy3c_tpu_torch.trace.shade", "rendertoy3c_tpu_torch.trace.hierwalk",
    "rendertoy3c_tpu_torch.scene.instanced",
    "rendertoy3c_tpu_torch.trace.instanced",
    "rendertoy3c_tpu_torch.trace.hier_instanced",
    "rendertoy3c_tpu_torch.trace.leafwalk",
    "rendertoy3c_tpu_torch.trace.residentwalk",
    "rendertoy3c_tpu_torch.trace.instanced_mt",
    "rendertoy3c_tpu_torch.parallel", "rendertoy3c_tpu_torch.parallel.dist",
    "rendertoy3c_tpu_torch.parallel.multihost",
    "rendertoy3c_tpu_torch.tools",
    "rendertoy3c_tpu_torch.tools.mesh_check",
    "rendertoy3c_tpu_torch.tools.ab",
]


@pytest.mark.parametrize("script", [
    "import importlib\nfor m in MODULES: importlib.import_module(m)",
    # importing the chip smoke script must not drive anything either
    "import importlib\nimportlib.import_module('chip_smoke')",
])
def test_port_imports_neither_jax_nor_the_reference(script):
    code = (f"import sys\nMODULES = {MODULES!r}\n{script}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'rendertoy3c_tpu' or "
            "m.startswith('rendertoy3c_tpu.'))\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
