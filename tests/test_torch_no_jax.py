"""deepim_tpu_torch runs without jax or the reference package.

The machine with the card has no jax, so the port must import and refine
with both blocked, and no source file of the port may import them.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deepim_tpu_torch"

_PROBE = r"""
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "deepim_tpu"):
        del sys.modules[name]
for name in ("jax", "jaxlib", "flax", "deepim_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
sys.path.insert(0, sys.argv[1])

import importlib, pkgutil
import torch
import deepim_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(deepim_tpu_torch.__path__, "deepim_tpu_torch.")]
for m in mods:
    importlib.import_module(m)

from deepim_tpu_torch.models.flownet import DeepIMFlowNet, bottleneck_grid
from deepim_tpu_torch.raster.camera import make_intrinsics
from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
from deepim_tpu_torch.refine import build_assets, refine_poses

g = torch.Generator().manual_seed(0)
assets = build_assets([box_mesh(), icosphere_mesh(0.05)], num_points=16)
model = DeepIMFlowNet(num_classes=2, head_grid=bottleneck_grid(32, 64))
k = make_intrinsics(150.0, 150.0, 80.0, 60.0)
gt = sample_poses_in_frustum(g, 2, k, (120, 160))
init = perturb_poses(g, gt)
out = refine_poses(model, assets, torch.rand(2, 120, 160, 3, generator=g), init,
                   k.expand(2, 3, 3), torch.tensor([0, 1]), num_iters=2,
                   out_size=(32, 64), coarse_iters=1)
assert out.shape == (2, 3, 4) and torch.isfinite(out).all()
leaked = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "deepim_tpu")]
assert not leaked, leaked
print("OK", len(mods))
"""


def test_imports_and_refines_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-2] == "OK" and int(proc.stdout.split()[-1]) >= 15


def test_no_source_imports_jax_or_the_reference():
    bad = re.compile(r"^\s*(import\s+(jax|flax|deepim_tpu)\b(?!_torch)"
                     r"|from\s+(jax|flax|deepim_tpu)(\.|\s)(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    offenders = [str(p.relative_to(ROOT)) for p in files if bad.search(p.read_text())]
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|deepim_tpu)\b(?!_torch)",
                         src, re.M)
