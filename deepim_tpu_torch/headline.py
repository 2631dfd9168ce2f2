"""The headline refine protocol, set up for the port.

Mirrors the default protocol of the reference's ``bench.py §main``: four
procedural classes (box, 1,280-face icosphere, cylinder, torus) with the
bench's symmetries, B=128 hypotheses sampled in the LINEMOD camera's
frustum and perturbed, a random observed image, K=4 iterations of which
the first 2 run at 240x320 and the last 2 at 480x640, back-face culling
on.  The weights are random, drawn from a seed; the pose heads get a
little noise so the poses move.  ``chip_smoke.py`` and
:mod:`deepim_tpu_torch.profile_headline` drive the port through it.
"""

from __future__ import annotations

import subprocess

import torch

from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
from deepim_tpu_torch.geometry.symmetry import rot_z_syms
from deepim_tpu_torch.models.flownet import DeepIMFlowNet, bottleneck_grid
from deepim_tpu_torch.raster.camera import make_intrinsics
from deepim_tpu_torch.raster.mesh import (
    box_mesh, cylinder_mesh, decimate_mesh, icosphere_mesh, torus_mesh)
from deepim_tpu_torch.refine import RenderAssets, build_assets, refine_poses

B = 128
SIZE, COARSE = (480, 640), (240, 320)
K_ITERS, COARSE_ITERS = 4, 2
LOD_FACES = 1024
SEED = 7
HEAD_SCALE = 0.02  # noise on the zero pose heads: poses move a little per step


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]


def headline_meshes(dense_sphere: bool = True):
    """The bench's four meshes and symmetries.  ``dense_sphere=False``
    decimates the sphere under 1,024 faces, so every crop takes the sorted
    kernel's route instead of the cols kernel's."""
    sphere = icosphere_mesh(0.05, subdivisions=3)
    if not dense_sphere:
        sphere = decimate_mesh(sphere, 1020)
    return ([box_mesh((0.08, 0.1, 0.06)), sphere, cylinder_mesh(), torus_mesh()],
            [rot_z_syms(2), None, None, rot_z_syms(8)])


def headline_assets(device, dense_sphere: bool = True) -> RenderAssets:
    meshes, syms = headline_meshes(dense_sphere)
    return build_assets(meshes, sym_transforms=syms, num_points=3000,
                        lod_faces=LOD_FACES, device=device)


def headline_inputs(device, num_classes: int, batch: int = B):
    """(obs (B, H, W, 3), init (B, 3, 4), ks (B, 3, 3), cls (B,)), drawn
    from one generator seeded ``SEED`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(SEED)
    k_cam = make_intrinsics(572.4114, 573.5704, 325.2611, 242.049, device=device)
    gt = sample_poses_in_frustum(g, batch, k_cam, SIZE)
    init = perturb_poses(g, gt)
    cls = torch.randint(0, num_classes, (batch,), generator=g, device=device)
    obs = torch.rand((batch, *SIZE, 3), generator=g, device=device)
    return obs, init, k_cam.expand(batch, 3, 3).contiguous(), cls


def random_model(num_classes: int = 4, dtype: torch.dtype = torch.bfloat16,
                 seed: int = SEED, head_scale: float = HEAD_SCALE) -> DeepIMFlowNet:
    """The headline network on the CPU, weights drawn from ``seed``, pose
    heads given ``head_scale`` noise."""
    g = torch.Generator().manual_seed(seed)
    model = DeepIMFlowNet(num_classes=num_classes, head_grid=bottleneck_grid(*SIZE),
                          dtype=dtype, generator=g)
    with torch.no_grad():
        for head in (model.fc_rot, model.fc_trans):
            for p in head.parameters():
                p.add_(torch.randn(p.shape, generator=g) * head_scale)
    return model


def run_headline(model, assets, obs, init, ks, cls, return_all: bool = False):
    """One ``refine_poses`` call at the headline protocol."""
    return refine_poses(model, assets, obs, init, ks, cls, num_iters=K_ITERS,
                        out_size=SIZE, coarse_iters=COARSE_ITERS,
                        return_all=return_all)
