"""The headline refine protocol, set up for the port.

Mirrors the default protocol of the reference's ``bench.py §main``: four
procedural classes (box, 1,280-face icosphere, cylinder, torus) with the
bench's symmetries, B=128 hypotheses sampled in the LINEMOD camera's
frustum and perturbed, a random observed image, K=4 iterations of which
the first 2 run at 240x320 and the last 2 at 480x640, back-face culling
on.  The weights are random, drawn from a seed; the pose heads get a
little noise so the poses move.  The textured variant gives each of the
four meshes a 64x64 procedural texture (``texturize(mesh, seed=i)``), a
protocol of the port only.  ``chip_smoke.py`` and
:mod:`deepim_tpu_torch.profile_headline` drive the port through it.

``quant`` (the reference's ``BENCH_QUANT``/``BENCH_QUANT_CALIB``,
``bench.py:39-51, :271-304``) picks the network: ``none`` (bf16), ``int8``
(dynamic scales) or ``int8_static`` (scales calibrated on the headline
batch itself over the K iterations, estimator ``max`` by default);
anything else raises before any work.  :func:`headline_fields` carries
``quant`` into the headline's line.

``SERVE_CONFIG`` is the serving protocol: the flagship experiment
``experiments/cfgs/synthetic_all_c2f.yaml`` as a dict, its device batch
raised to the bench's B.  ``TRAIN_CONFIG`` is the training protocol: the
flagship training experiment ``experiments/cfgs/synthetic_all.yaml`` as a
dict (B=32, 480x640, ``train_iter`` 2, flow and mask heads, bf16, Adam).
Both are held to their YAMLs by ``tests/test_torch_headline.py``.
"""

from __future__ import annotations

import subprocess

import torch

from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
from deepim_tpu_torch.geometry.symmetry import rot_z_syms
from deepim_tpu_torch.models.flownet import DeepIMFlowNet, bottleneck_grid
from deepim_tpu_torch.models.quant import CALIB_MODES, calibrate_model
from deepim_tpu_torch.raster.camera import make_intrinsics
from deepim_tpu_torch.raster.mesh import (
    box_mesh, cylinder_mesh, decimate_mesh, icosphere_mesh, texturize, torus_mesh)
from deepim_tpu_torch.refine import RenderAssets, build_assets, refine_poses

B = 128
SIZE, COARSE = (480, 640), (240, 320)
K_ITERS, COARSE_ITERS = 4, 2
LOD_FACES = 1024
SEED = 7
LINEMOD_K = (572.4114, 573.5704, 325.2611, 242.049)  # fx, fy, cx, cy
TEXTURE_SIZE = (64, 64)
HEAD_SCALE = 0.02  # noise on the zero pose heads: poses move a little per step
QUANT_MODES = ("none", "int8", "int8_static")
QUANT_CALIB = "max"  # bench.py's BENCH_QUANT_CALIB default

# experiments/cfgs/synthetic_all_c2f.yaml with test.batch_size = B.
SERVE_CONFIG = {
    "experiment": "synthetic_all_c2f",
    "dataset": {"name": "synthetic", "objects": ["box", "icosphere", "cylinder", "torus"]},
    "train": {"batch_size": 32, "num_steps": 34000, "optimizer": "adam", "lr": 5.0e-5,
              "weight_decay": 0.0, "warmup_steps": 0, "lr_decay_steps": [33000],
              "train_iter": 2, "w_flow": 0.05, "w_mask": 0.05, "coarse_fraction": 0.5,
              "sym_aware_pm": False, "log_every": 100, "checkpoint_every": 2000},
    "test": {"test_iter": 4, "coarse_iters": 2, "batch_size": B},
}


# experiments/cfgs/synthetic_all.yaml.
TRAIN_CONFIG = {
    "experiment": "synthetic_all",
    "dataset": {"name": "synthetic", "objects": ["box", "icosphere", "cylinder", "torus"]},
    "train": {"batch_size": 32, "num_steps": 30000, "optimizer": "adam", "lr": 3.0e-4,
              "weight_decay": 0.0, "warmup_steps": 200, "lr_decay_steps": [22000, 27000],
              "train_iter": 2, "w_flow": 0.05, "w_mask": 0.05, "log_every": 100,
              "checkpoint_every": 5000},
    "test": {"test_iter": 4, "batch_size": 32},
}


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]


def headline_meshes(dense_sphere: bool = True, textured: bool = False):
    """The bench's four meshes and symmetries.  ``dense_sphere=False``
    decimates the sphere under 1,024 faces, so every crop takes the sorted
    kernel's route instead of the cols kernel's; ``textured`` gives mesh i
    the procedural texture of seed i."""
    sphere = icosphere_mesh(0.05, subdivisions=3)
    if not dense_sphere:
        sphere = decimate_mesh(sphere, 1020)
    meshes = [box_mesh((0.08, 0.1, 0.06)), sphere, cylinder_mesh(), torus_mesh()]
    if textured:
        meshes = [texturize(m, seed=i, size=TEXTURE_SIZE) for i, m in enumerate(meshes)]
    return meshes, [rot_z_syms(2), None, None, rot_z_syms(8)]


def headline_assets(device, dense_sphere: bool = True,
                    textured: bool = False) -> RenderAssets:
    meshes, syms = headline_meshes(dense_sphere, textured)
    return build_assets(meshes, sym_transforms=syms, num_points=3000,
                        lod_faces=LOD_FACES, device=device)


def headline_inputs(device, num_classes: int, batch: int = B):
    """(obs (B, H, W, 3), init (B, 3, 4), ks (B, 3, 3), cls (B,)), drawn
    from one generator seeded ``SEED`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(SEED)
    k_cam = make_intrinsics(*LINEMOD_K, device=device)
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


def check_quant(quant: str, calib_mode: str = QUANT_CALIB) -> None:
    """Fail fast on a mode the headline does not know: a typo must not
    record a "quantized" run that measured the plain path."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r} is not one of {QUANT_MODES}")
    if calib_mode not in CALIB_MODES:
        raise ValueError(f"calib_mode={calib_mode!r} is not one of {CALIB_MODES}")


def headline_model(model: DeepIMFlowNet, quant: str, assets, obs, init, ks, cls,
                   calib_mode: str = QUANT_CALIB) -> DeepIMFlowNet:
    """``model`` at ``quant``: itself for ``none``, its dynamic int8 twin,
    or the int8 twin calibrated on this batch (``init`` walked through the
    K iterations at full size, as ``bench.py`` does).  Parameters are
    shared."""
    check_quant(quant, calib_mode)
    if quant == "none":
        return model
    dynamic = model.with_act_scales(())
    if quant == "int8":
        return dynamic
    batch = {"obs_rgb": obs, "pose_src": init, "class_idx": cls}
    return calibrate_model(dynamic, assets, [batch], ks[0], SIZE, num_iters=K_ITERS,
                           mode=calib_mode)


def headline_fields(quant: str, calib_mode: str = QUANT_CALIB) -> dict:
    """The protocol's fields of a headline line, ``quant`` among them."""
    check_quant(quant, calib_mode)
    return {"batch": B, "iters": K_ITERS, "coarse_iters": COARSE_ITERS, "quant": quant,
            "quant_calib": calib_mode if quant == "int8_static" else None}


def run_headline(model, assets, obs, init, ks, cls, return_all: bool = False):
    """One ``refine_poses`` call at the headline protocol."""
    return refine_poses(model, assets, obs, init, ks, cls, num_iters=K_ITERS,
                        out_size=SIZE, coarse_iters=COARSE_ITERS,
                        return_all=return_all)
