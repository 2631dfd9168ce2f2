"""deepim_tpu_torch runs without jax, orbax, PyYAML, PIL or the reference package.

The machine with the card has no jax and no PIL, so the port must import,
refine, serve, train (the losses, the flow GT, the optimizer, one fused
synthetic step, a checkpoint round trip), calibrate an int8_static
model and refine with it, evaluate (the evaluator, PNG and BOP files, the
eval loop), generate and read video sequences, and generate and read an
on-disk LM6d root (the toolkit, the C++ PNG unfilter,
the streamed batches, ``TrainBatcher``, an OBJ model), and convert public
releases (a BOP JSON release, an original LINEMOD one with JPEG frames,
``cli.runbook --dry-run``: detect, convert, validate, write the eval
config), and run the C++ host runtime (a 20,480-face PLY loaded and
decimated, ``decode_png``, ``PrefetchReader``) and ``tools.seed_variance``,
and use the trivial rank mesh and ``tools.plot_train`` (the new
``parallel`` modules, ``dryrun_multichip`` and the four last tools import)
with jax, optax,
orbax, PyYAML, PIL and matplotlib blocked; no source file of the port may import jax,
flax, orbax, PIL or the reference, none may import yaml when it is
imported, and none names the reference's native library.
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
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "matplotlib", "deepim_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
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
assets = build_assets([box_mesh(), icosphere_mesh(0.05)], num_points=16, device="cpu")
model = DeepIMFlowNet(num_classes=2, head_grid=bottleneck_grid(32, 64))
k = make_intrinsics(150.0, 150.0, 80.0, 60.0, device="cpu")
gt = sample_poses_in_frustum(g, 2, k, (120, 160))
init = perturb_poses(g, gt)
out = refine_poses(model, assets, torch.rand(2, 120, 160, 3, generator=g), init,
                   k.expand(2, 3, 3), torch.tensor([0, 1]), num_iters=2,
                   out_size=(32, 64), coarse_iters=1)
assert out.shape == (2, 3, 4) and torch.isfinite(out).all()
from deepim_tpu_torch.models.quant import calibrate_model
static = calibrate_model(model, assets, [{"obs_rgb": torch.rand(2, 120, 160, 3, generator=g),
                                          "pose_src": init, "class_idx": torch.tensor([0, 1])}],
                         k, (32, 64), num_iters=2)
assert static.quant == "int8" and len(static.act_scales) == 12
out = refine_poses(static, assets, torch.rand(2, 120, 160, 3, generator=g), init,
                   k.expand(2, 3, 3), torch.tensor([0, 1]), num_iters=1, out_size=(32, 64))
assert torch.isfinite(out).all()

from deepim_tpu_torch.data import synthetic_occlusion_batch
from deepim_tpu_torch.raster.mesh import texturize
textured = build_assets([texturize(box_mesh(), seed=0), icosphere_mesh(0.05)], num_points=16,
                        device="cpu")
batch = synthetic_occlusion_batch(g, textured, 2, k, (32, 64))
assert batch["obs_rgb"].shape == (2, 32, 64, 3) and torch.isfinite(batch["obs_rgb"]).all()
import numpy as np
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.serve import PoseRefinerService
svc = PoseRefinerService(config_from_dict({
    "network": {"input_height": 32, "input_width": 64, "dtype": "float32", "fc_dim": 16},
    "dataset": {"objects": ["box", "torus"], "image_height": 120, "image_width": 160,
                "num_points": 16},
    "test": {"test_iter": 1, "batch_size": 2}}), device="cpu", load_checkpoint=False)
try:
    served = svc.refine(np.random.rand(1, 120, 160, 3), init[:1].numpy(),
                        k[None].numpy(), np.array([1]))
finally:
    svc.close()
assert served.shape == (1, 3, 4) and np.isfinite(served).all()
assert {"config", "cli", "train", "serve", "losses", "eval", "utils"} <= {m.split(".")[1] for m in mods}
assert "deepim_tpu_torch.ops.flow_gt" in mods
import tempfile
from deepim_tpu_torch.train import (checkpoint as ckpt, init_state, make_model,
                                    make_synthetic_train_step)
cfg = config_from_dict({
    "network": {"input_height": 32, "input_width": 64, "dtype": "float32", "fc_dim": 16},
    "dataset": {"objects": ["box", "torus"], "image_height": 120, "image_width": 160,
                "num_points": 16},
    "train": {"batch_size": 2, "train_iter": 2, "optimizer": "adam", "warmup_steps": 1}})
model = make_model(cfg, 2)
state = init_state(cfg, model)
step = make_synthetic_train_step(model, build_assets([box_mesh(), icosphere_mesh(0.05)],
                                                     num_points=16, device="cpu"), cfg, k)
state, metrics = step(state, g)
assert state.step == 1 and {"flow_loss_1", "mask_loss_1", "grad_norm"} <= set(metrics)
with tempfile.TemporaryDirectory() as d:
    ckpt.save_train_state(d, state)
    assert ckpt.restore_train_state(d, init_state(cfg, make_model(cfg, 2))).step == 1
from deepim_tpu_torch.cli.test import refine_batches
from deepim_tpu_torch.data import gen_video, read_png, write_png
from deepim_tpu_torch.eval import evaluate_poses, format_table, read_bop_csv, write_bop_csv
from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
with tempfile.TemporaryDirectory() as d:
    ev_assets = build_assets([box_mesh(), icosphere_mesh(0.05)], num_points=16, device="cpu")
    out = refine_batches(model, ev_assets, [batch], k, num_iters=1, out_size=(32, 64))
    traj = out["traj"].numpy()
    ks_np = np.broadcast_to(k.numpy(), (2, 3, 3)).copy()
    res = evaluate_poses(ev_assets, ["box", "icosphere"], [False, False], traj[-1],
                         out["pose_gt"], out["class_idx"], ks_np)
    assert "MEAN" in format_table(res) and res["num_samples"] == 2
    write_bop_csv(d + "/b.csv", traj[-1], out["class_idx"] + 1)
    assert np.allclose(read_bop_csv(d + "/b.csv")["poses"], traj[-1], atol=1e-6)
    img = (np.random.rand(5, 7, 3) * 255).astype(np.uint8)
    write_png(d + "/a.png", img)
    assert (read_png(d + "/a.png") == img).all()
    ds = gen_video(d + "/v", {"box": PROCEDURAL_MESHES["box"]()}, k.numpy(), (32, 48),
                   num_frames=2, device="cpu")
    assert ds.load_sequence("0000")["frames"].shape == (2, 32, 48, 3)
from deepim_tpu_torch.data import lm6d, toolkit
from deepim_tpu_torch.raster.mesh import load_mesh
with tempfile.TemporaryDirectory() as d:
    root = toolkit.gen_procedural_dataset(d + "/lm6d", ["box", "icosphere"], k.numpy(), (24, 32),
                                          frames_per_obj=3, device="cpu").root
    ds = lm6d.LM6DDataset(root, ["box", "icosphere"])
    recs = ds.gt_roidb("box", "test") + ds.gt_roidb("icosphere", "test")
    (b,) = [lm6d.to_device(x, "cpu") for x in lm6d.prefetch_iter(
        lm6d.iter_frame_batches(ds, recs, 2, pin_memory=False))]
    assert b["obs_rgb"].dtype == torch.float32 and b["obs_rgb"].shape == (2, 24, 32, 3)
    assert lm6d.TrainBatcher(ds, ["box"], 2, pin_memory=False).next()["obs_mask"].any()
    with open(d + "/m.obj", "w") as f:
        f.write("v 0 0 0\nv 0.1 0 0\nv 0 0.1 0\nf 1 2 3\n")
    assert load_mesh(d + "/m.obj").num_faces == 1
import os
sys.path.insert(0, sys.argv[1] + "/tests")
import test_torch_release_fixtures as fx
from deepim_tpu_torch.cli import runbook
from deepim_tpu_torch.data.bop import convert_bop_split
from deepim_tpu_torch.data.lm_original import convert_lm_original
with tempfile.TemporaryDirectory() as d:
    objs = ["box", "icosphere"]
    root = toolkit.gen_procedural_dataset(d + "/gen", objs, k.numpy(), (24, 32),
                                          frames_per_obj=2, device="cpu").root
    names = fx.write_bop_release(root, objs, d + "/bop", k.numpy())
    convert_bop_split(d + "/bop", "test", d + "/bop_conv", names)
    got = fx.compare_bop(root, d + "/bop_conv", objs)
    assert got["rgb_equal"] and got["labels_equal"] and got["depth_max_mm"] == 0, got
    fx.write_lm_original_release(root, objs, d + "/accv")
    jpg = fx.encode_jpeg(read_png(root + "/data/observed/00/000000-color.png"))
    conv = convert_lm_original(d + "/accv", d + "/accv_conv")
    from deepim_tpu_torch.data.jpeg import decode_jpeg
    assert (conv.load_frame_raw(conv.gt_roidb("box", "test")[0])[0] == decode_jpeg(jpg)).all()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert runbook.main([d + "/accv", "--dry-run", "--device", "cpu",
                             "--out", d + "/accv_rb"]) == 0
    finally:
        os.chdir(cwd)
    assert os.path.exists(d + "/output/real_data_runbook/config.yaml")
for m in ("models.quant", "data.jpeg", "data.bop", "data.lm_original", "data.validate",
          "cli.runbook",
          "cli.convert_dataset", "cli.validate_dataset", "train.convert_mxnet",
          "utils.profiling", "utils.logging"):
    assert "deepim_tpu_torch." + m in mods, m
from deepim_tpu_torch import native
from deepim_tpu_torch.raster.mesh import decimate_mesh, load_ply, save_ply
from deepim_tpu_torch.tools import seed_variance
with tempfile.TemporaryDirectory() as d:
    save_ply(d + "/dense.ply", icosphere_mesh(0.05, subdivisions=5))
    dense = load_ply(d + "/dense.ply")
    assert dense.num_faces == 20480
    assert decimate_mesh(dense, 4096).num_faces <= 4096
    img = (np.random.rand(6, 5, 3) * 255).astype(np.uint8)
    write_png(d + "/p.png", img)
    assert (native.decode_png(open(d + "/p.png", "rb").read()) == img).all()
    got = list(native.PrefetchReader([d + "/p.png", d + "/missing.png"], num_threads=2))
    assert got == [(0, open(d + "/p.png", "rb").read()), (1, None)]
    for i in range(2):
        os.makedirs(f"{d}/run{i}")
        with open(f"{d}/run{i}/eval_results.json", "w") as f:
            f.write('{"mean": {"add(-s)_0.1d": %d, "5deg_5cm": 1, "proj2d_5px": 2, '
                    '"auc_add(-s)": 3}, "num_samples": 8}' % (10 * i))
    assert seed_variance.main([f"{d}/run0", f"{d}/run1"]) == 0
for m in ("native", "tools.seed_variance", "tools.decimation_ab", "tools.robustness_curve",
          "tools.supervise_train"):
    assert "deepim_tpu_torch." + m in mods, m
for m in ("parallel", "parallel.mesh", "parallel.distributed", "dryrun_multichip",
          "tools.demo_render", "tools.plot_train", "tools.gen_lm6d_cfgs",
          "tools.scale_eval_demo"):
    assert "deepim_tpu_torch." + m in mods, m
from deepim_tpu_torch.parallel import make_mesh, shard_batch
assert shard_batch(make_mesh(), {"x": torch.zeros(4)})["x"].shape == (4,)
from deepim_tpu_torch.tools import plot_train
with tempfile.TemporaryDirectory() as d:
    with open(d + "/train_log.jsonl", "w") as f:
        f.write('{"step": 1, "loss": 1.0, "add_0": 0.1}\n{"step": 2, "loss": 0.5, "add_0": 0.05}\n')
    assert plot_train.main([d + "/train_log.jsonl"]) == 0
    assert read_png(d + "/train_curves.png").shape == (825, 1650, 3)
try:
    from deepim_tpu_torch.config import update_config
    update_config("experiments/cfgs/synthetic_all.yaml")
    raise AssertionError("update_config ran without yaml")
except ImportError as e:
    assert "PyYAML" in str(e), e
leaked = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("OK", len(mods))
"""


def test_imports_and_refines_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-2] == "OK" and int(proc.stdout.split()[-1]) >= 30


def test_no_source_imports_jax_or_the_reference():
    bad = re.compile(r"^\s*(import\s+(jax|flax|optax|orbax|PIL|deepim_tpu)\b(?!_torch)"
                     r"|from\s+(jax|flax|optax|orbax|PIL|deepim_tpu)(\.|\s)(?!_torch))", re.M)
    # yaml only inside a function: the card's machine may not have it
    top_level_yaml = re.compile(r"^(import\s+yaml|from\s+yaml\s)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 30
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if bad.search(p.read_text()) or top_level_yaml.search(p.read_text())]
    assert not offenders, offenders


def test_no_source_names_the_reference_native_library():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cpp"))
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if re.search(r"deepim_tpu\.native|native/build|libdeepim_native", p.read_text())]
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax():
    # chip_smoke.py and the card script that imports it
    for name in ("chip_smoke.py", "bench_raster.py"):
        src = (ROOT / name).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|deepim_tpu)\b(?!_torch)",
                             src, re.M), name
