"""deepim_tpu_torch.cli.test and cli.train_test (CPU).

- The port's eval loop (``refine_batches``) against the reference's
  ``refine_poses`` and ``evaluate_poses`` on the same batch and bridged
  weights: the port draws a batch, the reference refines that batch's
  numpy arrays with its Pallas kernels in interpret mode, and the
  trajectories agree to the 1e-3 of tests/test_torch_refine.py; fed the
  same trajectory, the two evaluators' tables agree (as in
  tests/test_torch_eval.py).
- ``cli.test.main`` on a tiny config, as tests/test_eval_data.py
  §test_cli_train_and_test: ``eval_results.json``, ``refined_poses.npz``
  of shape (K+1, n, 3, 4), a BOP CSV that both packages read back within
  1e-6 of the last iterate, ``vis/sample000.png``; the ``--no-refine``
  INIT row equals the refined run's; ``--hypotheses 2`` and the occlusion
  set run; ``--results-out`` records the revision.
- What raises before any batch is drawn: an on-disk set without its
  models (``lm6d``) or without its keyframe list (``ycb_video``),
  ``--quant int8_static`` with an unknown ``--quant-calib``,
  ``--init-poses`` and ``--posecnn-mat`` on generated data, ``cuda:0``
  with no card; and an experiment with only orbax steps.
- ``--quant int8`` and ``--quant int8_static`` on the CPU: the int8 eval
  runs; int8_static calibrates on two batches and still scores every
  sample, and its trajectories equal the eval loop of the model that
  ``calibrate_model`` gives on those two batches.
  (tests/test_torch_disk_cli.py runs the on-disk sets.)
- ``cli.train_test`` on a tiny config; ``--n-devices 2`` on one visible card
  raises (the data-parallel runs are tests/test_torch_parallel.py's).
"""

import functools
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepim_tpu.eval import bop_results as bop_j
from deepim_tpu.eval import evaluator as ev_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.cli import test as cli_test
from deepim_tpu_torch.cli import train_test as cli_train_test
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import synthetic as syn_t
from deepim_tpu_torch.eval import bop_results as bop_t
from deepim_tpu_torch.eval import evaluator as ev_t
from deepim_tpu_torch.refine import refiner as ref_t
from deepim_tpu_torch.train import checkpoint as ckpt_t
from deepim_tpu_torch.train import train as train_t
from test_torch_eval import _allowed, _assert_tables_equal
from test_torch_refine import OUT, K, _meshes, _weights

H, W = 32, 64  # the network's crops; the frames are 48x96


def _spec(tmp_path, experiment="toy", **dataset):
    return {
        "experiment": experiment,
        "output_dir": str(tmp_path / "out") if tmp_path else "output",
        "network": {"input_height": H, "input_width": W, "dtype": "float32", "fc_dim": 32,
                    "with_flow": False, "with_mask": False},
        "dataset": {"name": "synthetic", "objects": ["box", "icosphere"], "image_height": 48,
                    "image_width": 96, "fx": 90.0, "fy": 90.0, "cx": 48.0, "cy": 24.0,
                    "num_points": 64, **dataset},
        "train": {"batch_size": 4, "num_steps": 2, "optimizer": "adam", "lr": 1e-4,
                  "log_every": 1, "checkpoint_every": 2, "warmup_steps": 0, "w_flow": 0.0,
                  "w_mask": 0.0},
        "test": {"test_iter": 2, "batch_size": 4},
    }


@functools.cache
def _weights_of(h, w):
    """A training model's weights at crop size (h, w), pose heads randomised
    (built once: the network's initialisation is most of a CPU test's time)."""
    cfg = config_from_dict(_spec(None) | {"network": {**_spec(None)["network"],
                                                      "input_height": h, "input_width": w}})
    model = train_t.make_model(cfg, 2, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for head in (model.fc_rot, model.fc_trans):
            for p in head.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    return model.state_dict()


def _write(tmp_path, spec, checkpoint=True):
    """The config as a YAML, and a port checkpoint of random pose heads."""
    path = tmp_path / f"{spec['experiment']}.yaml"
    path.write_text(yaml.safe_dump(spec))
    if checkpoint:
        n = spec["network"]
        ckpt_t.save_checkpoint(ckpt_t.checkpoint_dir(config_from_dict(spec)), 3,
                               _weights_of(n["input_height"], n["input_width"]))
    return str(path)


def _lines(text, tag):
    return [ln for ln in text.splitlines() if ln.startswith(tag)]


def test_eval_loop_matches_reference_refine_and_evaluate():
    meshes = _meshes(False)  # 320 faces: the sorted kernel's route
    at = ref_t.build_assets(meshes, num_points=64, device="cpu")
    aj = ref_j.build_assets(meshes, num_points=64)
    mj, var, mt = _weights()
    k = torch.from_numpy(K)
    batch = syn_t.synthetic_batch(torch.Generator().manual_seed(9000), at, 3, k, (120, 160),
                                  z_range=(0.6, 0.9))
    out = cli_test.refine_batches(mt, at, [batch], k, num_iters=2, out_size=OUT)
    traj_t = out["traj"].numpy()
    np.testing.assert_array_equal(out["pose_gt"], batch["pose_tgt"].numpy())
    traj_j = np.asarray(ref_j.refine_poses(
        var, mj, aj, jnp.asarray(batch["obs_rgb"].numpy()), jnp.asarray(batch["pose_src"].numpy()),
        jnp.asarray(batch["k"].numpy()), jnp.asarray(batch["class_idx"].numpy()), num_iters=2,
        out_size=OUT, renderer="pallas_interpret", return_all=True))
    assert traj_t.shape == traj_j.shape == (3, 3, 3, 4)
    assert np.abs(traj_j[-1] - traj_j[0]).max() > 1e-2  # the poses moved
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=1e-3)

    names, sym = ["box", "icosphere", "torus"], [False, False, True]
    cls, gt = out["class_idx"], out["pose_gt"]
    ks = np.broadcast_to(K, (3, 3, 3)).copy()
    for it in range(3):  # the same trajectory through both evaluators
        got = ev_t.evaluate_poses(at, names, sym, traj_t[it], gt, cls, ks)
        want = ev_j.evaluate_poses(aj, names, sym, traj_t[it], gt, cls, ks)
        errs = {kk: v.numpy() for kk, v in ev_t.compute_pose_errors(
            at.points[torch.from_numpy(cls).long()], at.sym_poses[torch.from_numpy(cls).long()],
            torch.from_numpy(traj_t[it]), torch.from_numpy(gt), torch.from_numpy(ks)).items()}
        allowed = {names[c]: _allowed(errs, at.diameters.numpy(), cls, c, sym)
                   for c in set(cls)}
        _assert_tables_equal(got, want, allowed)


def test_cli_test_end_to_end(tmp_path, capsys):
    spec = _spec(tmp_path)
    path = _write(tmp_path, spec)
    out_dir = tmp_path / "out" / "toy"
    record = tmp_path / "results" / "toy.json"
    assert cli_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "8", "--vis", "2",
                          "--save-poses", "--results-out", str(record)]) == 0
    text = capsys.readouterr().out
    assert "loaded checkpoint step 3" in text and "poses/s on cpu" in text
    assert len(_lines(text, "[INIT]")) == 1 and len(_lines(text, "[iter 2]")) == 1
    assert re.search(r"^MEAN .* 8$", text, re.M)
    poses = np.load(out_dir / "refined_poses.npz")
    assert poses["traj"].shape == (3, 8, 3, 4)  # K=2: init + 2 iterations
    assert poses["pose_gt"].shape == (8, 3, 4) and poses["k"].shape == (8, 3, 3)
    assert np.abs(poses["traj"][-1] - poses["traj"][0]).max() > 1e-3
    for read in (bop_t.read_bop_csv, bop_j.read_bop_csv):
        bop = read(str(out_dir / "bop_results.csv"))
        np.testing.assert_allclose(bop["poses"], poses["traj"][-1], atol=1e-6)
        np.testing.assert_array_equal(bop["obj_ids"], poses["class_idx"] + 1)
    results = json.loads((out_dir / "eval_results.json").read_text())
    assert results["num_samples"] == 8 and "ci95" in results["mean"]
    assert sorted(os.listdir(out_dir / "vis")) == ["sample000.png", "sample001.png"]
    wrapped = json.loads(record.read_text())
    assert wrapped["results"] == results and wrapped["experiment"] == "toy"
    assert "git" in wrapped

    # --no-refine prints the same INIT row: the eval set is a fixed draw
    assert cli_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "8",
                          "--no-refine"]) == 0
    text_init = capsys.readouterr().out
    assert _lines(text_init, "[INIT]") == _lines(text, "[INIT]")
    assert "INIT (unrefined)" in text_init


@pytest.mark.parametrize("variant", ["hypotheses", "occlusion"])
def test_cli_test_variants_run(tmp_path, capsys, variant):
    if variant == "occlusion":
        spec = _spec(tmp_path, "occ", name="synthetic_occlusion")
        argv = []
    else:
        spec = _spec(tmp_path, "hyp")
        argv = ["--hypotheses", "2", "--init-rot-noise", "30", "--init-trans-noise", "0.02"]
    path = _write(tmp_path, spec)
    assert cli_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "4",
                          "--save-poses", *argv]) == 0
    text = capsys.readouterr().out
    traj = np.load(tmp_path / "out" / spec["experiment"] / "refined_poses.npz")["traj"]
    # multi-hypothesis keeps (init, best); the occlusion set the whole trajectory
    assert traj.shape == ((2, 4, 3, 4) if variant == "hypotheses" else (3, 4, 3, 4))
    assert np.isfinite(traj).all() and _lines(text, "[INIT]")


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_cli_test_int8_modes(tmp_path, capsys, quant):
    from deepim_tpu_torch.models.quant import calibrate_model
    from deepim_tpu_torch.raster.camera import make_intrinsics

    spec = _spec(tmp_path, f"q_{quant}")
    path = _write(tmp_path, spec)
    assert cli_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "8",
                          "--save-poses", "--quant", quant]) == 0
    text = capsys.readouterr().out
    traj = np.load(tmp_path / "out" / spec["experiment"] / "refined_poses.npz")["traj"]
    assert traj.shape == (3, 8, 3, 4) and np.isfinite(traj).all()
    assert bool(_lines(text, "int8_static: calibrated activation scales on 2 batches "
                             "(mode=max_c)")) == (quant == "int8_static")
    # the same eval by hand: the int8 model, calibrated on the first two
    # batches for int8_static, over the whole stream
    cfg = config_from_dict(spec)
    assets, _, _ = _assets(cfg)
    model = train_t.make_model(config_from_dict({**spec, "network": {**spec["network"],
                                                                       "quant": quant}}),
                               2, inference=True)
    model.load_state_dict(_pose_only(_weights_of(H, W)))
    d = cfg.dataset
    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device="cpu")
    stream = list(cli_test.eval_stream(cfg, assets, k_cam, 2, 4))
    if quant == "int8_static":
        model = calibrate_model(model, assets, stream, k_cam, (H, W), num_iters=2)
    want = cli_test.refine_batches(model, assets, stream, k_cam, 2, (H, W))["traj"].numpy()
    np.testing.assert_array_equal(traj, want)


def _assets(cfg):
    from deepim_tpu_torch.cli.train import load_assets_and_names

    return load_assets_and_names(cfg, eval_set=True, device="cpu")


def _pose_only(sd):
    from deepim_tpu_torch.models.bridge import DECODER_LAYERS

    return {k: v for k, v in sd.items() if k.split(".")[0] not in DECODER_LAYERS}


@pytest.mark.parametrize("case", ["lm6d", "ycb_video", "quant", "init_poses", "posecnn_mat",
                                  "no_card"])
def test_cli_test_refuses_before_any_batch(tmp_path, monkeypatch, case):
    spec = _spec(tmp_path, name={"lm6d": "lm6d", "ycb_video": "ycb_video"}.get(case, "synthetic"),
                 root=str(tmp_path / "root"))
    path = _write(tmp_path, spec, checkpoint=False)
    if case == "ycb_video":  # the models, but no keyframe list
        from deepim_tpu_torch.data.lm6d import LM6DDataset
        from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES

        ds = LM6DDataset(str(tmp_path / "root"), ["box", "icosphere"])
        for obj in ds.objects:
            ds.write_model(obj, PROCEDURAL_MESHES[obj]())

    def no_batch(*a, **kw):
        raise AssertionError("a batch was drawn")

    monkeypatch.setattr(cli_test, "eval_stream", no_batch)
    argv = ["--cfg", path, "--device", "cuda:0" if case == "no_card" else "cpu"]
    argv += {"quant": ["--quant", "int8_static", "--quant-calib", "max_x"],
             "init_poses": ["--init-poses", "x.csv"],
             "posecnn_mat": ["--posecnn-mat", "mats"]}.get(case, [])
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    error, match = {"lm6d": (FileNotFoundError, "textured.ply"),
                    "ycb_video": (SystemExit, "keyframe.txt"),
                    "quant": (SystemExit, "quant-calib"), "no_card": (RuntimeError, "no CUDA"),
                    }.get(case, (SystemExit, "on-disk"))
    with pytest.raises(error, match=match):
        cli_test.main(argv)


def test_cli_test_refuses_orbax_only_and_warns_without_checkpoint(tmp_path, capsys):
    spec = _spec(tmp_path, "plain")
    path = _write(tmp_path, spec, checkpoint=False)
    assert cli_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "4",
                          "--no-refine"]) == 0
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    (tmp_path / "out" / "plain" / "checkpoints" / "500").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="import_flax_params"):
        cli_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "4"])


def test_cli_train_test(tmp_path, capsys, monkeypatch):
    spec = _spec(tmp_path, "tt")
    path = _write(tmp_path, spec, checkpoint=False)
    with monkeypatch.context() as m:  # more ranks than visible cards raises on CUDA
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="exceeds the 1 visible"):
            cli_train_test.main(["--cfg", path, "--device", "cuda:0", "--n-devices", "2"])
    assert cli_train_test.main(["--cfg", path, "--device", "cpu", "--num-samples", "4",
                                "--vis", "1"]) == 0
    text = capsys.readouterr().out
    assert "loaded checkpoint step 2" in text and _lines(text, "[iter 2]")
    assert (tmp_path / "out" / "tt" / "eval_results.json").exists()
    assert os.listdir(tmp_path / "out" / "tt" / "vis") == ["sample000.png"]


def test_record_result_marks_a_dirty_tree(tmp_path, monkeypatch):
    """The port's revision stamp says when the tree had uncommitted changes
    (the reference's does not), and is empty outside a checkout of its own."""
    import subprocess

    from deepim_tpu_torch.utils import results

    repo = tmp_path / "repo"
    repo.mkdir()
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-C", str(repo)]
    subprocess.run(git + ["init", "-q"], check=True)
    (repo / "a.txt").write_text("a\n")
    subprocess.run(git + ["add", "a.txt"], check=True)
    subprocess.run(git + ["commit", "-q", "-m", "a"], check=True)
    head = subprocess.run(git + ["rev-parse", "--short", "HEAD"], capture_output=True,
                          text=True, check=True).stdout.strip()
    monkeypatch.setattr(results, "_ROOT", str(repo))
    assert results._git_rev() == head
    (repo / "a.txt").write_text("b\n")
    assert results._git_rev() == head + "-dirty"
    results.record_result(str(tmp_path / "r" / "x.json"), {"v": 1}, experiment="e", argv=["--x"])
    rec = json.loads((tmp_path / "r" / "x.json").read_text())
    assert rec["git"] == head + "-dirty" and rec["argv"] == ["--x"] and rec["results"] == {"v": 1}
    monkeypatch.setattr(results, "_ROOT", str(repo / "sub"))  # inside, but not its top level
    (repo / "sub").mkdir()
    assert results._git_rev() == ""
    monkeypatch.setattr(results, "_ROOT", str(tmp_path / "nowhere"))
    assert results._git_rev() == ""
