"""The on-disk slice as a whole: cli.test and cli.train on disk (CPU).

- ``cli.test`` on a tiny LM6d root the port's toolkit wrote (2 objects, 60x80
  frames, network 48x64, 2 iterations, float32, ``test.init: posecnn``
  from ``init_poses/``, ``dataset.obj_ids`` [8, 11], a padded last batch),
  both packages on shared weights (the reference's flax tree written as a
  port checkpoint by ``import_flax_params``), the reference's Pallas
  kernels in interpret mode: per-iteration trajectories within the 1e-3 of
  tests/test_torch_refine.py; tables equal but for the samples whose two
  errors straddle a threshold (counted, as tests/test_torch_cli_test.py
  counts them); padded rows left out of the tables, the npz and the BOP
  CSV, whose rows carry the records' real scene, image and object ids.
- ``--init-poses`` from a BOP CSV of the roots' init poses matches every
  record and reproduces the ``init_poses/`` run.
- ``dataset.name=ycb_video`` with ``--posecnn-mat`` on keyframes of a
  reference-generated sequence, against the reference as above.
- A ModelNet ``cad_dir`` evaluation set (an .off and an .obj file).
- ``cli.train`` on disk interleaves disk and synthetic steps in the
  reference's ``frac_hit`` order (the reference's steps stubbed: only its
  order is compared), and its disk batches are the reference
  ``TrainBatcher``'s.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepim_tpu.cli import test as cli_test_j
from deepim_tpu.cli import train as cli_train_j
from deepim_tpu.config import config_from_dict as config_j
from deepim_tpu.data import lm6d as lm6d_j
from deepim_tpu.data import video as video_j
from deepim_tpu.eval import read_bop_csv
from deepim_tpu.raster.mesh import box_mesh, icosphere_mesh
from deepim_tpu.train import checkpoint as ckpt_j
from deepim_tpu.train import train as train_j
from deepim_tpu_torch.cli import test as cli_test
from deepim_tpu_torch.cli import train as cli_train
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data.toolkit import gen_procedural_dataset
from deepim_tpu_torch.eval import evaluator as ev_t
from deepim_tpu_torch.eval import write_bop_csv
from deepim_tpu_torch.refine import build_assets
from deepim_tpu_torch.train import checkpoint as ckpt_t
from test_mesh_formats import _obj_text, _off_text
from test_torch_eval import _assert_tables_equal

OBJECTS = ["box", "icosphere"]
K_CAM = np.array([[90.0, 0, 40], [0, 90.0, 30], [0, 0, 1]], np.float32)
TRAJ_ATOL = 1e-3  # tests/test_torch_refine.py's refine_poses tolerance


@pytest.fixture(scope="module")
def lm6d_root(tmp_path_factory):
    return gen_procedural_dataset(str(tmp_path_factory.mktemp("disk")), OBJECTS, K_CAM,
                                  (60, 80), frames_per_obj=6, seed=2, device="cpu").root


def _spec(tmp_path, root, name="lm6d", **test):
    return {
        "experiment": name, "output_dir": str(tmp_path / "out"),
        "network": {"input_height": 48, "input_width": 64, "dtype": "float32", "fc_dim": 32,
                    "with_flow": False, "with_mask": False},
        "dataset": {"name": name, "root": root, "objects": OBJECTS, "obj_ids": [8, 11],
                    "image_height": 60, "image_width": 80, "fx": 90.0, "fy": 90.0, "cx": 40.0,
                    "cy": 30.0, "num_points": 64},
        "train": {"batch_size": 2, "num_steps": 4, "optimizer": "adam", "lr": 1e-4,
                  "log_every": 1, "checkpoint_every": 4, "warmup_steps": 0, "w_flow": 0.0,
                  "w_mask": 0.0, "syn_fraction": 0.5, "renderer": "pallas_interpret"},
        "test": {"test_iter": 2, "batch_size": 3, "renderer": "pallas_interpret",
                 "init": "posecnn", **test},
    }


def _write(tmp_path, spec) -> str:
    """The config as a YAML, and shared random weights: the reference's
    flax tree (pose heads perturbed) as its orbax checkpoint and, through
    ``import_flax_params``, as the port's."""
    path = tmp_path / f"{spec['experiment']}.yaml"
    path.write_text(yaml.safe_dump(spec))
    cfg = config_j(spec)
    state = train_j.init_state(cfg, train_j.make_model(cfg, 2, inference=True),
                               jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params["params"])
    rng = np.random.RandomState(1)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + 0.02 * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    out = os.path.join(spec["output_dir"], spec["experiment"])
    ckpt_j.save_checkpoint(os.path.join(out, "checkpoints"),
                           state._replace(step=jnp.asarray(5), params={"params": params}))
    ckpt_t.import_flax_params(ckpt_t.checkpoint_dir(config_from_dict(spec)), params, 5)
    return str(path)


def _straddling(e_t, e_j, thresholds) -> int:
    """How many thresholds lie between two errors of one sample (a
    comparison that may come out either way)."""
    lo, hi = min(e_t, e_j), max(e_t, e_j)
    t = np.asarray(thresholds, np.float64)
    return int(((t >= lo) & (t <= hi)).sum())


def _allowed_flips(spec, traj_t, traj_j, gt, cls, ks):
    """Per class and table entry: the samples of the last iteration whose
    port and reference errors straddle a threshold."""
    meshes = [box_mesh(), icosphere_mesh()]  # PROCEDURAL_MESHES' defaults
    a = build_assets(meshes, num_points=spec["dataset"]["num_points"], device="cpu")
    errs = []
    for traj in (traj_t, traj_j):
        c = torch.from_numpy(cls).long()
        errs.append({k: v.numpy() for k, v in ev_t.compute_pose_errors(
            a.points[c], a.sym_poses[c], torch.from_numpy(traj[-1]), torch.from_numpy(gt),
            torch.from_numpy(ks)).items()})
    th, diam = ev_t.EvalThresholds(), a.diameters.numpy()
    auc = np.linspace(0.0, th.auc_max_m, 1001)[1:]
    allowed = {}
    for ci, name in enumerate(OBJECTS):
        rows = np.nonzero(cls == ci)[0]
        t_add = th.add_frac * float(diam[ci])

        def count(key, thresholds, rows=rows):
            return sum(_straddling(errs[0][key][i], errs[1][key][i], thresholds) for i in rows)

        allowed[name] = {
            "add(-s)_0.1d": count("add", [t_add]), "add_0.1d": count("add", [t_add]),
            "adds_0.1d": count("adds", [t_add]),
            "5deg_5cm": count("rot_deg", [th.rot_deg]) + count("trans_m", [th.trans_m]),
            "proj2d_5px": count("proj2d_px", [th.proj_px]),
            "auc_add(-s)": count("add", auc) / 1000.0}
    return allowed


def _run_both(tmp_path, spec, argv):
    """cli.test of the port, then of the reference, on one experiment ->
    each one's (npz, eval_results.json, BOP CSV), read before the next
    run overwrites them."""
    path = _write(tmp_path, spec)
    out = tmp_path / "out" / spec["experiment"]

    def outputs():
        return (dict(np.load(out / "refined_poses.npz")),
                json.loads((out / "eval_results.json").read_text()),
                read_bop_csv(str(out / "bop_results.csv")))

    assert cli_test.main(["--cfg", path, "--device", "cpu", "--save-poses", *argv]) == 0
    got = outputs()
    assert cli_test_j.main(["--cfg", path, "--save-poses", *argv]) == 0
    return got, outputs()


def _assert_runs_agree(spec, got, want, n_records):
    (npz_t, table_t, bop_t), (npz_j, table_j, bop_j) = got, want
    traj_t, traj_j = npz_t["traj"], npz_j["traj"]
    assert traj_t.shape == traj_j.shape == (spec["test"]["test_iter"] + 1, n_records, 3, 4)
    np.testing.assert_array_equal(traj_t[0], traj_j[0])  # the same init poses
    assert np.abs(traj_j[-1] - traj_j[0]).max() > 1e-3  # the poses moved
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=TRAJ_ATOL)
    for key in ("pose_gt", "class_idx", "k"):
        np.testing.assert_array_equal(npz_t[key], npz_j[key])
    allowed = _allowed_flips(spec, traj_t, traj_j, npz_t["pose_gt"], npz_t["class_idx"],
                             npz_t["k"])
    _assert_tables_equal(table_t, table_j, allowed)
    assert table_t["num_samples"] == n_records  # no padded row is scored
    for key in ("scene_ids", "im_ids", "obj_ids"):
        np.testing.assert_array_equal(bop_t[key], bop_j[key])
    np.testing.assert_allclose(bop_t["poses"], bop_j["poses"], rtol=0, atol=TRAJ_ATOL)
    return allowed


def test_cli_test_on_disk_matches_reference(tmp_path, lm6d_root):
    spec = _spec(tmp_path, lm6d_root)
    got, want = _run_both(tmp_path, spec, [])
    records = [r for o in OBJECTS for r in lm6d_j.LM6DDataset(lm6d_root, OBJECTS).gt_roidb(
        o, "test")]
    assert len(records) % spec["test"]["batch_size"]  # the last batch is padded
    allowed = _assert_runs_agree(spec, got, want, len(records))
    assert sum(v for row in allowed.values() for k, v in row.items() if k != "auc_add(-s)") <= 2
    bop = got[2]
    assert [int(s) for s in bop["scene_ids"]] == [int(r.scene) for r in records]
    assert [int(i) for i in bop["im_ids"]] == [int(r.frame) for r in records]
    assert list(bop["obj_ids"]) == [[8, 11][r.class_idx] for r in records]
    np.testing.assert_array_equal(got[0]["traj"][0], np.stack([r.init_pose for r in records]))


def test_cli_test_init_poses_from_a_bop_csv(tmp_path, lm6d_root, capsys):
    spec = _spec(tmp_path, lm6d_root, init="perturb")
    path = _write(tmp_path, spec)
    records = [r for o in OBJECTS for r in lm6d_t.LM6DDataset(lm6d_root, OBJECTS).gt_roidb(
        o, "test")]
    csv = str(tmp_path / "init.csv")
    write_bop_csv(csv, np.stack([r.init_pose for r in records]),
                  np.array([[8, 11][r.class_idx] for r in records]),
                  scene_ids=np.array([int(r.scene) for r in records]),
                  im_ids=np.array([int(r.frame) for r in records]))
    assert cli_test.main(["--cfg", path, "--device", "cpu", "--save-poses", "--no-refine",
                          "--init-poses", csv]) == 0
    assert f"matched {len(records)}/{len(records)}" in capsys.readouterr().out
    traj = np.load(tmp_path / "out" / "lm6d" / "refined_poses.npz")["traj"]
    np.testing.assert_allclose(traj[0], np.stack([r.init_pose for r in records]), atol=1e-6)


@pytest.fixture(scope="module")
def ycb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ycbv"))
    ds = video_j.gen_video(root, {"box": box_mesh(), "icosphere": icosphere_mesh()},
                           K_CAM, (60, 80), num_frames=4, num_sequences=1, seed=1)
    (seq,) = ds.sequences()
    ds.write_keyframes([(seq, fid) for fid in ds.frame_ids(seq)[::2]])
    return root


def test_cli_test_ycb_keyframes_with_posecnn_mat(tmp_path, ycb_root, capsys):
    scipy_io = pytest.importorskip("scipy.io")
    vds = video_j.VideoDataset(ycb_root, OBJECTS)
    recs = video_j.keyframe_records(vds)
    mats = tmp_path / "posecnn"
    mats.mkdir()
    rng = np.random.RandomState(3)
    for ki, (seq, fid) in enumerate(vds.keyframes()):
        rois, poses = [], []
        for obj in vds.objects_in(seq):
            gt = vds.keyframe_pose(seq, fid, obj)
            w = np.sqrt(max(1e-9, 1 + np.trace(gt[:, :3]))) / 2  # a near-GT quaternion
            q = np.array([w, (gt[2, 1] - gt[1, 2]) / (4 * w), (gt[0, 2] - gt[2, 0]) / (4 * w),
                          (gt[1, 0] - gt[0, 1]) / (4 * w)]) + rng.normal(0, 0.05, 4)
            rois.append([0, [3, 7][OBJECTS.index(obj)], 0, 0, 0, 0, 0.9])
            poses.append(np.concatenate([q, gt[:, 3] + rng.normal(0, 0.01, 3)]))
        scipy_io.savemat(str(mats / f"{ki:06d}.mat"), {"rois": np.asarray(rois, np.float32),
                                                      "poses": np.asarray(poses, np.float32)})
    spec = _spec(tmp_path, ycb_root, name="ycb_video")
    spec["dataset"]["obj_ids"] = [3, 7]
    got, want = _run_both(tmp_path, spec, ["--posecnn-mat", str(mats)])
    out = capsys.readouterr().out
    assert out.count(f"matched {len(recs)}/{len(recs)}") == 2  # both packages
    _assert_runs_agree(spec, got, want, len(recs))
    assert set(got[2]["obj_ids"]) == {3, 7}


def test_cli_test_cad_dir(tmp_path, capsys):
    cad = tmp_path / "cad"
    cad.mkdir()
    (cad / "chair.obj").write_text(_obj_text())
    (cad / "table.off").write_text(_off_text(glued_header=True))
    spec = _spec(tmp_path, "", name="modelnet")
    spec["dataset"].update(cad_dir=str(cad), eval_objects=["box"], zoo_size=2, obj_ids=[])
    spec["network"]["class_agnostic"] = True
    path = tmp_path / "modelnet.yaml"
    path.write_text(yaml.safe_dump(spec))
    assert cli_test.main(["--cfg", str(path), "--device", "cpu", "--num-samples", "3"]) == 0
    table = json.loads((tmp_path / "out" / "modelnet" / "eval_results.json").read_text())
    assert set(table["per_class"]) <= {"chair", "table"} and table["num_samples"] == 3


def test_cli_train_on_disk_interleaves_as_the_reference(tmp_path, lm6d_root, monkeypatch,
                                                        capsys):
    spec = _spec(tmp_path, lm6d_root)
    spec["train"].update(num_steps=6, syn_fraction=0.3)
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(spec))

    # The port: real steps, each one's kind recorded.
    order_t, batches_t = [], []
    make_disk = cli_train.make_disk_step

    def recording_disk(*a, **kw):
        step = make_disk(*a, **kw)
        nxt = step.batcher.next

        def next_batch():
            b = nxt()
            batches_t.append(b["pose_tgt"].numpy().copy())
            return b

        step.batcher.next = next_batch

        def run(state, g):
            order_t.append("disk")
            return step(state, g)

        run.batcher = step.batcher
        return run

    from deepim_tpu_torch.train import train as train_t

    make_syn = train_t.make_synthetic_train_step

    def recording_syn(*a, **kw):
        step = make_syn(*a, **kw)

        def run(state, g):
            order_t.append("synthetic")
            return step(state, g)

        return run

    monkeypatch.setattr(cli_train, "make_disk_step", recording_disk)
    monkeypatch.setattr(train_t, "make_synthetic_train_step", recording_syn)
    assert cli_train.main(["--cfg", str(path), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "on-disk training: 8 frames, syn_fraction=0.3" in text
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in text.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 6 and np.isfinite(losses).all()

    # The reference: its steps stubbed, its order and disk batches recorded.
    import deepim_tpu.train as train_pkg_j

    order_j, batches_j = [], []
    metrics = {"loss": 0.0, "rot_err_deg_0": 0.0, "trans_err_0": 0.0}

    def stub(kind):
        def make(*a, **kw):
            def step(state, batch_or_key):
                order_j.append(kind)
                if kind == "disk":
                    batches_j.append(np.asarray(batch_or_key["pose_tgt"]))
                return state, metrics
            return step
        return make

    monkeypatch.setattr(train_pkg_j, "make_synthetic_train_step", stub("synthetic"))
    monkeypatch.setattr(train_pkg_j, "make_train_step", stub("disk"))
    monkeypatch.setattr(ckpt_j, "save_checkpoint", lambda *a, **kw: None)
    spec_j = dict(spec, experiment="train_j")
    (tmp_path / "train_j.yaml").write_text(yaml.safe_dump(spec_j))
    assert cli_train_j.main(["--cfg", str(tmp_path / "train_j.yaml"), "--n-devices", "1"]) == 0
    assert order_t == order_j == [
        "synthetic" if cli_train.frac_hit(0.3, it) else "disk" for it in range(6)]
    assert len(batches_t) == len(batches_j) == order_t.count("disk")
    for a, b in zip(batches_t, batches_j):
        np.testing.assert_array_equal(a, b)
