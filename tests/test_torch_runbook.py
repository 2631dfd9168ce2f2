"""deepim_tpu_torch.cli.runbook against tools/real_data_runbook.py (CPU).

The five cases of ``tests/test_runbook.py`` (detection of every layout, a
dry run on a converted drop, the original LINEMOD release converted, a
stop with exit code 2 on a validation ERROR, the ``--weights`` leg), each
run through the port's runbook and, where it writes files, the reference's
too: the same detected layouts, the same derived dataset config, the same
converted files, the same exit codes.  Then the whole chain on the CPU:
the runbook converts a BOP release, imports MXNet weights and runs
``cli.test``; its table and trajectories equal those of ``cli.test`` on the
same model's port checkpoint saved directly.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from deepim_tpu_torch.cli import runbook  # noqa: E402
from deepim_tpu_torch.data.toolkit import gen_procedural_dataset  # noqa: E402
from test_lm_original import _write_original_object  # noqa: E402
from test_torch_release_fixtures import assert_trees_match, write_bop_release  # noqa: E402
from tools import real_data_runbook as runbook_j  # noqa: E402

K_CAM = np.array([[120.0, 0, 64], [0, 120.0, 32], [0, 0, 1]], np.float32)


def _converted_root(tmp_path, name="drop"):
    root = str(tmp_path / name)
    gen_procedural_dataset(root, ["box", "icosphere"], K_CAM, (64, 128), frames_per_obj=3,
                           seed=0, device="cpu")
    return root


def _cfg(path="output/real_data_runbook/config.yaml"):
    with open(path) as f:
        return yaml.safe_load(f)


def test_detect_release_layouts(tmp_path):
    conv = _converted_root(tmp_path)
    orig = str(tmp_path / "accv")
    _write_original_object(orig, "cat")
    ycb = str(tmp_path / "ycb")
    os.makedirs(os.path.join(ycb, "data", "0000"))
    os.makedirs(os.path.join(ycb, "image_sets"))
    open(os.path.join(ycb, "data", "0000", "000001-color.png"), "wb").close()
    vid = str(tmp_path / "vid")
    os.makedirs(os.path.join(vid, "video_sets"))
    bop = tmp_path / "bop" / "train_pbr" / "000000"
    bop.mkdir(parents=True)
    (bop / "scene_gt.json").write_text("{}")
    for root, want in ((conv, "lm6d"), (orig, "lm_original"), (ycb, "ycb_original"),
                       (vid, "ycb_video"), (str(tmp_path / "bop"), "bop:train_pbr")):
        assert runbook.detect_release(root) == runbook_j.detect_release(root) == want
    with pytest.raises(SystemExit):
        runbook.detect_release(str(tmp_path / "ycb" / "data"))


def test_runbook_dry_run_on_converted_drop(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = _converted_root(tmp_path)
    assert runbook.main([root, "--dry-run", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "detected layout: lm6d" in out and "already converted" in out
    assert "--no-refine" in out and "deepim_tpu_torch.cli.test" in out and "--device cpu" in out
    cfg = _cfg()
    assert cfg["dataset"]["objects"] == ["box", "icosphere"]
    assert cfg["dataset"]["root"] == root and cfg["dataset"]["name"] == "lm6d"
    monkeypatch.chdir(tmp_path / "drop")  # the reference writes its own output/
    assert runbook_j.main([root, "--dry-run"]) == 0
    assert _cfg()["dataset"] == cfg["dataset"]


def test_runbook_converts_original_release(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "accv")
    _write_original_object(root, "cat", n_frames=2)
    assert runbook.main([root, "--dry-run", "--device", "cpu"]) == 0
    assert "detected layout: lm_original" in capsys.readouterr().out
    assert os.path.isdir(root + "_converted")
    assert _cfg()["dataset"]["objects"] == ["cat"]
    os.makedirs(tmp_path / "ref")
    monkeypatch.chdir(tmp_path / "ref")
    assert runbook_j.main([root, "--dry-run", "--out", str(tmp_path / "ref_converted")]) == 0
    assert_trees_match(str(tmp_path / "ref_converted"), root + "_converted")


def test_runbook_stops_on_validation_error(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = _converted_root(tmp_path)
    obs = os.path.join(root, "data", "observed")
    for scene in os.listdir(obs):  # every pose in "mm"
        sd = os.path.join(obs, scene)
        for fn in os.listdir(sd):
            if "-pose_" in fn and fn.endswith(".txt"):
                pose = np.loadtxt(os.path.join(sd, fn)).reshape(3, 4)
                pose[:, 3] *= 1000.0
                np.savetxt(os.path.join(sd, fn), pose)
    assert runbook.main([root, "--dry-run", "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "stopping" in out and "pose-translation-units" in out
    assert runbook_j.main([root, "--dry-run"]) == 2
    assert runbook.main([root, "--dry-run", "--device", "cpu", "--force"]) == 0


def test_runbook_weights_overlay_dry_run(tmp_path, capsys, monkeypatch):
    """The --weights leg: an MXNet-style .npz converts onto make_model's
    state, is saved as a port checkpoint, and the planned eval refines."""
    from deepim_tpu_torch.config import config_from_dict, update_config
    from deepim_tpu_torch.train.checkpoint import checkpoint_dir, restore_checkpoint
    from deepim_tpu_torch.train.convert_mxnet import export_mxnet_npz
    from deepim_tpu_torch.train.train import make_model

    monkeypatch.chdir(tmp_path)
    root = _converted_root(tmp_path)
    mini = str(tmp_path / "mini.yaml")
    with open(mini, "w") as f:
        yaml.safe_dump({"experiment": "mini", "network": {"input_height": 64,
                                                          "input_width": 128},
                        "dataset": {"num_points": 32}}, f)
    cfg = config_from_dict({"dataset": {"objects": ["box", "icosphere"], "root": root,
                                        "name": "lm6d"}}, base=update_config(mini))
    model = make_model(cfg, 2, generator=torch.Generator().manual_seed(1))
    npz = str(tmp_path / "ref_dump.npz")
    export_mxnet_npz(model.state_dict(), npz)
    assert runbook.main([root, "--cfg", mini, "--weights", npz, "--dry-run",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "converted weights ->" in out and "--no-refine" not in out
    ckpt = checkpoint_dir(update_config("output/real_data_runbook/config.yaml"))
    step, params = restore_checkpoint(ckpt)
    assert step == 0 and params.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v), k


def test_runbook_runs_cli_test_on_the_converted_bop_release(tmp_path, capsys, monkeypatch):
    """The chain to the end on the CPU: a BOP release converted, the MXNet
    weights imported, cli.test run; its table and trajectories equal those
    of cli.test on the same model saved directly as a port checkpoint."""
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.config import save_config, update_config
    from deepim_tpu_torch.train.checkpoint import checkpoint_dir, save_checkpoint
    from deepim_tpu_torch.train.convert_mxnet import export_mxnet_npz
    from deepim_tpu_torch.train.train import make_model

    monkeypatch.chdir(tmp_path)
    k = np.array([[90.0, 0, 40], [0, 90.0, 30], [0, 0, 1]], np.float32)
    gen = str(tmp_path / "gen")
    gen_procedural_dataset(gen, ["box", "icosphere"], k, (60, 80), frames_per_obj=4, seed=1,
                           device="cpu")
    src = str(tmp_path / "bop")
    write_bop_release(gen, ["box", "icosphere"], src, k)
    base = str(tmp_path / "base.yaml")
    with open(base, "w") as f:
        yaml.safe_dump({
            "network": {"input_height": 48, "input_width": 64, "dtype": "float32",
                        "fc_dim": 32, "mxnet_pad": True},
            "dataset": {"image_height": 60, "image_width": 80, "fx": 90.0, "fy": 90.0,
                        "cx": 40.0, "cy": 30.0, "num_points": 64},
            "test": {"test_iter": 2, "batch_size": 3}}, f)
    model = make_model(update_config(base), 2, generator=torch.Generator().manual_seed(3))
    npz = str(tmp_path / "w.npz")
    export_mxnet_npz(model.state_dict(), npz)
    assert runbook.main([src, "--cfg", base, "--weights", npz, "--objects", "1:box,2:icosphere",
                         "--device", "cpu"]) == 0
    via_runbook = capsys.readouterr().out
    cfg = update_config("output/real_data_runbook/config.yaml")
    assert cfg.network.mxnet_pad and cfg.dataset.root == src + "_converted"

    import dataclasses

    direct = dataclasses.replace(cfg, experiment="direct")
    save_checkpoint(checkpoint_dir(direct), 0, model.state_dict())
    path = str(tmp_path / "direct.yaml")
    save_config(direct, path)
    for argv in (["--cfg", "output/real_data_runbook/config.yaml"], ["--cfg", path]):
        assert cli_test.main(argv + ["--device", "cpu", "--save-poses"]) == 0
    outs = capsys.readouterr().out.split("loaded checkpoint step 0")
    rows = [[ln for ln in o.splitlines() if ln.startswith(("[INIT]", "[iter", "MEAN"))]
            for o in outs[1:]]
    assert rows[0] and rows[0] == rows[1]
    assert [ln for ln in via_runbook.splitlines() if ln.startswith(("[INIT]", "[iter", "MEAN"))
            ] == rows[0]
    a = np.load("output/real_data_runbook/refined_poses.npz")["traj"]
    b = np.load("output/direct/refined_poses.npz")["traj"]
    assert a.shape == (3, 8, 3, 4) and np.array_equal(a, b)


def test_runbook_stops_on_a_bop_release_in_metres(tmp_path, capsys, monkeypatch):
    """A BOP release whose translations are metres: the port's runbook
    stops with exit code 2 at the source's preflight, printing the ERROR
    the reference's validator gives on the same tree (bop-t-meters)."""
    import json

    from deepim_tpu.data.validate import validate_bop

    monkeypatch.chdir(tmp_path)
    gen = _converted_root(tmp_path, "gen")
    src = str(tmp_path / "bop")
    names = write_bop_release(gen, ["box", "icosphere"], src, K_CAM, t_scale=1.0)
    spec = ",".join(f"{i}:{n}" for i, n in names.items())
    assert runbook.main([src, "--objects", spec, "--dry-run", "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    want = {f.code for f in validate_bop(src, "test") if f.level == "ERROR"}
    assert want == {"bop-t-meters"} and "[ERROR] bop-t-meters" in out
    assert not os.path.exists(src + "_converted")  # stopped before converting
    healthy = str(tmp_path / "bop_mm")
    write_bop_release(gen, ["box", "icosphere"], healthy, K_CAM)
    assert runbook.main([healthy, "--objects", spec, "--dry-run", "--device", "cpu"]) == 0
    with open(os.path.join(healthy, "test", "000001", "scene_gt.json")) as f:
        assert json.load(f)["0"][0]["cam_t_m2c"][2] > 100  # mm
