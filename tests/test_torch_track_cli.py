"""deepim_tpu_torch.cli.track (CPU).

- ``cli.track.main`` end to end on generated sequences: the table and
  ``track_results.json``; ``--window 2`` over 3 frames (a boundary
  crossing) gives the same ``mean`` as one window, as
  tests/test_scene_video.py §test_cli_track_end_to_end asks of the
  reference.
- The manifest: a second identical call reuses the generated directory
  and prints no "generating" line; ``--num-frames 4`` generates another
  and leaves the first; a directory whose ``gen_params.json`` differs
  from the parameters asked for is generated afresh.
- Recovery armed over occluded sequences, and a model that takes the
  observed mask and depth from the label and depth streams under both
  ``--label-ids`` conventions.
- ``cuda:0`` with no card raises.
"""

import json
import os

import pytest
import torch
import yaml

from deepim_tpu_torch.cli import track as cli_track
from deepim_tpu_torch.data import video as video_t

H, W = 32, 64  # the network's crops; the frames are 48x80


def _cfg(tmp_path, name="trk", **network):
    spec = {
        "experiment": name,
        "output_dir": str(tmp_path / "out"),
        "network": {"input_height": H, "input_width": W, "dtype": "float32", "fc_dim": 32,
                    "with_flow": False, "with_mask": False, **network},
        "dataset": {"name": "synthetic", "objects": ["box", "icosphere"], "image_height": 48,
                    "image_width": 80, "fx": 60.0, "fy": 60.0, "cx": 40.0, "cy": 24.0,
                    "num_points": 64, "obj_ids": [3, 7]},
        "train": {"batch_size": 8},
        "test": {"test_iter": 1},
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(spec))
    return str(path), tmp_path / "out" / name


FAST = ["--device", "cpu", "--num-frames", "3", "--iters-first", "1", "--iters-rest", "1"]


def _data_dirs(out_dir):
    return sorted(d for d in os.listdir(out_dir) if d.startswith("video_data_"))


def test_track_end_to_end_windows_and_manifest(tmp_path, capsys):
    path, out_dir = _cfg(tmp_path)
    assert cli_track.main(["--cfg", path, *FAST]) == 0
    text = capsys.readouterr().out
    assert "generating synthetic video dataset" in text and "frames/s on cpu" in text
    assert "video tracking (AUC = YCB protocol)" in text
    whole = json.loads((out_dir / "track_results.json").read_text())
    assert whole["num_samples"] == 6  # 2 single-object sequences x 3 frames
    (first,) = _data_dirs(out_dir)
    manifest = video_t.read_manifest(str(out_dir / first))
    assert manifest["num_frames"] == 3 and manifest["objects"] == ["box", "icosphere"]

    # the same call reuses the data; windows of 2 frames give the same metrics
    assert cli_track.main(["--cfg", path, *FAST, "--window", "2"]) == 0
    text = capsys.readouterr().out
    assert "generating" not in text and "reusing" in text and "(2 windows)" in text
    windowed = json.loads((out_dir / "track_results.json").read_text())
    assert windowed["mean"] == whole["mean"]

    # other parameters: another directory, the first one kept
    args = ["--cfg", path, "--device", "cpu", "--num-frames", "4", "--iters-first", "1",
            "--iters-rest", "1"]
    assert cli_track.main(args) == 0
    assert "generating" in capsys.readouterr().out
    assert len(_data_dirs(out_dir)) == 2 and first in _data_dirs(out_dir)
    assert json.loads((out_dir / "track_results.json").read_text())["num_samples"] == 8

    # a directory whose manifest differs from the one asked for is not reused
    mpath = out_dir / first / video_t.MANIFEST
    stale = json.loads(mpath.read_text())
    stale["num_frames"] = 5
    mpath.write_text(json.dumps(stale))
    assert cli_track.main(["--cfg", path, *FAST]) == 0
    assert "generating" in capsys.readouterr().out
    assert video_t.read_manifest(str(out_dir / first))["num_frames"] == 3
    assert json.loads((out_dir / "track_results.json").read_text())["mean"] == whole["mean"]


def test_track_recovery_over_occluders(tmp_path, capsys):
    path, out_dir = _cfg(tmp_path, "occ")
    record = tmp_path / "results" / "occ.json"
    assert cli_track.main(["--cfg", path, *FAST, "--occluders", "1", "--recover-threshold",
                           "-0.12", "--recover-hypotheses", "2", "--recover-iters", "1",
                           "--results-out", str(record)]) == 0
    text = capsys.readouterr().out
    assert "low-confidence" in text  # untrained heads: recovery is tried
    (root,) = _data_dirs(out_dir)
    assert video_t.read_manifest(str(out_dir / root))["occluders"] == 1
    wrapped = json.loads(record.read_text())
    assert wrapped["results"]["num_samples"] == 6 and "git" in wrapped


@pytest.mark.parametrize("label_ids", ["slot", "global"])
def test_track_with_mask_and_depth_streams(tmp_path, capsys, label_ids):
    path, out_dir = _cfg(tmp_path, f"md_{label_ids}", input_mask=True, input_depth=True)
    assert cli_track.main(["--cfg", path, *FAST, "--label-ids", label_ids]) == 0
    text = capsys.readouterr().out
    # gen_video writes slot labels, so the global ids (3, 7) match nothing
    assert ("matched no pixels" in text) == (label_ids == "global")
    assert "no depth stream" not in text and "no label stream" not in text
    assert json.loads((out_dir / "track_results.json").read_text())["num_samples"] == 6


def test_track_refuses_without_a_card(tmp_path, monkeypatch):
    path, _ = _cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli_track.main(["--cfg", path, "--device", "cuda:0"])
