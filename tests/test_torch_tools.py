"""deepim_tpu_torch.tools against the reference's tools/ (CPU); the
supervisor's cases are tests/test_torch_supervisor.py's.

- ``seed_variance``: on the same ``eval_results.json`` files the port's
  table and recorded aggregate equal the reference tool's.
- ``gen_lm6d_cfgs``: the port's ``--out`` tree equals, byte for byte, the
  reference tool's (run in a tmp working directory) and the committed
  ``experiments/cfgs/lm6d/`` (16 files).
- ``plot_train``: on a log with the port's ``train_log.jsonl`` keys, the
  smoothed series of each panel equal the reference's ``ema`` over its
  ``PANELS``, both print the same ``wrote`` line, and the port writes its
  PNG with matplotlib blocked.
- ``demo_render``: the port writes the reference's five images, each a PNG
  of the reference's size (the reference's own run, 35 s of XLA on the CPU,
  is left out; its file names are read from its source).
- ``scale_eval_demo``: the port's generated set is the reference's, record
  for record and frame for frame (both read by the port); the streamed
  ``cli.test --no-refine`` runs over it and prints the peak RSS.
- ``decimation_ab`` and ``robustness_curve`` (without and with
  hypotheses): the port's tool and the reference's at 48x64 with 8 samples,
  both without a checkpoint (identity-delta refiners) and fed the same
  numpy batches in place of ``synthetic_batch`` (and, in the hypothesis
  route, the same perturbations): exit 0, the same seeds and noise
  arguments, equal tables, and every recorded and evaluated mean within
  1e-4; ``decimation_ab``'s refinements get the full mesh's metric points
  and ``--coarse-iters``.  ``decimation_ab`` runs on subdivision-4 spheres
  (5,120 faces, decimated in numpy): the plain raster of the 20,480-face
  default takes minutes on a loaded CPU, and the C++ decimation of such
  meshes is tests/test_torch_native.py's (the card runs the default in
  ``chip_smoke.py`` phase 18).
"""

import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from deepim_tpu_torch.tools import decimation_ab as dab_t
from deepim_tpu_torch.tools import demo_render as demo_t
from deepim_tpu_torch.tools import gen_lm6d_cfgs as gen_t
from deepim_tpu_torch.tools import plot_train as plot_t
from deepim_tpu_torch.tools import robustness_curve as rob_t
from deepim_tpu_torch.tools import scale_eval_demo as scale_t
from deepim_tpu_torch.tools import seed_variance as sv_t

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools import decimation_ab as dab_j  # noqa: E402
from tools import gen_lm6d_cfgs as gen_j  # noqa: E402
from tools import plot_train as plot_j  # noqa: E402
from tools import robustness_curve as rob_j  # noqa: E402
from tools import scale_eval_demo as scale_j  # noqa: E402
from tools import seed_variance as sv_j  # noqa: E402


def _spec(tmp_path, **train):
    return {
        "experiment": "tools", "output_dir": str(tmp_path / "out"),
        "network": {"input_height": 48, "input_width": 64, "dtype": "float32", "fc_dim": 32,
                    "with_flow": False, "with_mask": False},
        "dataset": {"name": "synthetic", "objects": ["box", "icosphere"], "image_height": 48,
                    "image_width": 64, "fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0,
                    "num_points": 64},
        "train": {"batch_size": 2, "num_steps": 2, "optimizer": "adam", "lr": 1e-4,
                  "log_every": 1, "checkpoint_every": 2, "warmup_steps": 0, "w_flow": 0.0,
                  "w_mask": 0.0, **train},
        "test": {"test_iter": 2, "batch_size": 4},
    }


def _cfg(tmp_path, **train) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_spec(tmp_path, **train)))
    return str(path)


# -- seed_variance ----------------------------------------------------------------


def test_seed_variance_equals_the_reference_tool(tmp_path, capsys):
    rng = np.random.RandomState(0)
    dirs = []
    for i in range(3):
        d = tmp_path / f"run_seed{i}"
        d.mkdir()
        mean = {k: float(rng.uniform(0, 100)) for k in sv_t.METRICS}
        mean["mean_rot_deg"] = 1.0
        (d / "eval_results.json").write_text(json.dumps(
            {"mean": mean, "num_samples": 64 + i, "per_class": {}}))
        dirs.append(str(d))
    assert sv_t.main(dirs + ["--results-out", str(tmp_path / "t.json")]) == 0
    out_t = capsys.readouterr().out
    assert sv_j.main(dirs + ["--results-out", str(tmp_path / "j.json")]) == 0
    out_j = capsys.readouterr().out
    table = [ln for ln in out_t.splitlines() if not ln.startswith("recorded")]
    assert table == [ln for ln in out_j.splitlines() if not ln.startswith("recorded")]
    assert len(table) == 3 + 2 + 3
    rt = json.loads((tmp_path / "t.json").read_text())
    rj = json.loads((tmp_path / "j.json").read_text())
    assert rt["results"] == rj["results"]
    assert rt["experiment"] == rj["experiment"] == "seed_variance"
    assert rt["argv"] == rj["argv"] == dirs
    assert sv_t.main(dirs[:1]) == 2  # fewer than two runs: the usage


# -- decimation_ab and robustness_curve --------------------------------------------
#
# Both tools run here with no checkpoint, so each side refines with its
# identity-delta net, and with ``synthetic_batch`` replaced in both packages by
# the same numpy batches: the refined poses then depend only on the inputs, and
# every table cell and recorded mean must agree.  The stand-in draws its pose
# noise from the arguments the tool passes (so a wrong noise schedule shows in
# the metrics) and records them with the seed it was given.


def _quat_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _axis_angle(axis: np.ndarray, deg: float) -> np.ndarray:
    h = np.deg2rad(deg) / 2
    return _quat_mat(np.concatenate([[np.cos(h)], np.sin(h) * axis / np.linalg.norm(axis)]))


def _batch(seed, num_classes, bs, size, rot_noise_deg, rot_max_deg, trans_noise, trans_max):
    """One batch of ``synthetic_batch``'s keys, in numpy, from ``seed``; the
    init poses perturb the targets by the noise arguments (gaussian, clipped)."""
    rng = np.random.RandomState(seed)
    h, w = size
    tgt = np.zeros((bs, 3, 4))
    src = np.zeros((bs, 3, 4))
    for i in range(bs):
        tgt[i, :, :3] = _quat_mat(rng.normal(size=4))
        tgt[i, :, 3] = [rng.uniform(-0.03, 0.03), rng.uniform(-0.02, 0.02),
                        rng.uniform(0.5, 0.8)]
        deg = float(np.clip(rng.normal() * rot_noise_deg, -rot_max_deg, rot_max_deg))
        src[i, :, :3] = _axis_angle(rng.normal(size=3), deg) @ tgt[i, :, :3]
        src[i, :, 3] = tgt[i, :, 3] + np.clip(rng.normal(size=3) * np.asarray(trans_noise),
                                              -np.asarray(trans_max), np.asarray(trans_max))
    depth = rng.uniform(0.5, 0.9, (bs, h, w)) * (rng.uniform(size=(bs, h, w)) > 0.4)
    return {"obs_rgb": rng.uniform(size=(bs, h, w, 3)).astype(np.float32),
            "obs_depth": depth.astype(np.float32), "obs_mask": depth > 0,
            "pose_src": src.astype(np.float32), "pose_tgt": tgt.astype(np.float32),
            "class_idx": rng.randint(0, num_classes, bs)}


def _args(rot_noise_deg, rot_max_deg, trans_noise, trans_max):
    return (float(rot_noise_deg), float(rot_max_deg), tuple(float(x) for x in trans_noise),
            tuple(float(x) for x in trans_max))


def _hypothesis_noise(reps):
    """``perturb_poses``' stand-in inside the hypothesis route -> fixed numpy
    rotations and shifts for the tiled inits ``reps``, a function of their
    shape alone (the reference traces it under jit)."""
    rng = np.random.RandomState(123)
    n = reps.shape[0]
    rot = np.stack([_axis_angle(rng.normal(size=3), rng.uniform(5, 25)) for _ in range(n)])
    shift = rng.uniform(-0.02, 0.02, (n, 3))
    return rot.astype(np.float32), shift.astype(np.float32)


def _fixed_inputs(monkeypatch, calls):
    """Replace ``synthetic_batch`` and the hypothesis route's ``perturb_poses``
    in both packages; ``calls`` collects (side, seed, noise arguments)."""
    import jax.numpy as jnp
    import torch

    import deepim_tpu.data.synthetic as syn_j
    import deepim_tpu.refine.hypotheses as hyp_j
    import deepim_tpu_torch.data.synthetic as syn_t
    import deepim_tpu_torch.refine.hypotheses as hyp_t

    def fake_t(generator, assets, bs, k, size, rot_noise_deg=15.0, rot_max_deg=45.0,
               trans_noise=(0.01, 0.01, 0.05), trans_max=(0.03, 0.03, 0.15), **_):
        args = _args(rot_noise_deg, rot_max_deg, trans_noise, trans_max)
        calls.append(("torch", generator.initial_seed(), bs, tuple(size), args))
        b = {kk: torch.from_numpy(v) for kk, v in _batch(
            generator.initial_seed(), assets.num_classes, bs, size, *args).items()}
        b["class_idx"] = b["class_idx"].long()
        b["k"] = k.expand(bs, 3, 3)
        return b

    def fake_j(key, assets, bs, k, size, rot_noise_deg=15.0, rot_max_deg=45.0,
               trans_noise=(0.01, 0.01, 0.05), trans_max=(0.03, 0.03, 0.15), **_):
        seed = int(np.asarray(key).ravel()[-1])
        args = _args(rot_noise_deg, rot_max_deg, trans_noise, trans_max)
        calls.append(("jax", seed, bs, tuple(size), args))
        b = {kk: jnp.asarray(v) for kk, v in _batch(
            seed, assets.num_classes, bs, size, *args).items()}
        b["class_idx"] = b["class_idx"].astype(jnp.int32)
        b["k"] = jnp.tile(k[None], (bs, 1, 1))
        return b

    def hyp_fake_t(generator, reps, rot_std_deg, rot_max_deg, trans_std, trans_max):
        calls.append(("torch_hyp", generator.initial_seed(),
                      _args(rot_std_deg, rot_max_deg, trans_std, trans_max)))
        rot, shift = (torch.from_numpy(x) for x in _hypothesis_noise(reps))
        return torch.cat([rot @ reps[:, :, :3], (reps[:, :, 3] + shift)[..., None]], -1)

    def hyp_fake_j(key, reps, rot_std_deg, rot_max_deg, trans_std, trans_max):
        calls.append(("jax_hyp", None, _args(rot_std_deg, rot_max_deg, trans_std, trans_max)))
        rot, shift = _hypothesis_noise(reps)
        return jnp.concatenate([jnp.einsum("nij,njk->nik", rot, reps[:, :, :3]),
                                (reps[:, :, 3] + shift)[..., None]], -1)

    monkeypatch.setattr(syn_t, "synthetic_batch", fake_t)
    monkeypatch.setattr(syn_j, "synthetic_batch", fake_j)
    monkeypatch.setattr(hyp_t, "perturb_poses", hyp_fake_t)
    monkeypatch.setattr(hyp_j, "perturb_poses", hyp_fake_j)
    return hyp_j.refine_multi_hypothesis.clear_cache  # traced with the stand-in


def _spy(monkeypatch, module, name, log, side):
    fn = getattr(module, name)

    def spy(*a, **kw):
        out = fn(*a, **kw)
        log.append((side, a, kw, out))
        return out

    monkeypatch.setattr(module, name, spy)


def _table(out: str, header_start: str) -> list[str]:
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.lstrip().startswith(header_start))
    return [ln for ln in lines[i:] if ln.strip() and not ln.startswith("recorded")]


def _cells(table: list[str]) -> list[list[str]]:
    return [ln.split() for ln in table[2:]]


def _means_close(a: dict, b: dict, where: str = "mean"):
    """Every number of two (nested) metric dicts within float32 rounding."""
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _means_close(a[k], b[k], f"{where}.{k}")
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=f"{where}.{k}")


def test_decimation_ab_runs_as_the_reference_tool(tmp_path, capsys, monkeypatch):
    import deepim_tpu.eval as eval_j
    import deepim_tpu.refine as refine_j
    import deepim_tpu_torch.eval as eval_t
    import deepim_tpu_torch.refine as refine_t

    calls, evals, refines = [], [], []
    clear = _fixed_inputs(monkeypatch, calls)
    _spy(monkeypatch, eval_t, "evaluate_poses", evals, "torch")
    _spy(monkeypatch, eval_j, "evaluate_poses", evals, "jax")
    _spy(monkeypatch, refine_t, "refine_poses", refines, "torch")
    _spy(monkeypatch, refine_j, "refine_poses", refines, "jax")
    cfg = _cfg(tmp_path)
    args = ["--cfg", cfg, "--budgets", "1024,4096,0", "--samples", "8", "--subdiv", "4",
            "--coarse-iters", "1"]
    try:
        assert dab_t.main(args + ["--device", "cpu", "--results-out",
                                  str(tmp_path / "t.json")]) == 0
        out_t = capsys.readouterr().out
        assert dab_j.main(args + ["--results-out", str(tmp_path / "j.json")]) == 0
        out_j = capsys.readouterr().out
    finally:
        clear()
    assert "dense meshes: [5120, 5120]" in out_t and "dense meshes: [5120, 5120]" in out_j
    # the observations: two batches of four, seeded 52000 + i, the config's noise
    side = {s: [c[1:] for c in calls if c[0] == s] for s in ("torch", "jax")}
    assert side["torch"] == side["jax"] and [c[0] for c in side["torch"]] == [52000, 52001]
    # each budget's refinement: the decimated assets with the full mesh's
    # metric points, 2 iterations of which --coarse-iters 1
    assert len(refines) == 12
    for (_, at, kt, _), (_, aj, kj, _) in zip(refines[:6], refines[6:]):
        assert (kt["num_iters"], kt["coarse_iters"]) == (kj["num_iters"], kj["coarse_iters"])
        assert kt["coarse_iters"] == 1
        np.testing.assert_array_equal(at[1].points.numpy(), np.asarray(aj[2].points))
        np.testing.assert_array_equal(at[1].diameters.numpy(), np.asarray(aj[2].diameters))
        assert at[1].tri_pos.shape[2] == np.asarray(aj[2].tri_pos).shape[2]
    tt, tj = _table(out_t, "budget"), _table(out_j, "budget")
    assert tt == tj and len(tt) == 5
    assert [c[:2] for c in _cells(tt)][-1] == ["full", "5120"]
    rt = json.loads((tmp_path / "t.json").read_text())["results"]
    rj = json.loads((tmp_path / "j.json").read_text())["results"]
    assert rt.keys() == rj.keys() and rt["samples"] == rj["samples"] == 8
    assert rt["checkpoint_step"] == rj["checkpoint_step"] == 0
    for a, b in zip(rt["rows"], rj["rows"], strict=True):
        assert {k: v for k, v in a.items() if k != "mean"} == \
            {k: v for k, v in b.items() if k != "mean"}
        _means_close(a["mean"], b["mean"])
    assert len(evals) == 6
    for (_, _, _, a), (_, _, _, b) in zip(evals[:3], evals[3:]):
        _means_close(a["mean"], b["mean"])


@pytest.mark.parametrize("hypotheses", [1, 3])
def test_robustness_curve_runs_as_the_reference_tool(tmp_path, capsys, monkeypatch,
                                                      hypotheses):
    import deepim_tpu.eval as eval_j
    import deepim_tpu_torch.eval as eval_t

    calls, evals = [], []
    clear = _fixed_inputs(monkeypatch, calls)
    _spy(monkeypatch, eval_t, "evaluate_poses", evals, "torch")
    _spy(monkeypatch, eval_j, "evaluate_poses", evals, "jax")
    cfg = _cfg(tmp_path)
    args = ["--cfg", cfg, "--samples", "8", "--rot-levels", "5,30",
            "--hypotheses", str(hypotheses)]
    try:
        assert rob_t.main(args + ["--device", "cpu"]) == 0
        out_t = capsys.readouterr().out
        assert rob_j.main(args) == 0
        out_j = capsys.readouterr().out
    finally:
        clear()
    # each level's batches, seeded 31000 + i: rotation noise at the level and
    # 3x it, translation noise 0.02 m at 15 degrees scaled by level / 15
    side = {s: [c[1:] for c in calls if c[0] == s] for s in ("torch", "jax")}
    assert side["torch"] == side["jax"]
    tr = lambda rot: 0.02 * rot / 15.0  # noqa: E731
    assert side["torch"] == [(31000 + i, 4, (48, 64), (rot, 3 * rot, (tr(rot),) * 3,
                                                       (3 * tr(rot),) * 3))
                             for rot in (5.0, 30.0) for i in range(2)]
    hyp = {s: {c[2] for c in calls if c[0] == s} for s in ("torch_hyp", "jax_hyp")}
    assert hyp["torch_hyp"] == hyp["jax_hyp"]
    assert len(hyp["torch_hyp"]) == (hypotheses > 1)
    assert [c[1] for c in calls if c[0] == "torch_hyp"] == [77, 78] * 2 * (hypotheses > 1)
    tt, tj = _table(out_t, "rot_std"), _table(out_j, "rot_std")
    assert tt == tj and len(tt) == 4
    assert len(evals) == 8  # init and refined, two levels, both sides
    for (_, _, _, a), (_, _, _, b) in zip(evals[:4], evals[4:]):
        _means_close(a["mean"], b["mean"])


# -- gen_lm6d_cfgs, plot_train, demo_render, scale_eval_demo ------------------------


def _tree(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def test_gen_lm6d_cfgs_equals_the_reference_and_the_committed_tree(tmp_path, monkeypatch,
                                                                   capsys):
    monkeypatch.chdir(tmp_path)  # the reference writes the relative experiments/cfgs/lm6d
    assert gen_j.main() == 0
    assert gen_t.main(["--out", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert "wrote 16 configs under" in out
    port = _tree(tmp_path / "port")
    assert len(port) == 16
    assert port == _tree(tmp_path / "experiments" / "cfgs" / "lm6d")
    assert port == _tree(ROOT / "experiments" / "cfgs" / "lm6d")


def test_plot_train_series_equal_the_reference_without_matplotlib(tmp_path, monkeypatch,
                                                                  capsys):
    from deepim_tpu_torch.data.png import read_png

    rng = np.random.RandomState(0)
    log = tmp_path / "exp" / "train_log.jsonl"
    log.parent.mkdir()
    with open(log, "w") as f:  # the keys cli.train writes (train_iter 2, flow + mask)
        for step in range(1, 41):
            rec = {"step": step, "loss": float(np.exp(-step / 20) + 0.1 * rng.rand())}
            for it in range(2):
                for k in ("pm_loss", "flow_loss", "mask_loss", "rot_err_deg", "trans_err",
                          "add"):
                    rec[f"{k}_{it}"] = float(rng.rand() / step)
            rec["grad_norm"] = float(rng.rand())
            f.write(json.dumps(rec) + "\n")
    recs = plot_j.load(str(log))
    keys = sorted({k for r in recs for k in r} - {"step", "time"})
    for (title, log_y, series), (title_j, prefixes, log_y_j) in zip(
            plot_t.panel_series(recs, 0.9), plot_j.PANELS):
        assert (title, log_y) == (title_j, log_y_j)
        cols = sorted(k for k in keys if any(k == p or k.startswith(p) for p in prefixes))
        assert list(series) == cols and cols
        for k in cols:
            assert series[k] == plot_j.ema([r.get(k, float("nan")) for r in recs], 0.9)
    assert plot_j.main([str(log), "--out", str(tmp_path / "j.png")]) == 0
    line_j = capsys.readouterr().out.splitlines()[0]
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the card's machine has none
    assert plot_t.main([str(log), "--out", str(tmp_path / "t.png")]) == 0
    line_t = capsys.readouterr().out.splitlines()[0]
    assert line_t.replace("t.png", "j.png") == line_j
    img = read_png(str(tmp_path / "t.png"))
    assert img.shape == (*plot_t.SIZE, 3) and len(np.unique(img.reshape(-1, 3), axis=0)) > 3


def test_demo_render_writes_the_reference_images(tmp_path, capsys):
    from deepim_tpu_torch.data.png import read_png

    src = (ROOT / "tools" / "demo_render.py").read_text()
    names = sorted(re.findall(r'os\.path\.join\(out_dir, "([\w.]+\.png)"\)', src))
    assert len(names) == 5
    assert demo_t.main([str(tmp_path / "demo"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "demo")) == names
    sizes = {n: read_png(str(tmp_path / "demo" / n)).shape for n in names}
    from deepim_tpu_torch.utils import side_by_side

    assert sizes["objects.png"] == side_by_side(*[np.zeros((480, 640, 3), np.uint8)] * 4).shape
    for n in ("overlay_init_vs_observed.png", "flow_gt.png", "scene.png", "textured.png"):
        assert sizes[n] == (480, 640, 3), n
    scene = read_png(str(tmp_path / "demo" / "scene.png"))
    assert scene.max() > 0  # the objects are in view
    assert "wrote demo images to" in capsys.readouterr().out


def test_scale_eval_demo_generates_the_reference_set_and_streams_it(tmp_path, capsys):
    from deepim_tpu_torch.data.lm6d import LM6DDataset

    hw = (24, 32)
    scale_j.gen_noise_dataset(str(tmp_path / "j"), 8, hw)
    scale_t.gen_noise_dataset(str(tmp_path / "t"), 8, hw)
    dj, dt = (LM6DDataset(str(tmp_path / s), ["box", "icosphere"]) for s in ("j", "t"))
    for obj in ("box", "icosphere"):
        rj, rt = dj.gt_roidb(obj, "test"), dt.gt_roidb(obj, "test")
        assert len(rj) == len(rt) == 4
        for a, b in zip(rj, rt):
            assert (a.scene, a.frame, a.class_idx) == (b.scene, b.frame, b.class_idx)
            np.testing.assert_array_equal(a.pose, b.pose)
            for x, y in zip(dj.load_frame_raw(a), dt.load_frame_raw(b)):
                np.testing.assert_array_equal(x, y)
    assert scale_t.main(["--frames", "8", "--height", "24", "--width", "32", "--batch-size",
                         "4", "--root", str(tmp_path / "t"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[INIT]" in out
    assert re.search(r"streamed eval over 8 frames x 3000 points: [\d.]+s, peak host RSS "
                     r"[\d.]+ GB", out)
    assert not (tmp_path / "t").exists()  # removed without --keep
