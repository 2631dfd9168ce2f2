"""deepim_tpu_torch.train checkpoints and the ``cli.train`` driver (CPU).

- N steps, save, restore and M more steps equal N+M straight, bit for bit.
- A params-only file (the format before the optimizer state) still
  restores, and a training file serves a pose-only model.
- ``merge_pretrained`` against the reference's on the same trees (the
  cases of tests/test_train.py §test_pretrained_partial_init).
- ``cli.train.main`` on the CPU writes ``train_log.jsonl`` lines that
  ``tools/plot_train.py`` reads and checkpoints; ``--resume`` continues
  them and draws what an uninterrupted run draws; it refuses a missing
  card, an on-disk dataset without its models and a pretrained dir of
  orbax steps (tests/test_torch_disk_cli.py trains on disk).
- A JAX-trained full tree (decoder included) round-trips through the
  bridge exactly and loads into the training model.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepim_tpu.config import config_from_dict as config_from_dict_j
from deepim_tpu.train import checkpoint as ckpt_j
from deepim_tpu.train import train as train_j
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import synthetic_batch
from deepim_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from deepim_tpu_torch.refine import build_assets
from deepim_tpu_torch.train import checkpoint as ckpt_t
from deepim_tpu_torch.train import train as train_t
from test_torch_train import IMG, K, _meshes, _spec

ROOT = Path(__file__).resolve().parents[1]


def _small_run(cfg, seed=0):
    assets = build_assets(_meshes(), num_points=32, device="cpu")
    model = train_t.make_model(cfg, 2, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(7)
    batches = [synthetic_batch(g, assets, 2, torch.from_numpy(K), IMG) for _ in range(4)]
    return assets, model, batches


def test_resume_equals_straight(tmp_path):
    spec = _spec(optimizer="adam", weight_decay=1e-3, warmup_steps=2, batch_size=2)
    cfg = config_from_dict(spec)
    assets, model, batches = _small_run(cfg)
    straight = train_t.init_state(cfg, model)
    step = train_t.make_train_step(model, assets, cfg)
    for b in batches:
        step(straight, b)

    _, model2, _ = _small_run(cfg)
    state = train_t.init_state(cfg, model2)
    step2 = train_t.make_train_step(model2, assets, cfg)
    for b in batches[:2]:
        step2(state, b)
    d = str(tmp_path / "ckpt")
    ckpt_t.save_train_state(d, state)
    _, model3, _ = _small_run(cfg, seed=99)  # other initial weights, overwritten
    resumed = ckpt_t.restore_train_state(d, train_t.init_state(cfg, model3))
    assert resumed.step == 2
    step3 = train_t.make_train_step(model3, assets, cfg)
    for b in batches[2:]:
        step3(resumed, b)
    assert resumed.step == straight.step == 4
    for (name, a), b in zip(model.state_dict().items(), model3.state_dict().values()):
        assert torch.equal(a, b), name


def test_params_only_file_still_restores(tmp_path):
    # A file of the format before the optimizer state: {"step", "params"}.
    cfg = config_from_dict(_spec())
    model = train_t.make_model(cfg, 2, inference=True)
    d = tmp_path / "ckpt"
    d.mkdir()
    torch.save({"step": 5, "params": model.state_dict()}, d / "step_00000005.pt")
    step, params = ckpt_t.restore_checkpoint(str(d))
    assert step == 5 and params.keys() == model.state_dict().keys()
    with pytest.raises(ValueError, match="params only"):
        ckpt_t.restore_train_state(str(d), train_t.init_state(cfg, train_t.make_model(cfg, 2)))
    # a training file serves a pose-only model (the decoder is dropped)
    full = train_t.make_model(cfg, 2)
    ckpt_t.save_train_state(str(d), train_t.init_state(cfg, full))
    ckpt_t.load_params(model, ckpt_t.restore_checkpoint(str(d))[1])
    assert torch.equal(model.conv1.weight, full.conv1.weight)


def test_merge_pretrained_matches_reference(tmp_path):
    """tests/test_train.py §test_pretrained_partial_init's cases, the
    reference's merge on flax trees against the port's on state_dicts."""
    spec = _spec()
    cfg_j = config_from_dict_j(spec)
    model_j = train_j.make_model(cfg_j, 2)
    src = jax.tree.map(lambda p: np.asarray(p) + 1.0,
                       train_j.init_state(cfg_j, model_j, jax.random.PRNGKey(0)).params)

    def both(tmpl_tree, src_tree, reinit=()):
        merged_j, stats_j = ckpt_j.merge_pretrained(tmpl_tree, src_tree, reinit=reinit,
                                                    log=lambda *_: None)
        merged_t, stats_t = ckpt_t.merge_pretrained(
            flax_to_torch(jax.tree.map(np.asarray, tmpl_tree["params"])),
            flax_to_torch(src_tree["params"]), reinit=reinit, log=lambda *_: None)
        assert stats_t == stats_j
        ref = flax_to_torch(jax.tree.map(np.asarray, merged_j["params"]))
        assert merged_t.keys() == ref.keys()
        for k in ref:
            assert torch.equal(merged_t[k], ref[k]), k
        return stats_t

    # RGB -> RGB-D: conv1 is wider in input channels and loads the slice.
    spec_d = _spec()
    spec_d["network"]["input_depth"] = True
    cfg_d = config_from_dict_j(spec_d)
    tmpl_d = train_j.init_state(cfg_d, train_j.make_model(cfg_d, 2),
                                jax.random.PRNGKey(1)).params
    assert both(tmpl_d, src)["sliced"] == 1
    # Another class count: the per-class heads are shape-skipped.
    cfg_3 = config_from_dict_j(spec)
    tmpl_3 = train_j.init_state(cfg_3, train_j.make_model(cfg_3, 3),
                                jax.random.PRNGKey(2)).params
    assert both(tmpl_3, src)["shape_skipped"] >= 2
    # reinit forces a fresh init on a match.
    tmpl_r = train_j.init_state(cfg_j, model_j, jax.random.PRNGKey(3)).params
    assert both(tmpl_r, src, reinit=("fc_rot", "fc_trans"))["reinit"] == 4
    # A 2-D dense weight with a longer leading dim never slices.
    fc1 = src["params"]["fc1"]["kernel"]
    stats = ckpt_t.merge_pretrained(
        {"fc1.weight": torch.zeros(fc1.shape[1], fc1.shape[0])},
        {"fc1.weight": torch.ones(fc1.shape[1], fc1.shape[0] // 2)}, log=lambda *_: None)[1]
    assert stats["sliced"] == 0 and stats["shape_skipped"] == 1
    # The port's source is a port checkpoint dir.
    d = str(tmp_path / "src")
    ckpt_t.save_checkpoint(d, 3, flax_to_torch(src["params"]))
    assert ckpt_t.restore_params_raw(d).keys() == flax_to_torch(src["params"]).keys()


def _plot_train_loader():
    spec = importlib.util.spec_from_file_location("plot_train", ROOT / "tools/plot_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load


def test_cli_train_main_on_the_cpu(tmp_path, capsys):
    import yaml

    from deepim_tpu_torch.cli import train as cli

    spec = _spec(train_iter=1, batch_size=2, log_every=2, checkpoint_every=2,
                 coarse_fraction=0.5, num_steps=100)
    spec.update(output_dir=str(tmp_path), experiment="tiny")
    spec["network"].update(coarse_height=24, coarse_width=32)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(spec))
    base = ["--cfg", str(path), "--device", "cpu"]
    assert cli.main(base + ["--num-steps", "4"]) == 0
    out_dir = tmp_path / "tiny"
    recs = _plot_train_loader()(str(out_dir / "train_log.jsonl"))
    assert [r["step"] for r in recs] == [2, 4]
    assert {"loss", "pm_loss_0", "flow_loss_0", "mask_loss_0", "rot_err_deg_0",
            "trans_err_0", "add_0", "grad_norm"} <= set(recs[0])
    assert "samples/s" in capsys.readouterr().out
    ckpt = str(out_dir / "checkpoints_torch")
    assert ckpt_t._steps(ckpt) == [2, 4]
    assert (out_dir / "config.yaml").exists()
    # --resume continues the run from its last checkpoint ...
    assert cli.main(base + ["--num-steps", "6", "--resume"]) == 0
    assert "resumed from step 4" in capsys.readouterr().out
    assert [json.loads(x)["step"] for x in (out_dir / "train_log.jsonl").read_text()
            .splitlines()] == [2, 4, 6]
    assert ckpt_t.latest_step(ckpt) == 6
    # ... and draws what an uninterrupted run draws: six steps straight.
    spec["experiment"] = "straight"
    path.write_text(yaml.safe_dump(spec))
    assert cli.main(base + ["--num-steps", "6"]) == 0
    a = ckpt_t.restore_checkpoint(ckpt)[1]
    b = ckpt_t.restore_checkpoint(str(tmp_path / "straight" / "checkpoints_torch"))[1]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # A fresh run clears the stale checkpoints.
    assert cli.main(base + ["--num-steps", "2"]) == 0
    assert ckpt_t._steps(str(tmp_path / "straight" / "checkpoints_torch")) == [2]
    assert cli.frac_hit(0.5, 0) is False and cli.frac_hit(0.5, 1) is True


def test_cli_train_refuses(tmp_path):
    import yaml

    from deepim_tpu_torch.cli import train as cli

    spec = _spec()
    spec.update(output_dir=str(tmp_path), experiment="refused")
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(spec))
    if not torch.cuda.is_available():  # the card is the default: no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--cfg", str(path)])
    spec["dataset"].update(name="lm6d", root=str(tmp_path / "no_root"))
    path.write_text(yaml.safe_dump(spec))
    with pytest.raises(FileNotFoundError, match="textured.ply"):
        cli.main(["--cfg", str(path), "--device", "cpu"])
    # A pretrained dir that holds only the reference's orbax steps.
    spec["dataset"]["name"] = "synthetic"
    (tmp_path / "orbax" / "1000").mkdir(parents=True)
    spec["train"]["pretrained"] = str(tmp_path / "orbax")
    path.write_text(yaml.safe_dump(spec))
    with pytest.raises(FileNotFoundError, match="import_flax_params"):
        cli.main(["--cfg", str(path), "--device", "cpu", "--num-steps", "1"])


def test_bridge_carries_a_trained_tree_for_resumed_training():
    # A JAX full tree (decoder included) -> port state_dict of the training
    # model -> back: exact, and it loads strictly into the training model.
    spec = _spec()
    cfg_j = config_from_dict_j(spec)
    params = jax.tree.map(np.asarray, train_j.init_state(
        cfg_j, train_j.make_model(cfg_j, 2), jax.random.PRNGKey(4)).params["params"])
    sd = flax_to_torch(params)
    model = train_t.make_model(config_from_dict(spec), 2)
    model.load_state_dict(sd)
    back = torch_to_flax(model.state_dict())
    for (path, a) in jax.tree_util.tree_flatten_with_path(params)[0]:
        b = back
        for key in path:
            b = b[key.key]
        np.testing.assert_array_equal(b, a, err_msg=str(path))
