"""deepim_tpu_torch.parallel against deepim_tpu.parallel (CPU, gloo ranks).

The port's ranks are processes (``parallel.spawn``, at most 4), running
tests/_torch_parallel_worker.py at the tiny shapes of tests/test_torch_train.py
(48x64 crops of 64x96 frames, fc_dim 32, float32, a batch of 4; SGD at
lr 1 with no clip, so a step's update is its gradient; the reference's
step runs at lr 1e6, so its update over 1e6 is its gradient).

- The helpers: ``process_local_batch_size`` at world 1 and 2, ``make_mesh``
  over-subscribed raises, ``TrainBatcher(num_shards=2, shard_index=i)``
  record for record the reference's, and an empty shard's error.
- The DP step on 2 ranks against the reference's ``shard_map`` DP step
  (``make_train_step(mesh=make_mesh(n_data=2))`` on 2 of the 8 virtual CPU
  devices) on the same batch and bridged weights: metrics within rtol
  1e-3, gradients within 1e-3 of each leaf's max abs; the ranks' params
  bitwise equal after the step.
- The DP step against the port's own single-process step, and the (1, 2)
  and (2, 2) TP steps against it (the tolerances of tests/test_train.py
  §test_sharded_step_matches_single and §test_gspmd_tp_step_matches_single:
  rtol 2e-4, atol 2e-6 on the updated params; loss rtol 1e-5); fc1's shard
  holds half the weight.
- The Megatron backward: under a (1, 2) mesh fc1's input gradient is the
  unsharded one (an all-reduce in fc2's backward would double it).
- The synthetic DP step draws B/2 a rank and the ranks' draws differ; with
  one data rank the draws are the step's without a mesh, bit for bit.
- Checkpoints: rank 0 alone writes, every rank restores the saved params.
- ``cli.train --device cpu --n-devices 2`` for 3 steps, then ``--resume``
  to 4, and ``cli.test --n-devices 2`` with and without ``--hypotheses
  4``, run in the two ranks' group (as under torchrun): its table and
  saved poses equal one process's; the dry run's three parts give their
  OK lines on the two ranks.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import _torch_parallel_worker as wk
from deepim_tpu.config import config_from_dict as config_from_dict_j
from deepim_tpu.data import lm6d as lm6d_j
from deepim_tpu.data import synthetic_batch as synthetic_batch_j
from deepim_tpu.data.toolkit import gen_procedural_dataset as gen_j
from deepim_tpu.parallel import make_mesh as make_mesh_j
from deepim_tpu.parallel import process_local_batch_size as plbs_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine import build_assets as build_assets_j
from deepim_tpu.train import train as train_j
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.models.bridge import flax_to_torch
from deepim_tpu_torch.parallel import make_mesh, process_local_batch_size, spawn
from deepim_tpu_torch.train import train as train_t

H, W = 48, 64
IMG = (64, 96)
K = np.array([[120.0, 0, 48.0], [0, 120.0, 32.0], [0, 0, 1]], np.float32)
SPEC = {
    "network": {"input_height": H, "input_width": W, "dtype": "float32", "fc_dim": 32},
    "dataset": {"objects": ["box", "icosphere"], "image_height": IMG[0],
                "image_width": IMG[1], "fx": 120.0, "fy": 120.0, "cx": 48.0, "cy": 32.0,
                "num_points": 64},
    "train": {"batch_size": 4, "renderer": "xla", "warmup_steps": 0, "optimizer": "sgd",
              "momentum": 0.0, "lr": 1.0, "weight_decay": 0.0, "grad_clip": 1e9,
              "train_iter": 2, "w_flow": 0.1, "w_mask": 0.1},
}
REF_LR = 1e6


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The reference's weights (pose heads randomised), a batch it
    rendered, and its DP step's metrics and gradients, saved for the
    ranks."""
    cfg_j = config_from_dict_j(SPEC)
    assets_j = build_assets_j([mesh_j.box_mesh((0.08, 0.1, 0.06)),
                               mesh_j.icosphere_mesh(0.05, subdivisions=2)], num_points=64)
    model_j = train_j.make_model(cfg_j, assets_j.num_classes)
    state_j = train_j.init_state(cfg_j, model_j, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state_j.params["params"])
    rng = np.random.RandomState(0)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    batch = synthetic_batch_j(jax.random.PRNGKey(1), assets_j, 4, jnp.asarray(K), IMG,
                              renderer="xla")
    batch = {k: np.array(v) for k, v in batch.items()}

    # The reference's shard_map DP step on 2 of the 8 virtual devices, at
    # lr REF_LR: the update dwarfs every parameter, so update / REF_LR is
    # the gradient to float32's precision (at lr 1 a leaf whose gradient is
    # far below its weights would lose its low bits to the subtraction).
    cfg_lr = config_from_dict_j({**SPEC, "train": {**SPEC["train"], "lr": REF_LR}})
    step_j = train_j.make_train_step(model_j, assets_j, cfg_lr, mesh=make_mesh_j(n_data=2))
    state = state_j._replace(params={"params": jax.tree.map(jnp.asarray, params)})
    new, metrics = step_j(state, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = jax.tree.map(
        lambda a, b: ((a.astype(np.float64) - np.asarray(b)) / REF_LR).astype(np.float32),
        params, new.params["params"])
    saved = {"spec": SPEC, "params": flax_to_torch(params), "batch": batch, "k": K,
             "ref_grads": flax_to_torch(grads)}
    path = str(tmp_path_factory.mktemp("parallel") / "case.pt")
    torch.save(saved, path)
    return {"path": path, "ref_metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """A tiny synthetic experiment's YAML for the drivers."""
    d = tmp_path_factory.mktemp("cli")
    (d / "dp.yaml").write_text(yaml.safe_dump(_cli_spec(d)))
    return d


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """A tiny synthetic experiment's YAML for ``cli.test``, with a
    checkpoint whose pose heads are randomised (so refinement moves)."""
    from deepim_tpu_torch.train import checkpoint as ckpt

    d = tmp_path_factory.mktemp("eval")
    spec = _cli_spec(d)
    (d / "dp.yaml").write_text(yaml.safe_dump(spec))
    cfg = config_from_dict(spec)
    model = train_t.make_model(cfg, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in (*model.fc_rot.parameters(), *model.fc_trans.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
    ckpt.save_checkpoint(ckpt.checkpoint_dir(cfg), 3, model.state_dict())
    return d


@pytest.fixture(scope="module")
def world2(case, cli_dir, eval_dir, tmp_path_factory):
    """The two-rank program's results, in rank order."""
    return spawn(wk.world2, 2, "cpu", case["path"], str(tmp_path_factory.mktemp("ckpt")),
                 str(cli_dir / "dp.yaml"), str(eval_dir / "dp.yaml"),
                 str(eval_dir / "out" / "dp"))


@pytest.fixture(scope="module")
def world4(case):
    """The (2, 2) TP step's results, in rank order."""
    return spawn(wk.world4, 4, "cpu", case["path"])


def _within(excess: dict):
    """Every leaf within the step tolerances (``_torch_parallel_worker.excess``)."""
    bad = {k: v for k, v in excess.items() if v > 0}
    assert not bad, bad


# -- the helpers ---------------------------------------------------------------


def test_local_batch_size_and_mesh_errors(world2):
    assert process_local_batch_size(8) == plbs_j(8) == 8  # one process
    assert [r["local_batch"] for r in world2] == [4, 4]
    assert all("mesh 2x2 exceeds 2 ranks" in r["oversubscribed"] for r in world2)
    mesh = make_mesh()  # one process: the trivial mesh
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    with pytest.raises(ValueError, match="mesh 1x2 exceeds 1 ranks"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh_j(n_data=9)


def test_train_batcher_shards_match_reference(tmp_path):
    objects = ["box", "icosphere"]
    k = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]], np.float32)
    root = gen_j(str(tmp_path / "lm6d"), objects, k, (24, 32), frames_per_obj=5, seed=0).root
    dt, dj = lm6d_t.LM6DDataset(root, objects), lm6d_j.LM6DDataset(root, objects)
    seen = []
    for i in range(2):
        bt = lm6d_t.TrainBatcher(dt, objects, 2, seed=3, num_shards=2, shard_index=i,
                                 pin_memory=False)
        bj = lm6d_j.TrainBatcher(dj, objects, 2, seed=3, num_shards=2, shard_index=i)
        assert [(r.scene, r.frame, r.obj) for r in bt.records] == \
               [(r.scene, r.frame, r.obj) for r in bj.records]
        for _ in range(3):
            got, want = lm6d_t.to_device(bt.next(), "cpu"), bj.next()
            np.testing.assert_array_equal(got["pose_tgt"].numpy(), want["pose_tgt"])
            np.testing.assert_array_equal(got["obs_rgb"].numpy(), want["obs_rgb"])
        seen += [(r.scene, r.frame, r.obj) for r in bt.records]
    everything = lm6d_t.TrainBatcher(dt, objects, 2, pin_memory=False).records
    assert sorted(seen) == sorted((r.scene, r.frame, r.obj) for r in everything)
    n = len(everything)
    for mod in (lm6d_t, lm6d_j):
        ds = dt if mod is lm6d_t else dj
        with pytest.raises(ValueError, match=f"no 'train' records .* for shard {n}/{n + 1}"):
            mod.TrainBatcher(ds, objects, 2, num_shards=n + 1, shard_index=n)


# -- the train steps -------------------------------------------------------------


def test_dp_step_matches_reference_dp_step(case, world2):
    ref = case["ref_metrics"]
    for r in world2:
        got = r["dp_metrics"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-6, err_msg=k)
    for name, (err, scale) in world2[0]["dp_vs_reference"].items():
        assert err <= 1e-3 * scale + 1e-9, (name, err, scale)
    assert world2[0]["dp_vs_reference"]["conv1.weight"][1] > 0  # the encoder learns
    assert world2[0]["dp_digest"] == world2[1]["dp_digest"]  # the ranks agree bit for bit


def test_dp_step_matches_single_step(world2):
    np.testing.assert_allclose(world2[0]["dp_metrics"]["loss"],
                               world2[0]["single_metrics"]["loss"], rtol=1e-5)
    _within(world2[0]["dp_vs_single"])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_step_matches_single_step(world2, world4, world):
    ranks = world2 if world == 2 else world4
    single = ranks[0]["single_metrics"]
    for r in ranks:
        np.testing.assert_allclose(r["tp_metrics"]["loss"], single["loss"], rtol=1e-5)
        assert r["tp_shard_fraction"] == 0.5  # fc1's shard is half the weight
    _within(ranks[0]["tp_vs_single"])
    if world == 4:  # the data ranks of a model index hold the same shard
        by_index = {}
        for r in ranks:
            by_index.setdefault(r["tp_index"][1], set()).add(r["fc1_digest"])
        assert sorted(len(v) for v in by_index.values()) == [1, 1]


def test_megatron_backward_keeps_fc1_input_gradient(world2):
    want = world2[0]["single_fc1_grads"]
    assert len(want) == SPEC["train"]["train_iter"]
    for r in world2:
        assert r["tp_column_parallel"]
        got = r["tp_fc1_input_grads"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            scale = float(np.abs(w).max())
            assert scale > 0
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale)


def test_synthetic_dp_step_draws_half_a_rank(world2):
    (a,), (b,) = (r["draws"] for r in world2)
    half = SPEC["train"]["batch_size"] // 2
    assert a["pose_tgt"].shape[0] == b["pose_tgt"].shape[0] == half
    assert not np.array_equal(a["pose_tgt"], b["pose_tgt"])
    assert not np.array_equal(a["obs_rgb"], b["obs_rgb"])

    # One data rank (one process here): the draws of the step without a mesh.
    from deepim_tpu_torch.data import synthetic as syn

    cfg = config_from_dict(SPEC)
    draws = {}
    for name, mesh in (("none", None), ("mesh", make_mesh())):
        net = torch.nn.Linear(1, 1)  # the draw comes before the model runs
        draws[name] = wk.drawn_batch(syn, lambda: (train_t.make_synthetic_train_step(
            net, wk.assets("cpu"), cfg, torch.from_numpy(K), mesh=mesh),
            train_t.init_state(cfg, net)), torch.Generator().manual_seed(5))
    direct = syn.synthetic_batch(torch.Generator().manual_seed(5), wk.assets("cpu"), 4,
                                 torch.from_numpy(K), IMG)
    for k in ("pose_tgt", "pose_src", "obs_rgb", "obs_depth", "class_idx"):
        assert torch.equal(draws["none"][k], draws["mesh"][k]), k
        assert torch.equal(draws["none"][k], direct[k]), k


def test_checkpoint_rank0_writes_every_rank_restores(world2):
    assert len(world2[0]["writes"]) == 1 and world2[1]["writes"] == []
    for r in world2:
        assert r["restored_step"] == 7 and r["restored_digest"] == r["saved_digest"]
    assert world2[0]["saved_digest"] == world2[1]["saved_digest"]


# -- the drivers ------------------------------------------------------------------


def _cli_spec(tmp_path, **train):
    return {
        "experiment": "dp",
        "output_dir": str(tmp_path / "out"),
        "network": {"input_height": H, "input_width": W, "dtype": "float32", "fc_dim": 32,
                    "with_flow": False, "with_mask": False},
        "dataset": {"name": "synthetic", "objects": ["box", "icosphere"],
                    "image_height": 48, "image_width": 96, "fx": 90.0, "fy": 90.0,
                    "cx": 48.0, "cy": 24.0, "num_points": 64},
        "train": {"batch_size": 4, "num_steps": 3, "optimizer": "adam", "lr": 1e-4,
                  "log_every": 1, "checkpoint_every": 100, "warmup_steps": 0,
                  "w_flow": 0.0, "w_mask": 0.0, **train},
        "test": {"test_iter": 2, "batch_size": 4},
    }


def test_cli_train_two_ranks_then_resume(world2, cli_dir):
    from deepim_tpu_torch.train import checkpoint as ckpt

    lead, other = world2
    assert lead["train_rc"] == other["train_rc"] == lead["resume_rc"] == 0
    assert "devices: 2 (cpu); mesh={'data': 2, 'model': 1}" in lead["train_out"]
    assert "backend gloo" in lead["train_out"]
    assert "resumed from step 3" in lead["resume_out"]
    assert other["train_out"] == other["resume_out"] == ""  # rank 0 alone prints
    exp = cli_dir / "out" / "dp"
    steps = [json.loads(ln)["step"]
             for ln in (exp / "train_log.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4]  # one writer
    assert sorted(os.listdir(exp / "checkpoints_torch")) == ["step_00000003.pt",
                                                             "step_00000004.pt"]
    assert ckpt.latest_step(str(exp / "checkpoints_torch")) == 4


@pytest.mark.parametrize("hypotheses", [1, 4])
def test_cli_test_two_ranks_equals_one_process(world2, eval_dir, hypotheses):
    from deepim_tpu_torch.cli import test as cli_test

    lead, other = (r[f"eval{hypotheses}"] for r in world2)
    assert lead["rc"] == other["rc"] == 0
    assert "eval data-parallel over 2 ranks (2 rows of each batch of 4 a rank)" in lead["out"]
    assert other["out"] == "" and other["files"] is None  # rank 0 alone writes
    # One process on the same experiment (the ranks' files were read above).
    assert cli_test.main(["--cfg", str(eval_dir / "dp.yaml"), *wk.EVAL_ARGV,
                          "--n-devices", "1", "--hypotheses", str(hypotheses)]) == 0
    (table1, poses1), (table2, poses2) = (wk.eval_outputs(str(eval_dir / "out" / "dp")),
                                          lead["files"])
    assert table1 == table2
    assert poses1["traj"].shape[0] == (2 if hypotheses > 1 else 3)
    assert not np.array_equal(poses1["traj"][-1], poses1["traj"][0])  # refinement moved
    np.testing.assert_allclose(poses2["traj"], poses1["traj"], rtol=0, atol=1e-5)
    for k in ("pose_gt", "class_idx", "k"):
        np.testing.assert_array_equal(poses2[k], poses1[k])


def test_rank_rows_get_one_process_hypotheses(monkeypatch):
    """``cli.test``'s data rank i of 2 refines its rows of each whole batch
    from the hypotheses one process draws for them (the selection is
    recorded, not run)."""
    import types

    import deepim_tpu_torch.refine as refine
    from deepim_tpu_torch.cli import test as cli_test

    seen = []

    def select(model, assets, obs, hyps, *args):
        seen.append(hyps.clone())
        return hyps[:obs.shape[0]], None

    monkeypatch.setattr(refine, "select_hypotheses", select)
    gen = torch.Generator().manual_seed(0)
    batches = [{"obs_rgb": torch.rand(4, 8, 8, 3, generator=gen),
                "pose_src": torch.randn(4, 3, 4, generator=gen),
                "pose_tgt": torch.randn(4, 3, 4, generator=gen),
                "class_idx": torch.arange(4) % 2} for _ in range(2)]
    assets = types.SimpleNamespace(points=torch.zeros(1))
    drawn = {}
    for rows in ((0, 1), (0, 2), (1, 2)):
        seen.clear()
        out = cli_test.refine_batches(None, assets, batches, torch.eye(3), 2, (8, 8),
                                      hypotheses=3, rank_rows=rows)
        drawn[rows] = [h.view(3, -1, 3, 4) for h in seen]
        i, n = rows
        want = torch.cat([b["pose_src"][i * 4 // n:(i + 1) * 4 // n] for b in batches])
        assert torch.equal(out["traj"][0], want)
    for whole, half0, half1 in zip(drawn[0, 1], drawn[0, 2], drawn[1, 2]):
        assert torch.equal(torch.cat([half0, half1], dim=1), whole)
    assert not torch.equal(drawn[0, 1][0], drawn[0, 1][1])  # batches draw apart


def test_dryrun_multichip_parts_on_two_ranks(world2):
    # dryrun_multichip.main spawns these ranks and prints rank 0's lines.
    lines = world2[0]["dryrun"]
    assert [ln.split(":")[0] for ln in lines] == ["dryrun_multichip(2) DP",
                                                 "dryrun_multichip(2) DP+TP",
                                                 "dryrun_multichip(2) DP eval"]
    assert all(": OK " in ln and ln.endswith("backend=gloo") for ln in lines)
