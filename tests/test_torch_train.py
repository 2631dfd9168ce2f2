"""deepim_tpu_torch.train against deepim_tpu.train (float32, CPU).

- The learning-rate schedule against optax at every step of the warmup and
  one step either side of each boundary: exact to 1e-7.
- Three Adam and three SGD updates with weight decay and a clip that
  triggers, on given gradients, against the reference's optax chain:
  params within 1e-6.
- ``compute_losses`` and one train step on bridged weights (pose heads
  randomised so every layer matters), the batch made by the reference's
  ``synthetic_batch`` and fed to both, the reference rendering with its
  Pallas kernels in interpret mode: losses and metrics within rtol 1e-3,
  each parameter's gradient within 1e-3 of that leaf's max abs (a raster
  edge pixel can fall the other way, as in tests/test_torch_refine.py).
- ``train_iter=2`` runs two iterations and detaches the pose between
  them (the micro-overfit is tests/test_torch_overfit.py's).

The checkpoints and the driver are tests/test_torch_train_cli.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepim_tpu.config import config_from_dict as config_from_dict_j
from deepim_tpu.data import synthetic_batch as synthetic_batch_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine import build_assets as build_assets_j
from deepim_tpu.train import train as train_j
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import synthetic_batch
from deepim_tpu_torch.models.bridge import flax_to_torch
from deepim_tpu_torch.refine import build_assets
from deepim_tpu_torch.train import train as train_t

H, W = 48, 64
IMG = (64, 96)
K = np.array([[120.0, 0, 48.0], [0, 120.0, 32.0], [0, 0, 1]], np.float32)


def _spec(**train):
    return {
        "network": {"input_height": H, "input_width": W, "dtype": "float32",
                    "fc_dim": 32},
        "dataset": {"objects": ["box", "icosphere"], "image_height": IMG[0],
                    "image_width": IMG[1], "fx": 120.0, "fy": 120.0, "cx": 48.0,
                    "cy": 32.0, "num_points": 64},
        "train": {"batch_size": 4, "renderer": "pallas_interpret", "warmup_steps": 0,
                  "lr": 1e-3, **train},
    }


def _meshes():
    return [mesh_j.box_mesh((0.08, 0.1, 0.06)), mesh_j.icosphere_mesh(0.05, subdivisions=2)]


# --- schedule and optimizer ---------------------------------------------------


@pytest.mark.parametrize("warmup,bounds", [(50, (120, 300)), (0, (40, 40, 90))])
def test_lr_schedule_matches_optax(warmup, bounds):
    spec = _spec(warmup_steps=warmup, lr_decay_steps=list(bounds), lr=3e-4,
                 lr_decay_factor=0.1)
    ref = train_j.make_lr_schedule(config_from_dict_j(spec))
    got = train_t.make_lr_schedule(config_from_dict(spec))
    steps = set(range(warmup + 2))
    for b in bounds:  # decay boundaries count from the end of the warmup
        steps |= {warmup + b - 1, warmup + b, warmup + b + 1}
    for s in sorted(steps):
        assert abs(got(s) - float(ref(s))) <= 1e-7, s
    if warmup:
        assert got(0) == 0.0  # the first update runs at lr 0
    assert abs(got(warmup + max(bounds)) - 3e-4 * 0.1 ** len(set(bounds))) < 1e-12


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_matches_optax(optimizer):
    spec = _spec(optimizer=optimizer, weight_decay=5e-3, momentum=0.9, grad_clip=0.5,
                 warmup_steps=1, lr_decay_steps=[1], lr=1e-2, lr_decay_factor=0.5)
    cfg_j, cfg_t = config_from_dict_j(spec), config_from_dict(spec)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (1.0, 0.05, 2.0)]  # the first and last clip, the second not

    tx = train_j.make_optimizer(cfg_j)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    opt_j = tx.init(p_j)
    p_t = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    state = train_t.TrainState(0, None, train_t.make_optimizer(cfg_t, p_t))
    sched = train_t.make_lr_schedule(cfg_t)
    for g in grads:
        upd, opt_j = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for p, k in zip(p_t, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        norm = train_t.apply_gradients(state, cfg_t, sched)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for p, k in zip(p_t, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert state.step == 3
    assert not np.allclose(p_t[0].detach().numpy(), params["a"])  # the params moved


# --- losses and the train step against the reference -------------------------


def _reference_setup(spec, seed=0, batch=4):
    """Reference model, its params with randomised heads, assets and a batch
    rendered by the reference; the port's model on the bridged params."""
    cfg_j = config_from_dict_j(spec)
    assets_j = build_assets_j(_meshes(), num_points=64)
    model_j = train_j.make_model(cfg_j, assets_j.num_classes)
    state_j = train_j.init_state(cfg_j, model_j, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, state_j.params["params"])
    rng = np.random.RandomState(seed)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    b = synthetic_batch_j(jax.random.PRNGKey(seed + 1), assets_j, batch, jnp.asarray(K),
                          IMG, renderer="pallas_interpret")
    b = {k: np.array(v) for k, v in b.items()}
    cfg_t = config_from_dict(spec)
    model_t = train_t.make_model(cfg_t, 2)
    model_t.load_state_dict(flax_to_torch(params))
    return cfg_j, model_j, assets_j, params, b, cfg_t, model_t


def _close_metrics(got, ref, rtol=1e-3):
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("train", [
    {"train_iter": 2, "w_flow": 0.1, "w_mask": 0.1},
    {"pose_loss": "separate", "flow_occ_stride": 1},
])
def test_compute_losses_and_step_match_reference(train):
    spec = _spec(optimizer="adam", weight_decay=0.0, **train)
    cfg_j, model_j, assets_j, params, b, cfg_t, model_t = _reference_setup(spec)

    def loss_j(p):
        return train_j.compute_losses(p, model_j, assets_j, {k: jnp.asarray(v) for k, v
                                                             in b.items()}, cfg_j)

    (_, metrics_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        {"params": jax.tree.map(jnp.asarray, params)})
    assets_t = build_assets(_meshes(), num_points=64, device="cpu")
    batch_t = {k: torch.from_numpy(v) for k, v in b.items()}
    state = train_t.init_state(cfg_t, model_t)
    loss, metrics_t = train_t.compute_losses(model_t, assets_t, batch_t, cfg_t)
    _close_metrics(metrics_t, metrics_j)
    loss.backward()
    ref = flax_to_torch(jax.tree.map(np.asarray, grads_j["params"]))
    for name, p in model_t.named_parameters():
        scale = float(np.abs(ref[name].numpy()).max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-3 * scale + 1e-9, (name, err, scale)
    assert float(np.abs(ref["conv1.weight"].numpy()).max()) > 0  # the encoder learns

    # One full step: the same metrics plus the unclipped gradient norm.
    step = train_t.make_train_step(model_t, assets_t, cfg_t)
    state, metrics = step(state, batch_t)
    assert state.step == 1
    _close_metrics({k: v for k, v in metrics.items() if k != "grad_norm"}, metrics_j)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(grads_j)), rtol=1e-3)


def test_train_iter_two_detaches_between_iterations(monkeypatch):
    spec = _spec(train_iter=2)
    cfg = config_from_dict(spec)
    assets = build_assets(_meshes(), num_points=32, device="cpu")
    model = train_t.make_model(cfg, 2)
    batch = synthetic_batch(torch.Generator().manual_seed(0), assets, 4,
                            torch.from_numpy(K), IMG)
    seen = []
    real = train_t.build_network_inputs

    def spy(model, ab, obs, pose, *args, **kwargs):
        seen.append(pose)
        return real(model, ab, obs, pose, *args, **kwargs)

    monkeypatch.setattr(train_t, "build_network_inputs", spy)
    with torch.no_grad():
        for p in model.fc_trans.parameters():  # poses move between iterations
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    state = train_t.init_state(cfg, model)
    _, metrics = train_t.make_train_step(model, assets, cfg)(state, batch)
    assert len(seen) == 2 and not any(p.requires_grad for p in seen)
    assert not torch.equal(seen[0], seen[1])  # the second refines the updated pose
    assert {"pm_loss_1", "flow_loss_1", "mask_loss_1", "rot_err_deg_1"} <= set(metrics)
    assert all(torch.isfinite(v) and v.dim() == 0 for v in metrics.values())


def test_refine_runs_a_training_model_pose_only():
    """refine_poses with a training model (decoder and mask head) runs the
    pose-only forward: the decoder never runs, and the poses equal those of
    the pose-only build of the same weights."""
    from deepim_tpu_torch.refine import refine_poses

    cfg = config_from_dict(_spec())
    assets = build_assets(_meshes(), num_points=32, device="cpu")
    full = train_t.make_model(cfg, 2, generator=torch.Generator().manual_seed(0))
    pose_only = train_t.make_model(cfg, 2, inference=True,
                                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in full.fc_trans.parameters():  # poses move
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    pose_only.load_state_dict({k: v for k, v in full.state_dict().items()
                               if k in pose_only.state_dict()})
    ran, decode = [], full._decode
    full._decode = lambda *a: ran.append(1) or decode(*a)
    batch = synthetic_batch(torch.Generator().manual_seed(0), assets, 4,
                            torch.from_numpy(K), IMG)
    args = (assets, batch["obs_rgb"], batch["pose_src"], batch["k"], batch["class_idx"])
    got = refine_poses(full, *args, num_iters=2, out_size=(H, W))
    want = refine_poses(pose_only, *args, num_iters=2, out_size=(H, W))
    assert ran == []
    assert (got - batch["pose_src"]).abs().max() > 1e-4
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_synthetic_step_and_make_model_variants():
    from deepim_tpu_torch.raster.camera import make_intrinsics

    for name in ("synthetic", "synthetic_occlusion"):
        spec = _spec(train_iter=1, batch_size=2)
        spec["dataset"]["name"] = name
        spec["network"]["pose_head"] = "gap"
        cfg = config_from_dict(spec)
        assets = build_assets(_meshes(), num_points=32, device="cpu")
        model = train_t.make_model(cfg, 2)
        assert model.fc1.in_features == 1024 and model.with_flow and model.with_mask
        state = train_t.init_state(cfg, model)
        k = make_intrinsics(120.0, 120.0, 48.0, 32.0, device="cpu")
        step = train_t.make_synthetic_train_step(model, assets, cfg, k)
        state, metrics = step(state, torch.Generator().manual_seed(0))
        assert state.step == 1 and torch.isfinite(metrics["loss"])
        assert {"grad_norm", "flow_loss_0", "mask_loss_0"} <= set(metrics)
        with pytest.raises(ValueError):  # a step is bound to its model
            step(train_t.init_state(cfg, train_t.make_model(cfg, 2)),
                 torch.Generator().manual_seed(0))
    pose_only = train_t.make_model(cfg, 2, inference=True)
    assert not (pose_only.with_flow or pose_only.with_mask)
    assert set(pose_only.state_dict()) < set(model.state_dict())
