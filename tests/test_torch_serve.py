"""deepim_tpu_torch.serve.PoseRefinerService on the CPU, and against
deepim_tpu's service.

The cases of tests/test_serve.py on the port (its int8_static case
included: the service calibrates before the first request, and every
result equals a direct ``refine_poses`` of the calibrated model), the card
default, the torch checkpoint format, and parity: a JAX train state with
randomised pose heads, saved by the reference's orbax checkpointing, read
back as numpy and imported with ``import_flax_params``, gives both
services the same weights; the same requests then give the same poses
(atol 1e-3, the trajectory tolerance of tests/test_torch_refine.py: a
pixel on a triangle edge can fall the other way in the two rasterizers).
"""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import synthetic_batch
from deepim_tpu_torch.refine import refine_poses
from deepim_tpu_torch.serve import PoseRefinerService
from deepim_tpu_torch.train import checkpoint as ckpt_t

H, W = 64, 128
K = np.array([[120.0, 0, 64], [0, 120.0, 32], [0, 0, 1]], np.float32)


def _cfg(tmp, name="serve_test", objects=("box", "icosphere"), **network):
    return {
        "experiment": name,
        "output_dir": str(tmp),
        "network": {"input_height": H, "input_width": W, "dtype": "float32",
                    "fc_dim": 32, "with_flow": False, "with_mask": False, **network},
        "dataset": {"name": "synthetic", "objects": list(objects),
                    "image_height": H, "image_width": W,
                    "fx": 120.0, "fy": 120.0, "cx": 64.0, "cy": 32.0, "num_points": 64},
        "test": {"test_iter": 1, "batch_size": 4, "renderer": "pallas_interpret"},
    }


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    svc = PoseRefinerService(config_from_dict(_cfg(tmp_path_factory.mktemp("serve"))),
                             load_checkpoint=False, gather_window_s=0.05, device="cpu")
    yield svc
    svc.close()


def _requests(svc, n, seed):
    g = torch.Generator().manual_seed(seed)
    b = synthetic_batch(g, svc.assets, n, torch.from_numpy(K), (H, W))
    ks = np.tile(K[None], (n, 1, 1))
    return (b["obs_rgb"].numpy(), b["pose_src"].numpy(), ks,
            b["class_idx"].numpy().astype(np.int32), b["pose_tgt"].numpy())


def _direct(svc, obs, init, ks, cls, **kwargs):
    return refine_poses(svc.model, svc.assets, *(torch.from_numpy(a) for a in (obs, init, ks, cls)),
                        num_iters=svc.num_iters, out_size=(H, W), **kwargs).numpy()


def test_refine_shapes_and_padding(service):
    obs, init, ks, cls, _ = _requests(service, 3, 0)  # n < batch: pads
    out = service.refine(obs, init, ks, cls)
    assert out.shape == (3, 3, 4)
    assert np.isfinite(out).all()
    assert service.stats.padded_slots >= 1


def test_refine_chunks_oversized_request(service):
    obs, init, ks, cls, _ = _requests(service, 6, 1)  # n > batch: 2 batches
    before = service.stats.device_batches
    out = service.refine(obs, init, ks, cls)
    assert out.shape == (6, 3, 4)
    assert service.stats.device_batches - before >= 2
    assert service.stats.host_seconds > 0 and service.stats.refine_seconds > 0


def test_refine_matches_direct_call(service):
    obs, init, ks, cls, _ = _requests(service, 4, 2)
    out = service.refine(obs, init, ks, cls)
    np.testing.assert_allclose(out, _direct(service, obs, init, ks, cls), atol=1e-5)


def test_concurrent_callers_coalesce(service):
    """4 threads x 1 pose: the worker coalesces them into shared device
    batches and every caller gets its own correct result."""
    obs, init, ks, cls, _ = _requests(service, 4, 3)
    results = [None] * 4
    errs = []

    def call(i):
        try:
            results[i] = service.refine(obs[i:i + 1], init[i:i + 1], ks[i:i + 1],
                                        cls[i:i + 1])[0]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads)
    direct = _direct(service, obs, init, ks, cls)
    for i in range(4):
        np.testing.assert_allclose(results[i], direct[i], atol=1e-5)


def test_rejects_wrong_image_size(service):
    obs = np.zeros((1, H + 2, W, 3), np.float32)
    with pytest.raises(ValueError):
        service.refine(obs, np.zeros((1, 3, 4)), np.zeros((1, 3, 3)),
                       np.zeros((1,), np.int32))


def test_empty_request(service):
    out = service.refine(np.zeros((0, H, W, 3)), np.zeros((0, 3, 4)),
                         np.zeros((0, 3, 3)), np.zeros((0,), np.int32))
    assert out.shape == (0, 3, 4)


def test_close_fails_pending_and_rejects_new_requests(tmp_path):
    svc = PoseRefinerService(config_from_dict(_cfg(tmp_path, "serve_close_test", ("box",))),
                             load_checkpoint=False, device="cpu")
    svc.close()
    with pytest.raises(RuntimeError):
        svc.refine(np.zeros((1, H, W, 3)), np.zeros((1, 3, 4)), np.zeros((1, 3, 3)),
                   np.zeros((1,), np.int32))
    # An item stranded in the queue (the worker has exited) is failed by
    # the close-time drain rather than left to deadlock its caller.
    f: Future = Future()
    svc._queue.put((np.zeros((H, W, 3), np.float32), np.zeros((3, 4), np.float32),
                    np.zeros((3, 3), np.float32), np.int32(0), None, None, f))
    svc.close()
    assert isinstance(f.exception(timeout=1), RuntimeError)


def test_batch_error_reaches_every_caller(tmp_path):
    svc = PoseRefinerService(config_from_dict(_cfg(tmp_path, "serve_error_test")),
                             load_checkpoint=False, gather_window_s=0.2, device="cpu")
    try:
        obs, init, ks, cls, _ = _requests(svc, 3, 4)
        cls[1] = 7  # no such class: the batch's gather fails
        with pytest.raises(IndexError):
            svc.refine(obs, init, ks, cls)
        cls[1] = 0  # the worker survives and serves the next request
        assert svc.refine(obs, init, ks, cls).shape == (3, 3, 4)
    finally:
        svc.close()


def test_input_depth_model_requires_and_uses_obs_depth(tmp_path):
    svc = PoseRefinerService(config_from_dict(_cfg(tmp_path, "serve_depth_test",
                                                   input_depth=True)),
                             load_checkpoint=False, device="cpu")
    try:
        obs, init, ks, cls, _ = _requests(svc, 2, 5)
        with pytest.raises(ValueError, match="obs_depth"):
            svc.refine(obs, init, ks, cls)
        depth = np.full((2, H, W), 0.8, np.float32)
        out = svc.refine(obs, init, ks, cls, obs_depth=depth)
        np.testing.assert_allclose(
            out, _direct(svc, obs, init, ks, cls, obs_depth=torch.from_numpy(depth)), atol=1e-5)
    finally:
        svc.close()


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_int8_service_is_not_ported(tmp_path, quant):
    """The int8 modes serve (the test keeps its name from before int8 was
    ported): int8_static calibrates at construction, on two synthetic
    batches from generators seeded 4200 and 4201, and each result equals
    the direct call of the calibrated model."""
    from deepim_tpu_torch.data.synthetic import synthetic_batch
    from deepim_tpu_torch.models.quant import calibrate_model

    cfg = config_from_dict(_cfg(tmp_path, "serve_test_q", quant=quant))
    svc = PoseRefinerService(cfg, load_checkpoint=False, gather_window_s=0.05, device="cpu")
    try:
        assert svc.model.quant == "int8"
        assert bool(svc.model.act_scales) == (quant == "int8_static")
        if quant == "int8_static":
            k = torch.from_numpy(K)
            calib = [synthetic_batch(torch.Generator().manual_seed(4200 + i), svc.assets, 4, k,
                                     (H, W)) for i in range(2)]
            want = calibrate_model(svc.model.with_act_scales(()), svc.assets, calib, k, (H, W),
                                   num_iters=1, mode="max_c")
            assert want.act_scales == svc.model.act_scales
        obs, init, ks, cls, _ = _requests(svc, 3, seed=9)
        out = svc.refine(obs, init, ks, cls)
        assert out.shape == (3, 3, 4) and np.isfinite(out).all()
        np.testing.assert_allclose(out, _direct(svc, obs, init, ks, cls), rtol=0, atol=1e-6)
    finally:
        svc.close()


def test_int8_static_service_takes_calibration_batches(tmp_path):
    cfg = config_from_dict(_cfg(tmp_path, "serve_test_qb", quant="int8_static"))
    g = torch.Generator().manual_seed(3)
    calib = [synthetic_batch(g, _plain_assets(cfg), 4, torch.from_numpy(K), (H, W))]
    svc = PoseRefinerService(cfg, load_checkpoint=False, device="cpu",
                             calibration_batches=calib, calibration_mode="max")
    try:
        assert all(isinstance(v, float) for _, v in svc.model.act_scales)  # scalar mode
    finally:
        svc.close()
    with pytest.raises(ValueError, match="mode"):
        PoseRefinerService(cfg, load_checkpoint=False, device="cpu", calibration_mode="maxc")


def _plain_assets(cfg):
    from deepim_tpu_torch.cli.train import load_assets_and_names

    return load_assets_and_names(cfg, device="cpu")[0]


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseRefinerService(config_from_dict(_cfg(tmp_path)), load_checkpoint=False)


def _random_params(seed=0, scale=0.02):
    """A random flax params tree of the serving config (numpy), pose heads
    randomised."""
    import jax

    from deepim_tpu.models import flownet as fn_j

    mj = fn_j.DeepIMFlowNet(num_classes=2, fc_dim=32, with_flow=False, with_mask=False,
                            head_grid=fn_j.bottleneck_grid(H, W))
    var = mj.init(jax.random.PRNGKey(seed), np.zeros((1, H, W, 6), np.float32))
    params = jax.tree.map(np.asarray, var["params"])
    rng = np.random.RandomState(seed)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    return params


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    from deepim_tpu_torch.models.bridge import flax_to_torch

    sd = flax_to_torch(_random_params())
    d = str(tmp_path / "ckpt")
    assert ckpt_t.latest_step(d) is None
    for step in (3, 10, 7, 12):
        ckpt_t.save_checkpoint(d, step, sd, max_to_keep=3)
    assert ckpt_t.latest_step(d) == 12
    assert ckpt_t._steps(d) == [7, 10, 12]  # the oldest went
    step, got = ckpt_t.restore_checkpoint(d)
    assert step == 12 and list(got) == list(sd)
    for k in sd:
        assert got[k].dtype == sd[k].dtype and torch.equal(got[k], sd[k]), k
    assert ckpt_t.restore_checkpoint(d, step=7)[0] == 7
    ckpt_t.clear_checkpoints(d)
    with pytest.raises(FileNotFoundError):
        ckpt_t.restore_checkpoint(d)


def test_service_matches_reference_service(tmp_path):
    import jax
    import jax.numpy as jnp

    from deepim_tpu.config import config_from_dict as config_from_dict_j
    from deepim_tpu.serve import PoseRefinerService as ServiceJ
    from deepim_tpu.train import checkpoint as ckpt_j
    from deepim_tpu.train import init_state, make_model

    spec = _cfg(tmp_path, "serve_parity")
    spec["test"]["test_iter"] = 2
    cfg_j = config_from_dict_j(spec)
    # A reference train state with random pose heads, through orbax.
    state = init_state(cfg_j, make_model(cfg_j, 2), jax.random.PRNGKey(0))
    params = _random_params()
    state = state._replace(step=jnp.asarray(9, jnp.int32),
                           params={"params": jax.tree.map(jnp.asarray, params)})
    orbax_dir = f"{tmp_path}/serve_parity/checkpoints"
    ckpt_j.save_checkpoint(orbax_dir, state)
    raw = jax.tree.map(np.asarray, ckpt_j.restore_params_raw(orbax_dir))["params"]
    cfg_t = config_from_dict(spec)
    ckpt_t.import_flax_params(ckpt_t.checkpoint_dir(cfg_t), raw, step=9)

    svc_t = PoseRefinerService(cfg_t, device="cpu", gather_window_s=0.05)
    svc_j = ServiceJ(cfg_j, gather_window_s=0.05)
    try:
        assert svc_t.step == svc_j.step == 9
        obs, init, ks, cls, _ = _requests(svc_t, 6, 6)
        out_t = svc_t.refine(obs, init, ks, cls)
        out_j = svc_j.refine(obs, init, ks, cls)
    finally:
        svc_t.close()
        svc_j.close()
    moved = np.abs(out_j - init).max()
    assert moved > 1e-2, moved  # the randomised heads move the poses
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-3)
    assert svc_t.stats.device_batches == svc_j.stats.device_batches == 2


def test_refuses_to_serve_initial_weights_beside_orbax_steps(tmp_path):
    """An experiment the reference trained has orbax steps under
    checkpoints/ (directories with all-digit names); with no port
    checkpoint the service raises, naming import_flax_params, where it
    used to serve the initial weights."""
    spec = _cfg(tmp_path, "orbax_only")
    orbax = tmp_path / "orbax_only" / "checkpoints"
    (orbax / "2000").mkdir(parents=True)
    (orbax / "2000" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="import_flax_params") as err:
        PoseRefinerService(config_from_dict(spec), device="cpu")
    assert str(orbax) in str(err.value) and "checkpoints_torch" in str(err.value)
    # Asked not to load, it serves its initial weights as before.
    PoseRefinerService(config_from_dict(spec), device="cpu", load_checkpoint=False).close()
    # With neither directory: the seed-0 weights at step 0, as before.
    fresh = PoseRefinerService(config_from_dict(_cfg(tmp_path, "nothing")), device="cpu")
    try:
        assert fresh.step == 0
    finally:
        fresh.close()
    # Once imported, the port checkpoint serves.
    from deepim_tpu_torch.models.bridge import flax_to_torch

    cfg = config_from_dict(spec)
    ckpt_t.save_checkpoint(ckpt_t.checkpoint_dir(cfg), 2000, flax_to_torch(_random_params()))
    svc = PoseRefinerService(cfg, device="cpu")
    try:
        assert svc.step == 2000
    finally:
        svc.close()
