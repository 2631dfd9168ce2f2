"""Rank programs of tests/test_torch_parallel.py, run on CPU gloo ranks by
``deepim_tpu_torch.parallel.spawn``.  Each reads the case the test saved
(a config spec, bridged weights, a batch, the reference's gradients), runs
on its rank and returns small things: numbers, digests, per-leaf errors
(rank 0 runs the single-process step itself to compare with), so no rank
writes a model back.  No jax here: the ranks import the port only."""

import contextlib
import copy
import functools
import hashlib
import io
import json

import torch
import torch.distributed as dist

from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.parallel import (
    make_mesh, process_local_batch_size, shard_batch, shard_params_for_tp)
from deepim_tpu_torch.parallel.mesh import MODEL_AXIS, ColumnParallelLinear
from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
from deepim_tpu_torch.refine import build_assets
from deepim_tpu_torch.train import train as train_t

# The tolerances of tests/test_train.py §test_sharded_step_matches_single
# and §test_gspmd_tp_step_matches_single on the updated parameters.
RTOL, ATOL = 2e-4, 2e-6


@functools.cache
def assets(dev):
    return build_assets([box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05, subdivisions=2)],
                        num_points=64, device=dev)


def load_case(path: str) -> dict:
    return torch.load(path, mmap=True, weights_only=False)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for v in tensors:
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


_TEMPLATES: dict = {}


def new_model(spec: dict, params=None):
    """A fresh training model of ``spec`` (with ``params``): a copy of one
    built once a process (the initialisation takes seconds on the CPU)."""
    key = json.dumps(spec, sort_keys=True)
    if key not in _TEMPLATES:
        _TEMPLATES[key] = train_t.make_model(config_from_dict(spec), 2)
    model = copy.deepcopy(_TEMPLATES[key])
    if params is not None:
        model.load_state_dict(params)
    return model


def fc1_input_grads(model, store: list) -> None:
    """Keep the gradient of every input fc1 gets (one an iteration), as
    the model's ``_linear`` hands it over (before a shard's collective)."""
    real = model._linear

    def linear(lin, x):
        if lin is model.fc1 and x.requires_grad:
            x.register_hook(lambda g: store.append(g.detach().numpy().copy()))
        return real(lin, x)

    model._linear = linear


def step(dev, case, mesh=None, tp=False):
    """One train step of the case's model on its batch (this rank's rows
    under ``mesh``) -> (model, metrics, fc1 input gradients)."""
    cfg = config_from_dict(case["spec"])
    model = new_model(case["spec"], case["params"])
    if tp:
        shard_params_for_tp(model, mesh)
    grads: list = []
    fc1_input_grads(model, grads)
    state = train_t.init_state(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    _, metrics = train_t.make_train_step(model, assets(dev), cfg, mesh=mesh)(state, batch)
    return model, {k: float(v) for k, v in metrics.items()}, grads


def whole_params(model, mesh) -> dict:
    """The whole model's parameters on every rank of a TP mesh: each
    shard placed in a zero tensor of the whole one, summed over the model
    axis (the exact all-reduce of ``parallel.mesh.gather_rows``)."""
    out = {k: v.detach() for k, v in model.state_dict().items()}
    n, m = mesh.shape[MODEL_AXIS], mesh.model_index
    for name in ("fc1.weight", "fc1.bias", "fc2.weight"):
        shard = out[name]
        axis = 1 if name == "fc2.weight" else 0
        k = shard.shape[axis]
        shape = list(shard.shape)
        shape[axis] = k * n
        full = torch.zeros(shape, dtype=shard.dtype)
        full.narrow(axis, m * k, k).copy_(shard)
        dist.all_reduce(full, group=mesh.model_group)
        out[name] = full
    return out


def excess(got: dict, want: dict) -> dict:
    """Per leaf, the largest ``|got - want| - (ATOL + RTOL |want|)``: at
    most 0 where ``np.testing.assert_allclose(got, want, RTOL, ATOL)``
    passes."""
    assert set(got) == set(want), set(got) ^ set(want)
    return {k: float(((got[k] - want[k]).abs() - (ATOL + RTOL * want[k].abs())).max())
            for k in want}


def single_step(dev, case) -> dict:
    """The single-process step on the whole batch: its params, metrics
    and fc1 input gradients."""
    model, metrics, fc1 = step(dev, case)
    return {"params": {k: v.detach() for k, v in model.state_dict().items()},
            "metrics": metrics, "fc1_grads": fc1}


class _Drawn(Exception):
    pass


def drawn_batch(syn, make_step, generator) -> dict:
    """The batch a synthetic step draws from ``generator``, caught before
    it trains: ``make_step()`` -> (step, state) builds the step while
    ``syn.synthetic_batch`` (what the step calls) records and stops."""
    real, box = syn.synthetic_batch, {}

    def recording(*args, **kwargs):
        box["batch"] = real(*args, **kwargs)
        raise _Drawn

    syn.synthetic_batch = recording
    try:
        step_fn, state = make_step()
        step_fn(state, generator)
    except _Drawn:
        pass
    finally:
        syn.synthetic_batch = real
    return box["batch"]


def eval_outputs(exp_dir: str) -> tuple[dict, dict]:
    """``cli.test --save-poses``'s (eval_results.json, refined_poses.npz)
    in ``exp_dir``, read into memory."""
    import os

    import numpy as np

    with open(os.path.join(exp_dir, "eval_results.json")) as f:
        table = json.load(f)
    with np.load(os.path.join(exp_dir, "refined_poses.npz")) as z:
        return table, dict(z)


EVAL_ARGV = ["--device", "cpu", "--num-samples", "8", "--save-poses"]


def world2(dev, path: str, work: str, cli_cfg: str, eval_cfg: str, eval_exp: str) -> dict:
    """The two-rank cases: the helpers, the DP step (against the
    reference's gradients and the single step), the (1, 2) TP step, the
    synthetic DP step's draws, rank 0's checkpoint, ``cli.train`` for 3
    steps and ``--resume`` to 4 (their output), ``cli.test`` with and
    without ``--hypotheses 4`` (rank 0's output and files), and the dry
    run's parts."""
    from deepim_tpu_torch import dryrun_multichip
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli import train as cli_train
    from deepim_tpu_torch.data import synthetic as syn
    from deepim_tpu_torch.train import checkpoint as ckpt

    case = load_case(path)
    rank = dist.get_rank()
    out = {"local_batch": process_local_batch_size(8)}
    try:
        make_mesh(2, 2)
    except ValueError as e:
        out["oversubscribed"] = str(e)
    single = single_step(dev, case) if rank == 0 else None

    mesh = make_mesh(n_data=2)
    model, out["dp_metrics"], _ = step(dev, case, mesh)
    out["dp_digest"] = digest(model.state_dict().values())
    if rank == 0:
        ref = case["ref_grads"]
        out["dp_vs_reference"] = {
            k: (float((p.grad - ref[k]).abs().max()), float(ref[k].abs().max()))
            for k, p in model.named_parameters()}
        out["dp_vs_single"] = excess(model.state_dict(), single["params"])
        out["single_metrics"] = single["metrics"]
        out["single_fc1_grads"] = single["fc1_grads"]

    mesh12 = make_mesh(n_data=1, n_model=2)
    model, out["tp_metrics"], out["tp_fc1_input_grads"] = step(dev, case, mesh12, tp=True)
    full = whole_params(model, mesh12)
    out["tp_shard_fraction"] = model.fc1.weight.numel() / full["fc1.weight"].numel()
    out["tp_column_parallel"] = isinstance(model.fc1, ColumnParallelLinear)
    if rank == 0:
        out["tp_vs_single"] = excess(full, single["params"])

    # The synthetic DP step: each rank draws its rows from one generator seed.
    cfg = config_from_dict(case["spec"])
    net = new_model(case["spec"])
    state = train_t.init_state(cfg, net)
    drawn = drawn_batch(syn, lambda: (train_t.make_synthetic_train_step(
        net, assets(dev), cfg, torch.from_numpy(case["k"]), mesh=mesh), state),
        torch.Generator().manual_seed(5))
    out["draws"] = [{k: drawn[k].numpy().copy() for k in ("pose_tgt", "obs_rgb")}]

    # Checkpoints: rank 0 writes, behind a barrier; every rank restores.
    writes = []
    real_save = ckpt.torch.save

    def counting(obj, f, *a, **k):
        writes.append(str(f))
        return real_save(obj, f, *a, **k)

    ckpt.torch.save = counting
    try:
        state.step = 7
        ckpt.save_train_state(work, state)
    finally:
        ckpt.torch.save = real_save
    fresh = train_t.init_state(cfg, new_model(case["spec"], case["params"]))
    ckpt.restore_train_state(work, fresh)
    out.update(writes=writes, saved_digest=digest(net.state_dict().values()),
               restored_digest=digest(fresh.model.state_dict().values()),
               restored_step=fresh.step)

    # cli.train in this group (what --n-devices 2 and torchrun run), then
    # --resume; each rank's output.
    argv = ["--cfg", cli_cfg, "--device", "cpu", "--n-devices", "2"]
    for name, extra in (("train", []), ("resume", ["--resume", "--num-steps", "4"])):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out[f"{name}_rc"] = cli_train.main(argv + extra)
        out[f"{name}_out"] = text.getvalue()
    # cli.test --n-devices 2 in this group; rank 0 alone writes its files.
    for hyps in (1, 4):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli_test.main(["--cfg", eval_cfg, *EVAL_ARGV, "--n-devices", "2",
                                "--hypotheses", str(hyps)])
        out[f"eval{hyps}"] = {"rc": rc, "out": text.getvalue(),
                              "files": eval_outputs(eval_exp) if rank == 0 else None}
    out["dryrun"] = dryrun_multichip.run(dev, 2)
    return out


def world4(dev, path: str) -> dict:
    """The (2, 2) TP step against the single step (on rank 0)."""
    case = load_case(path)
    single = single_step(dev, case) if dist.get_rank() == 0 else None
    mesh = make_mesh(n_data=2, n_model=2)
    model, metrics, _ = step(dev, case, mesh, tp=True)
    full = whole_params(model, mesh)
    out = {"tp_metrics": metrics, "tp_index": (mesh.data_index, mesh.model_index),
           "fc1_digest": digest([model.fc1.weight]),
           "tp_shard_fraction": model.fc1.weight.numel() / full["fc1.weight"].numel()}
    if single is not None:
        out["tp_vs_single"] = excess(full, single["params"])
        out["single_metrics"] = single["metrics"]
    return out
