"""Checkpoints the card can read (``deepim_tpu/train/checkpoint.py``).

The reference stores its train state with orbax, which the card's machine
does not have.  The port writes one ``torch.save`` file per step,
``{"step": int, "params": state_dict, "opt_state": optimizer state_dict}``
(``opt_state`` absent from a params-only file, such as an imported one),
under ``<output_dir>/<experiment>/checkpoints_torch/``
(:func:`checkpoint_dir`), a directory of its own, so orbax's step
directories and these files never meet.

:func:`import_flax_params` turns the reference's params tree (as numpy,
e.g. from ``deepim_tpu.train.checkpoint.restore_params_raw`` run where JAX
is installed) into such a file through ``models/bridge.py``, decoder
included, which is how weights trained by the JAX package reach the card.
A reader that finds only the reference's orbax steps raises naming it
(:func:`require_port_checkpoint`) rather than go on with initial weights.
:func:`merge_pretrained` is the reference's partial init on
``state_dict``s.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

from deepim_tpu_torch.models.bridge import (
    BARE_DECONVS, DECODER_LAYERS, WRAPPED_DECONVS, flax_to_torch)
from deepim_tpu_torch.parallel import distributed

_FILE = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_dir(cfg) -> str:
    """Where the port keeps the checkpoints of ``cfg``'s experiment."""
    return os.path.join(cfg.output_dir, cfg.experiment, "checkpoints_torch")


def orbax_dir(cfg) -> str:
    """Where the reference keeps the orbax checkpoints of ``cfg``'s experiment."""
    return os.path.join(cfg.output_dir, cfg.experiment, "checkpoints")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir: str, step: int, params: dict[str, torch.Tensor],
                    opt_state: dict | None = None, max_to_keep: int = 3) -> str:
    """Write ``params`` (a ``state_dict``) and, when given, ``opt_state`` (an
    optimizer's ``state_dict``) as step ``step`` -> its path.

    A step that exists is overwritten; the file appears whole or not at
    all (written aside, then renamed).  Only the ``max_to_keep`` newest
    steps are kept.  In a process group only rank 0 writes, and every
    rank returns after it has (a barrier).
    """
    path = _path(ckpt_dir, int(step))
    if distributed.rank() == 0:
        _write(path, step, params, opt_state, max_to_keep)
    distributed.barrier()
    return path


def _write(path: str, step: int, params, opt_state, max_to_keep: int) -> None:
    ckpt_dir = os.path.dirname(path)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    payload = {"step": int(step), "params": _to_cpu(params)}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))


def save_train_state(ckpt_dir: str, state, max_to_keep: int = 3) -> str:
    """:func:`save_checkpoint` of a ``TrainState`` (step, params, opt_state)."""
    return save_checkpoint(ckpt_dir, state.step, state.model.state_dict(),
                           state.optimizer.state_dict(), max_to_keep)


def clear_checkpoints(ckpt_dir: str) -> None:
    """Remove a checkpoint dir (fresh, non-resumed runs start clean); in a
    process group rank 0 removes it, behind a barrier."""
    if distributed.rank() == 0 and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    distributed.barrier()


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def orbax_steps(ckpt_dir: str) -> list[int]:
    """The reference's orbax steps under ``ckpt_dir`` (directories with
    all-digit names), read without orbax."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n)))


def require_port_checkpoint(ckpt_dir: str, reference_dir: str) -> None:
    """Raise when ``ckpt_dir`` holds no port checkpoint while
    ``reference_dir`` holds orbax steps: going on would run initial
    weights where the reference runs trained ones."""
    if latest_step(ckpt_dir) is None and orbax_steps(reference_dir):
        raise FileNotFoundError(
            f"{reference_dir} holds orbax checkpoints of the reference (steps "
            f"{orbax_steps(reference_dir)}) but {ckpt_dir} holds no port checkpoint; "
            "import one with deepim_tpu_torch.train.import_flax_params (the params of "
            "deepim_tpu.train.checkpoint.restore_params_raw, as numpy)")


def load_checkpoint(ckpt_dir: str, step: int | None = None,
                    device: torch.device | str = "cpu") -> dict:
    """The file of ``step`` (default the latest) as a dict on ``device``.

    Loaded with ``weights_only=True``: a file holds tensors, numbers and
    containers only, and nothing in it runs.
    """
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return torch.load(_path(ckpt_dir, step), map_location=device, weights_only=True)


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       device: torch.device | str = "cpu"
                       ) -> tuple[int, dict[str, torch.Tensor]]:
    """(step, state_dict on ``device``) of ``step``, default the latest."""
    ckpt = load_checkpoint(ckpt_dir, step, device)
    return int(ckpt["step"]), ckpt["params"]


def restore_train_state(ckpt_dir: str, state, step: int | None = None):
    """Load params, optimizer state and step of a checkpoint (default the
    latest) into ``state`` (a ``TrainState``) -> ``state``, for resuming.

    Read on the CPU: ``load_state_dict`` moves the params and moments to
    each parameter's device and keeps Adam's ``step`` counts on the CPU,
    as a fresh optimizer holds them (on the card they would cost a host
    sync per parameter and update)."""
    ckpt = load_checkpoint(ckpt_dir, step, "cpu")
    if "opt_state" not in ckpt:
        raise ValueError(f"{ckpt_dir} step {ckpt['step']} holds params only (no "
                         "optimizer state): start a run from it with train.pretrained")
    state.model.load_state_dict(ckpt["params"])
    state.optimizer.load_state_dict(ckpt["opt_state"])
    state.step = int(ckpt["step"])
    return state


def load_params(model: torch.nn.Module, params: dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(params)``, where ``params`` may also carry the
    decoder and mask head that a pose-only model lacks (a training
    checkpoint served for inference); every other key must match."""
    own = model.state_dict().keys()
    extra = [k for k in params if k not in own]
    if any(not k.startswith(tuple(f"{n}." for n in DECODER_LAYERS)) for k in extra):
        raise KeyError(f"unexpected parameters {extra}")
    model.load_state_dict({k: v for k, v in params.items() if k in own})


def restore_params_raw(ckpt_dir: str, step: int | None = None) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a port checkpoint, with no model to fit: the
    source of :func:`merge_pretrained`."""
    return restore_checkpoint(ckpt_dir, step)[1]


def _in_axis(key: str) -> int:
    return 0 if key.startswith(tuple(f"{n}." for n in WRAPPED_DECONVS + BARE_DECONVS)) else 1


def _wider_in(key: str, tmpl: torch.Tensor, src: torch.Tensor) -> bool:
    """A 4-D conv weight whose shape differs from ``src``'s only in its
    input-channel axis, where the template is wider."""
    if not tmpl.dim() == src.dim() == 4:
        return False
    a = _in_axis(key)
    same = all(tmpl.shape[i] == src.shape[i] for i in range(4) if i != a)
    return same and tmpl.shape[a] > src.shape[a]


def merge_pretrained(template: dict[str, torch.Tensor], src: dict[str, torch.Tensor],
                     reinit: tuple = (), log=print) -> tuple[dict[str, torch.Tensor], dict]:
    """Copy ``src`` entries into ``template`` (both ``state_dict``s) where
    they fit -> (merged, stats).

    The reference's pretrained-FlowNet init: equal shapes load; a conv
    weight that differs only in input channels (template wider: torch
    axis 1, axis 0 of a transposed conv) loads the overlapping slice
    (RGB -> RGB-D transfer) and keeps
    the fresh init of the new channels; a 2-D dense weight never slices
    (its rows are a flattened grid, a slice would scramble them); every
    other mismatch keeps its fresh init; ``reinit`` substrings force a
    fresh init even on a match.
    """
    stats = {"loaded": 0, "sliced": 0, "shape_skipped": 0, "missing": 0, "reinit": 0}
    merged = {}
    for key, tmpl in template.items():
        s = src.get(key)
        merged[key] = tmpl
        if s is None:
            stats["missing"] += 1
        elif any(r in key for r in reinit):
            stats["reinit"] += 1
        elif tuple(s.shape) == tuple(tmpl.shape):
            stats["loaded"] += 1
            merged[key] = s.to(tmpl.dtype).to(tmpl.device).clone()
        elif _wider_in(key, tmpl, s):
            stats["sliced"] += 1
            m = tmpl.clone()
            m.narrow(_in_axis(key), 0, s.shape[_in_axis(key)]).copy_(s)
            merged[key] = m
        else:
            stats["shape_skipped"] += 1
            log(f"pretrained: skip {key} (ckpt {tuple(s.shape)} vs model "
                f"{tuple(tmpl.shape)})")
    log(f"pretrained init: {stats['loaded']} loaded, {stats['sliced']} channel-sliced, "
        f"{stats['shape_skipped']} shape-skipped, {stats['missing']} missing, "
        f"{stats['reinit']} re-inited")
    return merged, stats


def import_flax_params(ckpt_dir: str, params_numpy: dict, step: int) -> str:
    """Write the reference's flax ``params`` tree (numpy leaves), decoder
    included, as a port checkpoint of ``step`` -> its path."""
    return save_checkpoint(ckpt_dir, step, flax_to_torch(params_numpy))
