"""Checkpoints the card can read (``deepim_tpu/train/checkpoint.py``).

The reference stores its train state with orbax, which the card's machine
does not have.  The port writes one ``torch.save`` file per step,
``{"step": int, "params": state_dict}``, under
``<output_dir>/<experiment>/checkpoints_torch/`` (:func:`checkpoint_dir`),
a directory of its own, so orbax's step directories and these files never
meet.  Only the network's parameters are stored: the optimizer state
arrives with training (ROADMAP A12).

:func:`import_flax_params` turns the reference's params tree (as numpy,
e.g. from ``deepim_tpu.train.checkpoint.restore_params_raw`` run where JAX
is installed) into such a file through ``models/bridge.py``, which is how
weights trained by the JAX package reach the card.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

from deepim_tpu_torch.models.bridge import flax_to_torch

_FILE = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_dir(cfg) -> str:
    """Where the port keeps the checkpoints of ``cfg``'s experiment."""
    return os.path.join(cfg.output_dir, cfg.experiment, "checkpoints_torch")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def save_checkpoint(ckpt_dir: str, step: int, params: dict[str, torch.Tensor],
                    max_to_keep: int = 3) -> str:
    """Write ``params`` (a ``state_dict``) as step ``step`` -> its path.

    A step that exists is overwritten; the file appears whole or not at
    all (written aside, then renamed).  Only the ``max_to_keep`` newest
    steps are kept.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, int(step))
    tmp = path + ".tmp"
    torch.save({"step": int(step),
                "params": {k: v.detach().cpu() for k, v in params.items()}}, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    return path


def clear_checkpoints(ckpt_dir: str) -> None:
    """Remove a checkpoint dir (fresh, non-resumed runs start clean)."""
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       device: torch.device | str = "cpu"
                       ) -> tuple[int, dict[str, torch.Tensor]]:
    """(step, state_dict on ``device``) of ``step``, default the latest.

    Loaded with ``weights_only=True``: a file holds tensors and numbers
    only, and nothing in it runs.
    """
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    ckpt = torch.load(_path(ckpt_dir, step), map_location=device, weights_only=True)
    return int(ckpt["step"]), ckpt["params"]


def import_flax_params(ckpt_dir: str, params_numpy: dict, step: int) -> str:
    """Write the reference's flax ``params`` tree (numpy leaves) as a port
    checkpoint of ``step`` -> its path."""
    return save_checkpoint(ckpt_dir, step, flax_to_torch(params_numpy))
