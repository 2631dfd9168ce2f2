"""Protocol tools of the port, each run as
``python -m deepim_tpu_torch.tools.<name>``: ``seed_variance``,
``decimation_ab``, ``robustness_curve``, ``supervise_train``,
``demo_render``, ``plot_train``, ``gen_lm6d_cfgs`` and ``scale_eval_demo``
(ports of the reference's ``tools/`` of the same names, with their
arguments and output format; the tools that render or refine take
``--device``, default ``cuda:0``; ``gen_lm6d_cfgs`` writes to ``--out``)."""

from __future__ import annotations

import sys


def restored_model(cfg, num_classes: int, dev):
    """The inference model of ``cfg`` on ``dev`` with the experiment's
    latest port checkpoint -> (model, its step, 0 without one).  Without a
    checkpoint it warns, as the reference tools do, and the refiner is the
    untrained (identity-delta) net."""
    import torch

    from deepim_tpu_torch.train.checkpoint import (
        checkpoint_dir, latest_step, load_params, orbax_dir, require_port_checkpoint,
        restore_checkpoint)
    from deepim_tpu_torch.train.train import make_model

    ckpt_dir = checkpoint_dir(cfg)
    require_port_checkpoint(ckpt_dir, orbax_dir(cfg))
    model = make_model(cfg, num_classes, inference=True,
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    if latest_step(ckpt_dir) is None:
        print("WARNING: no checkpoint — identity refiner", file=sys.stderr)
        return model, 0
    step, params = restore_checkpoint(ckpt_dir, device=dev)
    load_params(model, params)
    print(f"loaded checkpoint step {step}")
    return model, step
