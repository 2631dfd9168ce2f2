"""deepim_tpu_torch.train's micro-overfit (CPU, float32): forty Adam steps
on one synthetic batch of tests/test_torch_train.py's size make the loss
and the rotation error fall, as tests/test_train.py §test_micro_overfit
does for the reference."""

import numpy as np
import torch

from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import synthetic_batch
from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
from deepim_tpu_torch.refine import build_assets
from deepim_tpu_torch.train import train as train_t

IMG = (64, 96)
K = np.array([[120.0, 0, 48.0], [0, 120.0, 32.0], [0, 0, 1]], np.float32)
SPEC = {
    "network": {"input_height": 48, "input_width": 64, "dtype": "float32", "fc_dim": 64,
                "with_flow": False, "with_mask": False},
    "dataset": {"objects": ["box", "icosphere"], "image_height": IMG[0], "image_width": IMG[1],
                "fx": 120.0, "fy": 120.0, "cx": 48.0, "cy": 32.0, "num_points": 64},
    "train": {"batch_size": 4, "renderer": "pallas_interpret", "warmup_steps": 0, "lr": 3e-4,
              "w_flow": 0.0, "w_mask": 0.0, "optimizer": "adam", "weight_decay": 0.0},
}


def test_micro_overfit():
    """The loss falls on a fixed batch (tests/test_train.py §test_micro_overfit
    at a smaller size): a gradient-direction test, flow/mask heads off."""
    cfg = config_from_dict(SPEC)
    assets = build_assets([box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05, subdivisions=2)],
                          num_points=64, device="cpu")
    model = train_t.make_model(cfg, 2, generator=torch.Generator().manual_seed(0))
    state = train_t.init_state(cfg, model)
    step = train_t.make_train_step(model, assets, cfg)
    batch = synthetic_batch(torch.Generator().manual_seed(5), assets, 4,
                            torch.from_numpy(K), IMG)
    losses, rot_errs = [], []
    for _ in range(40):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        rot_errs.append(float(metrics["rot_err_deg_0"]))
    assert min(losses) < losses[0] * 0.5, losses[::5]
    assert min(rot_errs) < rot_errs[0] * 0.7, rot_errs[::5]
