"""What the drivers share: the run's context, seeds, the program's config,
the weights and the reference's side of a run.

The program is :mod:`deepim_tpu_torch`; the drivers import it inside their
functions, so this package (and its tests of the reference) imports on a
machine without it.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import hashlib
import os
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import weights as weights_mod
from portbench.reference import network
from portbench.reference.assets import object_set


@dataclass
class Ctx:
    cell: str
    conf: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json "limits"
    seed: int
    device: torch.device
    control: str | None = None  # "int8": the program's int8 path, the control of correct
    compare: dict = field(default_factory=dict)  # workloads/<cell>.json "compare"


def seed_of(seed: int, tag: str, i: int = 0) -> int:
    """A 63-bit seed of its own for (``seed``, ``tag``, ``i``)."""
    digest = hashlib.sha256(f"{seed}:{tag}:{i}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


#: Where the program's outputs go when ``TMPDIR`` is not set: the checkout.
OUTPUT_FALLBACK = Path(__file__).resolve().parent / ".cache" / "output"


def program_config(ctx: Ctx):
    """The experiment as the program loads it; outputs under ``TMPDIR``
    (else inside the checkout), never at a fixed path another checkout shares."""
    from deepim_tpu_torch.config import config_from_dict

    exp = copy.deepcopy(ctx.conf["experiment"])
    tmp = os.environ.get("TMPDIR")
    exp["output_dir"] = os.path.join(tmp, "portbench_output") if tmp else str(OUTPUT_FALLBACK)
    if ctx.control == "int8":
        exp.setdefault("network", {})["quant"] = "int8"
    return config_from_dict(exp)


def noise(cfg) -> dict:
    t = cfg.train
    return {"rot_deg": t.rot_noise_deg, "rot_max_deg": t.rot_noise_max_deg,
            "trans": list(t.trans_noise), "trans_max": list(t.trans_noise_max)}


def sizes(cfg):
    n = cfg.network
    out = (n.input_height, n.input_width)
    return out, (cfg.dataset.image_height, cfg.dataset.image_width), network.grid(*out)


def camera(cfg, device) -> torch.Tensor:
    d = cfg.dataset
    return torch.tensor([[d.fx, 0.0, d.cx], [0.0, d.fy, d.cy], [0.0, 0.0, 1.0]], device=device)


def program_inits(ctx: Ctx) -> bool:
    """Whether the configuration's weights are the program's own
    initialisation (``weights.init: program``) rather than the benchmark's draw."""
    return ctx.conf["weights"].get("init", "draw") == "program"


def init_generator(ctx: Ctx) -> torch.Generator:
    """The CPU generator the program draws its initial weights from."""
    return torch.Generator().manual_seed(seed_of(ctx.seed, "weights"))


def draw_weights(ctx: Ctx, cfg, decoder: bool) -> dict:
    """The run's weights on the device: the benchmark's draw, or the
    program's initialisation worked out again from the seed."""
    out, _, _ = sizes(cfg)
    shapes = network.param_shapes(len(cfg.dataset.objects), out, decoder,
                                  decoder and cfg.network.with_mask, cfg.network.fc_dim)
    if program_inits(ctx):
        got = weights_mod.program_rule(shapes, seed_of(ctx.seed, "weights"))
        return {n: w.to(ctx.device) for n, w in got.items()}
    return weights_mod.draw(shapes, seed_of(ctx.seed, "weights"), ctx.device,
                            ctx.conf["weights"]["head_noise"])


def objects(cfg, device):
    return object_set(list(cfg.dataset.objects), cfg.dataset.num_points, device)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def float32_exact() -> None:
    """The reference computes in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replace(dc, **kw):
    return dataclasses.replace(dc, **kw)
