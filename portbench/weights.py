"""The network's weights, from the run's seed, by one of two rules that a
configuration's ``weights.init`` names.

``"draw"`` (the default): one generator on the device and one normal draw for every weight of the
network at once: each weight tensor takes its slice, scaled to a standard
deviation of 1/sqrt(fan-in) and cut at two deviations.  Biases are 0.  The
pose heads start at the identity (quaternion bias (1, 0, 0, 0), the rest
0) and then take a normal noise of ``head_noise`` on every entry, so
the poses move at every iteration.  The same dict is loaded into the
program and handed to the reference.

``"program"``: the program draws its own initial weights from a CPU
generator seeded by the run; :func:`program_rule` is a frozen copy of
that rule (the network's documented initialisers), which the reference
works out again from the seed: every weight N(0, 1/fan_in) truncated at
two deviations, in the order the network registers its layers; biases 0;
the pose heads 0 with the identity quaternion as ``fc_rot``'s bias, so an
untrained network leaves every pose where it is.
"""

from __future__ import annotations

import torch

HEADS = ("fc_rot", "fc_trans")
#: The standard deviation of a unit normal truncated at two deviations.
TRUNC_STD = 0.87962566103423978


def draw(shapes: dict, seed: int, device, head_noise: float) -> dict:
    """``shapes``: name -> (shape, fan_in), as ``reference.network.param_shapes`` gives."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [torch.Size(s).numel() for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    noise = torch.randn(sum(n for (name, n) in zip(shapes, sizes) if name.split(".")[0] in HEADS),
                        generator=g, device=device) * head_noise
    out, at, at_noise = {}, 0, 0
    for (name, (shape, fan_in)), n in zip(shapes.items(), sizes):
        part = flat[at:at + n].view(shape)
        at += n
        head = name.split(".")[0] in HEADS
        if head:
            base = torch.zeros(shape, device=device)
            if name == "fc_rot.bias":
                base.view(-1, 4)[:, 0] = 1.0
            out[name] = base + noise[at_noise:at_noise + n].view(shape)
            at_noise += n
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            std = fan_in ** -0.5
            out[name] = (part.clamp(-2.0, 2.0) * std).contiguous()
    return out


def program_rule(shapes: dict, seed: int) -> dict:
    """The program's own initial weights for ``shapes`` (in its layer
    order), drawn on the CPU from a generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, fan_in) in shapes.items():
        t = torch.zeros(shape)
        if not name.endswith(".bias") and name.split(".")[0] not in HEADS:
            std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
            torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)
        if name == "fc_rot.bias":
            t.view(-1, 4)[:, 0] = 1.0
        out[name] = t
    return out
