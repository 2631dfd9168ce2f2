"""Faults planted in the program's timed path, to show that ``correct``
catches them: each moves answers where the program produces them, by
``MOVE_M`` along x (2 mm: 1.2e-2-2e-2 of the four classes' diameters).

- ``all``: every pose the refine loop returns;
- ``class``: the poses of one class (class 0) of the four;
- ``slot``: the pose in slot 0 of each call, which in the service is slot
  0 of every 32-row device batch: about one pose in twenty at the serving
  cell's fill, fewer than ``pose_off_share``'s limit lets through.

:func:`plant` patches the program's ``refine_poses`` where the refine
driver and the service call it; ``calibrate.py --fault`` reads a fault on
the card and the fault tests on the CPU.
"""

from __future__ import annotations

import contextlib

MOVE_M = 0.002
FAULTS = ("all", "class", "slot")


def _moved(fn, fault: str):
    def broken(model, assets, obs, poses, ks, cls, *a, **k):
        out = fn(model, assets, obs, poses, ks, cls, *a, **k).clone()
        if fault == "all":
            out[..., 0, 3] += MOVE_M
        elif fault == "class":
            out[cls == 0, 0, 3] += MOVE_M
        else:
            out[0, 0, 3] += MOVE_M
        return out
    return broken


@contextlib.contextmanager
def plant(fault: str):
    import deepim_tpu_torch.refine as refine_pkg
    import deepim_tpu_torch.serve.service as service

    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r} is not one of {FAULTS}")
    saved = refine_pkg.refine_poses, service.refine_poses
    refine_pkg.refine_poses = _moved(saved[0], fault)
    service.refine_poses = _moved(saved[1], fault)
    try:
        yield
    finally:
        refine_pkg.refine_poses, service.refine_poses = saved
