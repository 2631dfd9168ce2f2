"""Object symmetry transform sets (numpy, host-side).

Copy of the parts of ``deepim_tpu/geometry/symmetry.py`` that
``build_assets`` needs (``identity_pose``, ``rot_z_syms``, ``sym_set`` and
the ``CONTINUOUS_Z*`` constants).  A copy and not an import: importing the
reference module runs ``deepim_tpu/geometry/__init__.py``, which imports
jax.  ``tests/test_torch_assets.py`` holds the copy bit-identical.
"""

from __future__ import annotations

import numpy as np

# Sentinel for sym_transforms entries: CONTINUOUS rotational symmetry
# about object z (dense discrete stand-in in sym_poses + a per-class flag).
CONTINUOUS_Z = "continuous_z"

#: discrete stand-in resolution for continuous-z classes in sym_poses
CONTINUOUS_Z_DISCRETE = 16


def identity_pose() -> np.ndarray:
    return np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1).astype(np.float32)


def rot_z_syms(n: int) -> np.ndarray:
    """n-fold rotation symmetry about object z -> (n, 3, 4), identity first."""
    out = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
        out.append(np.concatenate([r, np.zeros((3, 1))], axis=1))
    return np.asarray(out, np.float32)


def sym_set(transforms, max_syms: int) -> np.ndarray:
    """Pad a symmetry set to (max_syms, 3, 4) by repeating identity.

    ``None`` means asymmetric (all-identity set); ``CONTINUOUS_Z`` expands
    to the dense discrete stand-in.
    """
    if isinstance(transforms, str) and transforms == CONTINUOUS_Z:
        transforms = rot_z_syms(CONTINUOUS_Z_DISCRETE)
    base = identity_pose()[None] if transforms is None else np.asarray(
        transforms, np.float32
    )
    if base.shape[0] > max_syms:
        raise ValueError(f"{base.shape[0]} syms > budget {max_syms}")
    pad = np.tile(base[:1], (max_syms - base.shape[0], 1, 1))
    return np.concatenate([base, pad], axis=0)
