"""The LM6d_converted on-disk layout: its paths and writers (numpy).

Port of the part of ``deepim_tpu/data/lm6d.py`` (``:31-245``) that the
video toolkit needs: ``DEPTH_FACTOR``, ``FrameRecord`` and
``LM6DDataset``'s layout (``MODEL_CANDIDATES``, ``model_path``, the path
helpers, ``_read_image``) with ``write_model`` and ``write_frame``.
Images go through :mod:`deepim_tpu_torch.data.png`; poses are
``np.savetxt`` text, as in the reference, so each package reads the
other's files.  The layout:

    {root}/
      models/{obj}/textured.ply                 # vertex-coloured mesh
      data/observed/{scene}/{frame}-color.png   # uint8 RGB
      data/observed/{scene}/{frame}-depth.png   # uint16, metres * DEPTH_FACTOR
      data/observed/{scene}/{frame}-label.png   # uint8 class-id mask (0 = bg)
      data/observed/{scene}/{frame}-pose_{obj}.txt  # 3x4 row-major floats
      image_set/observed/{obj}_{split}.txt      # lines: {scene}/{frame}
      init_poses/{obj}_{split}.txt              # optional external inits

The readers of the on-disk datasets (``gt_roidb``, ``load_frame``, the
prefetching batch iterators, ``apply_bop_init``, ``TrainBatcher``) and the
toolkit's other writers (image sets, rendered pairs, init poses) are not
ported yet (ROADMAP A13, second half).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from deepim_tpu_torch.data.png import read_png, write_png

DEPTH_FACTOR = 1000.0  # uint16 depth png = metres * 1000 (reference LM6d)


@dataclass
class FrameRecord:
    """One (frame, object) pose-refinement sample."""

    scene: str
    frame: str
    obj: str
    class_idx: int
    pose: np.ndarray  # (3, 4) GT
    init_pose: np.ndarray | None  # (3, 4) external init (PoseCNN-style)


class LM6DDataset:
    """Paths and writers of the layout above."""

    #: model file names probed in order (YCB ships textured.obj beside
    #: textured.ply)
    MODEL_CANDIDATES = ("textured.ply", "textured.obj", "model.ply",
                        "model.obj", "model.off")

    def __init__(self, root: str, objects: list[str]):
        self.root = root
        self.objects = list(objects)
        self.class_to_idx = {o: i for i, o in enumerate(self.objects)}

    # -- paths ---------------------------------------------------------------

    def model_path(self, obj: str) -> str:
        """The first model file of ``obj`` that exists, else the default
        (and write target) ``models/{obj}/textured.ply``."""
        mdir = os.path.join(self.root, "models", obj)
        for name in self.MODEL_CANDIDATES:
            cand = os.path.join(mdir, name)
            if os.path.exists(cand):
                return cand
        return os.path.join(mdir, "textured.ply")

    def _obs(self, scene: str, frame: str, suffix: str) -> str:
        return os.path.join(self.root, "data", "observed", scene, f"{frame}-{suffix}")

    def _imageset_path(self, obj: str, split: str) -> str:
        return os.path.join(self.root, "image_set", "observed", f"{obj}_{split}.txt")

    def _ren(self, obj: str, scene: str, frame: str, idx: int, suffix: str) -> str:
        return os.path.join(self.root, "data", "rendered", obj, scene,
                            f"{frame}_{idx}-{suffix}")

    @staticmethod
    def _read_image(path: str) -> np.ndarray:
        """A PNG as written by either package (uint8 RGB or grey, uint16)."""
        return read_png(path)

    # -- writing ---------------------------------------------------------------

    def write_model(self, obj: str, mesh) -> None:
        from deepim_tpu_torch.raster.mesh import save_ply

        os.makedirs(os.path.dirname(self.model_path(obj)), exist_ok=True)
        save_ply(self.model_path(obj), mesh)

    def write_frame(self, scene: str, frame: str, rgb: np.ndarray, depth: np.ndarray,
                    label: np.ndarray | None, poses: dict[str, np.ndarray]) -> None:
        """One observed frame: RGB in [0, 1], metric depth, an optional
        label map (``None`` writes none; readers then use depth > 0) and
        one GT pose per object."""
        os.makedirs(os.path.join(self.root, "data", "observed", scene), exist_ok=True)
        write_png(self._obs(scene, frame, "color.png"),
                  np.clip(rgb * 255, 0, 255).astype(np.uint8))
        write_png(self._obs(scene, frame, "depth.png"), (depth * DEPTH_FACTOR).astype(np.uint16))
        if label is not None:
            write_png(self._obs(scene, frame, "label.png"), label.astype(np.uint8))
        for obj, pose in poses.items():
            np.savetxt(self._obs(scene, frame, f"pose_{obj}.txt"),
                       np.asarray(pose, np.float32))
