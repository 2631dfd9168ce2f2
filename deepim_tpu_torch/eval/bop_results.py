"""BOP-challenge result export (numpy only).

Port of ``deepim_tpu/eval/bop_results.py``: one CSV row of estimates per
test image (``scene_id,im_id,obj_id,score,R,t,time``, R row-major 3x3, t in
mm), the format the BOP toolkit reads.  The port writes the same bytes as
the reference, and each package reads the other's files.
"""

from __future__ import annotations

import numpy as np

HEADER = "scene_id,im_id,obj_id,score,R,t,time"


def write_bop_csv(path: str, poses: np.ndarray, obj_ids: np.ndarray,
                  scene_ids: np.ndarray | None = None, im_ids: np.ndarray | None = None,
                  scores: np.ndarray | None = None, time_s: float = -1.0) -> int:
    """Write N pose estimates ``poses`` (N, 3, 4), metres, camera frame, as
    a BOP results CSV -> N.  ``obj_ids`` (N,) integer BOP ids; scene ids
    default to 0, image ids to the row, scores to 1; ``time_s`` is the
    per-image runtime (-1: not reported)."""
    poses = np.asarray(poses, np.float64)
    n = poses.shape[0]
    scene_ids = np.zeros(n, int) if scene_ids is None else np.asarray(scene_ids)
    im_ids = np.arange(n) if im_ids is None else np.asarray(im_ids)
    scores = np.ones(n) if scores is None else np.asarray(scores)
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for i in range(n):
            r = " ".join(f"{v:.9f}" for v in poses[i, :, :3].reshape(-1))
            t = " ".join(f"{v:.9f}" for v in poses[i, :, 3] * 1000.0)  # m -> mm
            f.write(f"{scene_ids[i]},{im_ids[i]},{int(obj_ids[i])},"
                    f"{scores[i]:.6f},{r},{t},{time_s:.3f}\n")
    return n


def read_bop_csv(path: str) -> dict[str, np.ndarray]:
    """Inverse of :func:`write_bop_csv` (poses back in metres, float32)."""
    scene_ids, im_ids, obj_ids, scores, poses = [], [], [], [], []
    with open(path) as f:
        header = f.readline().strip()
        if header != HEADER:
            raise ValueError(f"not a BOP results CSV: {header!r}")
        for line in f:
            s, im, obj, score, r, t, _ = line.strip().split(",")
            rot = np.asarray(r.split(), np.float64).reshape(3, 3)
            trans = np.asarray(t.split(), np.float64) / 1000.0
            scene_ids.append(int(s))
            im_ids.append(int(im))
            obj_ids.append(int(obj))
            scores.append(float(score))
            poses.append(np.concatenate([rot, trans[:, None]], 1))
    return {
        "scene_ids": np.asarray(scene_ids),
        "im_ids": np.asarray(im_ids),
        "obj_ids": np.asarray(obj_ids),
        "scores": np.asarray(scores),
        "poses": np.asarray(poses, np.float32),
    }
