"""Original (pre-SIXD) LINEMOD release converter -> the LM6d layout.

Port of ``deepim_tpu/data/lm_original.py``.  The Hinterstoisser ACCV'12
release, per object:

    {root}/{object}/
        mesh.ply            # object mesh, MILLIMETRES
        data/
            color{i}.jpg    # observed RGB (640x480), baseline JPEG
            depth{i}.dpt    # binary depth: two int32 (rows, cols), then
                            # uint16 row-major, MILLIMETRES
            rot{i}.rot      # text: "3 3" header line, then the 3x3
                            # model-to-camera rotation rows
            tra{i}.tra      # text: "1 3" header line, then the
                            # translation in CENTIMETRES

Colour frames are read with the port's own JPEG decoder
(:func:`deepim_tpu_torch.data.jpeg.imread`, PIL's pixels bit for bit).
The release has no labels; converted frames carry none (the readers use
depth > 0).  Preflight the output with ``deepim_tpu_torch.cli.validate_dataset``:
its depth-against-pose-z check catches a wrong unit on a real drop.
"""

from __future__ import annotations

import os

import numpy as np

from deepim_tpu_torch.data.jpeg import imread
from deepim_tpu_torch.data.lm6d import LM6DDataset

__all__ = ["read_dpt", "read_rot", "read_tra", "convert_lm_original"]

CM_TO_M = 1e-2
MM_TO_M = 1e-3


def read_dpt(path: str) -> np.ndarray:
    """An original-release binary depth -> (H, W) float32 METRES.

    Header: two little-endian int32.  The release writes (rows, cols);
    some re-distributions swap them, so the landscape order is taken
    (LINEMOD is 480x640) and the element count checked."""
    with open(path, "rb") as f:
        a, b = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, np.uint16)
    a, b = int(a), int(b)
    if a * b != data.size:
        raise ValueError(f"{path}: header {a}x{b} does not match {data.size} uint16 "
                         "payload elements — not an original-release .dpt file")
    rows, cols = (a, b) if a <= b else (b, a)  # images are landscape
    return data.reshape(rows, cols).astype(np.float32) * MM_TO_M


def _read_headed_text(path: str, expect: int) -> np.ndarray:
    """The release's text matrices: a "rows cols" header line, then values."""
    with open(path) as f:
        tokens = f.read().split()
    vals = np.asarray([float(t) for t in tokens], np.float64)
    if vals.size == expect + 2:  # header present
        r, c = int(vals[0]), int(vals[1])
        if r * c != expect:
            raise ValueError(f"{path}: header {r}x{c} does not describe {expect} values")
        vals = vals[2:]
    elif vals.size != expect:
        raise ValueError(f"{path}: {vals.size} values, expected {expect} (+2 header)")
    return vals


def read_rot(path: str) -> np.ndarray:
    """rot{i}.rot -> (3, 3) model-to-camera rotation."""
    return _read_headed_text(path, 9).reshape(3, 3)


def read_tra(path: str) -> np.ndarray:
    """tra{i}.tra -> (3,) translation in METRES (the file stores cm)."""
    return _read_headed_text(path, 3) * CM_TO_M


def _frame_indices(data_dir: str) -> list[int]:
    return sorted(int(f[3:-4]) for f in os.listdir(data_dir)
                  if f.startswith("rot") and f.endswith(".rot"))


def convert_lm_original(src_root: str, out_root: str, objects: list[str] | None = None,
                        out_split: str = "test",
                        max_frames: int | None = None) -> LM6DDataset:
    """Convert the original Hinterstoisser tree into the LM6d layout.

    Each source object becomes its own LM6d scene (named after the object,
    frames zero-padded to 6); meshes are scaled mm -> m; poses are .rot
    (model to camera) and .tra (cm -> m); depth is re-encoded at the
    layout's factor."""
    from deepim_tpu_torch.raster.mesh import Mesh, load_ply

    if objects is None:
        objects = sorted(d for d in os.listdir(src_root)
                         if os.path.isdir(os.path.join(src_root, d, "data")))
    if not objects:
        raise FileNotFoundError(f"{src_root}: no <object>/data directories — not an original "
                                "LINEMOD release tree")
    ds = LM6DDataset(out_root, objects)

    for obj in objects:
        odir = os.path.join(src_root, obj)
        mesh = load_ply(os.path.join(odir, "mesh.ply"))
        ds.write_model(obj, Mesh(mesh.vertices * MM_TO_M, mesh.faces, mesh.colors,
                                 mesh.normals))

        data_dir = os.path.join(odir, "data")
        frames = []
        for i in _frame_indices(data_dir)[:max_frames]:
            rot = read_rot(os.path.join(data_dir, f"rot{i}.rot"))
            tra = read_tra(os.path.join(data_dir, f"tra{i}.tra"))
            pose = np.concatenate([rot, tra[:, None]], axis=1)
            rgb = imread(os.path.join(data_dir, f"color{i}.jpg")).astype(np.float32) / 255.0
            dpt = os.path.join(data_dir, f"depth{i}.dpt")
            depth = read_dpt(dpt) if os.path.exists(dpt) else np.zeros(rgb.shape[:2], np.float32)
            frame = f"{i:06d}"
            # no labels in the release: no label PNG, the readers use depth > 0
            ds.write_frame(obj, frame, rgb, depth, None, {obj: pose})
            frames.append((obj, frame))
        ds.write_image_set(obj, out_split, frames)
    return ds
