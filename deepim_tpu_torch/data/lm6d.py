"""The LM6d_converted on-disk dataset: its layout, readers, writers, and the
loaders that stream its frames to the card.

Port of ``deepim_tpu/data/lm6d.py``.  The layout:

    {root}/
      models/{obj}/textured.ply                 # vertex-coloured mesh
      data/observed/{scene}/{frame}-color.png   # uint8 RGB
      data/observed/{scene}/{frame}-depth.png   # uint16, metres * DEPTH_FACTOR
      data/observed/{scene}/{frame}-label.png   # uint8 class-id mask (0 = bg)
      data/observed/{scene}/{frame}-pose_{obj}.txt  # 3x4 row-major floats
      data/rendered/{obj}/{scene}/{frame}_{i}-color.png / -depth.png / -pose.txt
      image_set/observed/{obj}_{split}.txt      # lines: {scene}/{frame}
      init_poses/{obj}_{split}.txt              # optional external inits,
                                                # one 3x4 (12 floats) a line

Frames are read as the reference reads them: each PNG by one call of the
C++ decoder (:func:`deepim_tpu_torch.native.decode_png`, inflate and
unfilter without the GIL), and a PNG type it refuses by
:func:`deepim_tpu_torch.data.png.decode_png`; images are written by
:mod:`deepim_tpu_torch.data.png`.  Poses are ``np.savetxt`` text, as in the
reference, so each package reads the other's files.

The readers (``gt_roidb``, ``load_frame``, ``load_rendered``,
``make_eval_arrays``, ``apply_bop_init``) return what the reference's do.
The streaming loaders differ in form, not in content:

- ``load_frames_prefetched`` reads the files on the C++ prefetcher's
  threads, as the reference does, and decodes them on a thread pool where
  the reference decodes on its one Python thread.
- ``iter_frame_batches`` and ``TrainBatcher`` yield torch tensors stacked
  into a ring of reused host buffers, pinned when ``pin_memory``, and
  carry the PNGs' samples as they are: RGB uint8 and depth as the uint16
  samples in int16 storage.  :func:`to_device` copies a batch with
  ``non_blocking=True`` and converts on the device (``/ 255`` and
  ``/ DEPTH_FACTOR``, each one correctly rounded float32 division, as the
  reference's numpy ``astype(np.float32) / x``), so the host neither
  converts nor moves float32 frames.
- ``TrainBatcher`` keeps the reference's ``np.random.RandomState(seed)``
  permutation: its batches are the reference's, record for record, also
  on one shard of several (``num_shards``, ``shard_index``: each rank of a
  data-parallel run reads its own records).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from deepim_tpu_torch import native
from deepim_tpu_torch.data.png import decode_png, read_size, write_png

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


def decode_image(data: bytes) -> np.ndarray:
    """PNG bytes -> the array of ``LM6DDataset._read_image``: the C++
    decoder's, or for a type it refuses :func:`png.decode_png`'s (the
    reference's ``deepim_tpu/data/lm6d.py:138-148``, with PIL's place taken
    by the port's codec)."""
    img = native.decode_png(data)
    return img if img is not None else decode_png(data)


def _to_float(rgb: np.ndarray, depth: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return rgb.astype(np.float32) / 255.0, depth.astype(np.float32) / DEPTH_FACTOR


class LM6DDataset:
    """Reader and writer of the layout above."""

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

    @classmethod
    def discover_objects(cls, root: str) -> list[str]:
        """The object names of a root: its ``models/`` subdirectories that
        hold a model file, sorted."""
        mroot = os.path.join(root, "models")
        if not os.path.isdir(mroot):
            return []
        return sorted(d for d in os.listdir(mroot)
                      if os.path.isdir(os.path.join(mroot, d))
                      and any(os.path.exists(os.path.join(mroot, d, c))
                              for c in cls.MODEL_CANDIDATES))

    def _obs(self, scene: str, frame: str, suffix: str) -> str:
        return os.path.join(self.root, "data", "observed", scene, f"{frame}-{suffix}")

    def _imageset_path(self, obj: str, split: str) -> str:
        return os.path.join(self.root, "image_set", "observed", f"{obj}_{split}.txt")

    def _ren(self, obj: str, scene: str, frame: str, idx: int, suffix: str) -> str:
        return os.path.join(self.root, "data", "rendered", obj, scene,
                            f"{frame}_{idx}-{suffix}")

    @staticmethod
    def _read_image(path: str) -> np.ndarray:
        """A PNG file through :func:`decode_image` (uint8 RGB or grey,
        uint16 depth, as written by either package)."""
        with open(path, "rb") as f:
            return decode_image(f.read())

    # -- reading ---------------------------------------------------------------

    def load_meshes(self, max_faces: int | None = None):
        """Each object's model (``model_path``), decimated to ``max_faces``."""
        from deepim_tpu_torch.raster.mesh import decimate_mesh, load_mesh

        meshes = [load_mesh(self.model_path(o)) for o in self.objects]
        if max_faces:
            meshes = [decimate_mesh(m, max_faces) for m in meshes]
        return meshes

    def frame_list(self, obj: str, split: str) -> list[tuple[str, str]]:
        with open(self._imageset_path(obj, split)) as f:
            pairs = [ln.strip().split("/") for ln in f if ln.strip()]
        return [(s, fr) for s, fr in pairs]

    def gt_roidb(self, obj: str, split: str) -> list[FrameRecord]:
        """The split's records of ``obj``, with the external init poses
        when ``init_poses/{obj}_{split}.txt`` exists."""
        inits = self._load_init_poses(obj, split)
        records = []
        for i, (scene, frame) in enumerate(self.frame_list(obj, split)):
            pose = np.loadtxt(self._obs(scene, frame, f"pose_{obj}.txt"),
                              dtype=np.float32).reshape(3, 4)
            records.append(FrameRecord(scene=scene, frame=frame, obj=obj,
                                       class_idx=self.class_to_idx[obj], pose=pose,
                                       init_pose=None if inits is None else inits[i]))
        return records

    def _load_init_poses(self, obj: str, split: str) -> np.ndarray | None:
        path = os.path.join(self.root, "init_poses", f"{obj}_{split}.txt")
        if not os.path.exists(path):
            return None
        return np.loadtxt(path, dtype=np.float32).reshape(-1, 3, 4)

    def load_frame_raw(self, rec: FrameRecord) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The frame's PNG samples: RGB uint8 (H, W, 3), depth uint16 (H,
        W), and the object's mask (the label == class + 1, else depth > 0)."""
        rgb = self._read_image(self._obs(rec.scene, rec.frame, "color.png"))
        depth = self._read_image(self._obs(rec.scene, rec.frame, "depth.png"))
        label_path = self._obs(rec.scene, rec.frame, "label.png")
        if os.path.exists(label_path):
            mask = self._read_image(label_path) == (rec.class_idx + 1)
        else:
            mask = depth > 0
        return rgb, depth, mask

    def load_frame(self, rec: FrameRecord) -> dict:
        """RGB in [0, 1] float32, depth (m) float32, object mask bool."""
        rgb, depth, mask = self.load_frame_raw(rec)
        rgb, depth = _to_float(rgb, depth)
        return {"obs_rgb": rgb, "obs_depth": depth, "obs_mask": mask}

    def load_rendered(self, rec: FrameRecord, idx: int = 0) -> dict:
        """Pre-rendered perturbed view ``idx`` of ``rec``'s frame (written by
        ``toolkit.gen_rendered``) -> RGB in [0, 1], depth (m), source pose."""
        rgb, depth = _to_float(
            self._read_image(self._ren(rec.obj, rec.scene, rec.frame, idx, "color.png")),
            self._read_image(self._ren(rec.obj, rec.scene, rec.frame, idx, "depth.png")))
        pose = np.loadtxt(self._ren(rec.obj, rec.scene, rec.frame, idx, "pose.txt"),
                          dtype=np.float32).reshape(3, 4)
        return {"ren_rgb": rgb, "ren_depth": depth, "pose_src": pose}

    def has_rendered(self, rec: FrameRecord, idx: int = 0) -> bool:
        return os.path.exists(self._ren(rec.obj, rec.scene, rec.frame, idx, "pose.txt"))

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

    def write_image_set(self, obj: str, split: str, frames: list[tuple[str, str]]) -> None:
        path = self._imageset_path(obj, split)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for scene, frame in frames:
                f.write(f"{scene}/{frame}\n")

    def write_rendered(self, obj: str, scene: str, frame: str, idx: int, rgb: np.ndarray,
                       depth: np.ndarray, pose: np.ndarray) -> None:
        os.makedirs(os.path.join(self.root, "data", "rendered", obj, scene), exist_ok=True)
        write_png(self._ren(obj, scene, frame, idx, "color.png"),
                  np.clip(rgb * 255, 0, 255).astype(np.uint8))
        write_png(self._ren(obj, scene, frame, idx, "depth.png"),
                  (depth * DEPTH_FACTOR).astype(np.uint16))
        np.savetxt(self._ren(obj, scene, frame, idx, "pose.txt"), np.asarray(pose, np.float32))

    def write_init_poses(self, obj: str, split: str, poses: np.ndarray) -> None:
        d = os.path.join(self.root, "init_poses")
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, f"{obj}_{split}.txt"),
                   np.asarray(poses, np.float32).reshape(-1, 12))


# -- the loaders ---------------------------------------------------------------

_pools: dict[int, ThreadPoolExecutor] = {}
_pools_lock = threading.Lock()


def thread_pool(num_threads: int = 4) -> ThreadPoolExecutor:
    """The process's shared pool of ``num_threads`` IO threads (PNG
    decoding and writing)."""
    with _pools_lock:
        if num_threads not in _pools:
            _pools[num_threads] = ThreadPoolExecutor(num_threads,
                                                     thread_name_prefix="png-io")
        return _pools[num_threads]


def load_frames_prefetched(dataset: LM6DDataset, records: list[FrameRecord],
                           num_threads: int = 4) -> list[dict]:
    """``dataset.load_frame`` of every record, in order: the files read by
    the C++ :class:`~deepim_tpu_torch.native.PrefetchReader` on
    ``num_threads`` threads, each PNG decoded by :func:`decode_image` on the
    decode pool (``deepim_tpu/data/lm6d.py §load_frames_prefetched``).  A
    frame whose colour or depth file cannot be read goes through
    ``load_frame``, which raises naming it."""
    paths = [dataset._obs(r.scene, r.frame, kind) for r in records
             for kind in ("color.png", "depth.png", "label.png")]
    datas: list[bytes | None] = [None] * len(paths)
    with native.PrefetchReader(paths, num_threads=num_threads) as reader:
        for idx, data in reader:
            datas[idx] = data

    def frame(i: int) -> dict:
        rec, (cd, dd, ld) = records[i], datas[3 * i:3 * i + 3]
        if cd is None or dd is None:
            return dataset.load_frame(rec)
        depth = decode_image(dd)
        mask = decode_image(ld) == (rec.class_idx + 1) if ld is not None else depth > 0
        rgb, depth = _to_float(decode_image(cd), depth)
        return {"obs_rgb": rgb, "obs_depth": depth, "obs_mask": mask}

    return list(thread_pool(num_threads).map(frame, range(len(records))))


def prefetch_iter(it, depth: int = 1):
    """Run ``it`` on a background thread, keeping ``depth`` items ready, so
    PNG decoding overlaps the device's work.  A worker's exception is
    re-raised at the consuming ``next()`` with its traceback chained."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))

    def work():
        try:
            for x in it:
                q.put(("item", x))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            q.put(("error", e))
            return
        q.put(("done", None))

    threading.Thread(target=work, daemon=True).start()
    while True:
        kind, x = q.get()
        if kind == "item":
            yield x
        elif kind == "error":
            raise RuntimeError("prefetch worker failed") from x
        else:
            return


class HostSlots:
    """A ring of host batch buffers, reused batch after batch.

    Pinned (``pin_memory``), a slot is refilled only once the copy out of it
    has finished: :func:`to_device` records an event in the batch
    (``"_copied"``) and the slot's next fill waits on it.  Three slots
    cover a batch being consumed, one ready in :func:`prefetch_iter`'s
    queue and one being filled.  Unpinned (no card), each batch gets fresh
    tensors, since a CPU consumer keeps views of them.
    """

    def __init__(self, pin_memory: bool, num_slots: int = 3):
        self.pin = pin_memory
        self.slots: list[dict] = [{} for _ in range(num_slots)]
        self.next = 0

    def take(self, spec: dict[str, tuple[tuple, torch.dtype]]) -> dict:
        if not self.pin:
            return {k: torch.empty(shape, dtype=dt) for k, (shape, dt) in spec.items()}
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if "_copied" in slot:
            slot["_copied"].synchronize()
        for k, (shape, dt) in spec.items():
            if k not in slot or slot[k].shape != shape or slot[k].dtype != dt:
                slot[k] = torch.empty(shape, dtype=dt, pin_memory=True)
        slot["_copied"] = torch.cuda.Event()
        return {k: slot[k] for k in (*spec, "_copied")}


def stack_frames(slots: HostSlots, pool: ThreadPoolExecutor, loaders: list, size: tuple,
                 extra: dict[str, np.ndarray] | None = None) -> dict:
    """One batch in a host slot: row ``i`` of obs_rgb (uint8), obs_depth
    (the uint16 samples in int16 storage) and obs_mask (bool) is filled by
    a pool worker from ``loaders[i]()`` -> (rgb, depth, mask) of ``size``
    (H, W); each array of ``extra`` (poses, classes) is copied in whole, so
    the batch reaches the card in pinned copies only."""
    n, (h, w) = len(loaders), size
    spec = {"obs_rgb": ((n, h, w, 3), torch.uint8), "obs_depth": ((n, h, w), torch.int16),
            "obs_mask": ((n, h, w), torch.bool)}
    extra = {k: np.ascontiguousarray(v) for k, v in (extra or {}).items()}
    spec.update({k: (v.shape, torch.from_numpy(v[:0]).dtype) for k, v in extra.items()})
    out = slots.take(spec)
    rgb, depth, mask = (out["obs_rgb"].numpy(), out["obs_depth"].numpy().view(np.uint16),
                        out["obs_mask"].numpy())

    def fill(i):
        rgb[i], depth[i], mask[i] = loaders[i]()

    list(pool.map(fill, range(n)))
    for k, v in extra.items():
        out[k].numpy()[...] = v
    return out


def to_device(batch: dict, device: torch.device | str) -> dict:
    """A batch of the loaders on ``device``: each tensor copied with
    ``non_blocking=True``; uint8 ``obs_rgb`` and the uint16 samples of
    ``obs_depth`` converted there to float32 (``/ 255``, ``/ DEPTH_FACTOR``,
    divided by a device tensor: IEEE division, bit for bit the host's).
    Records the copy's event for the batch's host slot; entries that are
    not tensors (that event) are left out."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "_copied" or not isinstance(v, torch.Tensor):
            continue
        out[k] = v.to(device, non_blocking=True)
    if batch.get("_copied") is not None and device.type == "cuda":
        batch["_copied"].record()
    if out.get("obs_rgb") is not None and out["obs_rgb"].dtype == torch.uint8:
        out["obs_rgb"] = out["obs_rgb"].float() / torch.tensor(255.0, device=device)
    if out.get("obs_depth") is not None and out["obs_depth"].dtype == torch.int16:
        samples = out["obs_depth"].int() & 0xFFFF
        out["obs_depth"] = samples.float() / torch.tensor(DEPTH_FACTOR, device=device)
    return out


def _pin_default(pin_memory: bool | None) -> bool:
    return torch.cuda.is_available() if pin_memory is None else pin_memory


def iter_frame_batches(dataset: LM6DDataset, records: list[FrameRecord], batch_size: int,
                       pad_to: int | None = None, pin_memory: bool | None = None,
                       num_threads: int = 4, extra: dict[str, np.ndarray] | None = None):
    """Yield frame batches of exactly ``batch_size`` records (obs_rgb,
    obs_depth, obs_mask as :func:`stack_frames` gives them; :func:`to_device`
    converts), each frame decoded and stacked by a worker of the decode
    pool.

    A 13k-frame 480x640 test set is ~48 GB as float32, so evaluation
    streams.  ``pad_to`` repeats the last record to fill the last batch
    (callers drop the padded rows).  Wrap in :func:`prefetch_iter` to
    overlap decoding with the device.  ``pin_memory`` (default: whether
    CUDA is available) stacks into a ring of pinned buffers.  ``extra``
    arrays (one row a padded record: poses, classes) ride in the same
    slots, batch by batch.
    """
    n = pad_to or len(records)
    if n % batch_size:
        raise ValueError(f"pad_to={n} is not a multiple of the batch size {batch_size}")
    recs = list(records) + [records[-1]] * (n - len(records))
    slots = HostSlots(_pin_default(pin_memory))
    pool = thread_pool(num_threads)
    size = read_size(dataset._obs(recs[0].scene, recs[0].frame, "color.png"))
    for i in range(0, n, batch_size):
        yield stack_frames(slots, pool, [partial(dataset.load_frame_raw, r)
                                         for r in recs[i:i + batch_size]], size,
                           {k: v[i:i + batch_size] for k, v in (extra or {}).items()})


def make_eval_arrays(dataset: LM6DDataset, records: list[FrameRecord],
                     pad_to: int | None = None) -> dict[str, np.ndarray]:
    """A record list stacked into dense numpy arrays (float frames, GT and
    init poses, classes); ``pad_to`` repeats the last record."""
    n = len(records)
    recs = list(records) + [records[-1]] * ((pad_to or n) - n)
    frames = load_frames_prefetched(dataset, recs)
    return {
        "obs_rgb": np.stack([f["obs_rgb"] for f in frames]),
        "obs_depth": np.stack([f["obs_depth"] for f in frames]),
        "obs_mask": np.stack([f["obs_mask"] for f in frames]),
        "pose_gt": np.stack([r.pose for r in recs]),
        "init_pose": np.stack([r.init_pose if r.init_pose is not None else r.pose
                               for r in recs]),
        "class_idx": np.asarray([r.class_idx for r in recs], np.int32),
        "num_real": n,
    }


def apply_bop_init(records: list[FrameRecord], init: np.ndarray, csv_path: str,
                   obj_ids: list[int] | None = None) -> int:
    """Overwrite ``init[i]`` with the external init pose of a BOP results
    CSV matched by (scene_id, im_id, obj_id) -> the match count.

    ``obj_ids`` maps ``class_idx`` to the dataset's real BOP object id
    (``dataset.obj_ids``); without it the positional ``class_idx + 1``
    only matches CSVs this repo wrote.  Of several estimates for one
    target, the highest-scored wins.  Records whose scene or frame name is
    not an integer are skipped.  ``init`` is changed in place.
    """
    from deepim_tpu_torch.eval.bop_results import read_bop_csv

    if obj_ids is not None:
        n_cls = max((r.class_idx for r in records), default=-1) + 1
        if len(obj_ids) < n_cls:
            raise ValueError(
                f"dataset.obj_ids has {len(obj_ids)} entries but records reference {n_cls} "
                "classes — the id map must cover every object in dataset.objects")
    bop = read_bop_csv(csv_path)
    best: dict = {}  # (scene, im, obj) -> (score, pose)
    for s, im, o, sc, p in zip(bop["scene_ids"], bop["im_ids"], bop["obj_ids"],
                               bop["scores"], bop["poses"]):
        key = (int(s), int(im), int(o))
        if key not in best or sc > best[key][0]:
            best[key] = (sc, p)
    matched = 0
    for i, rec in enumerate(records):
        oid = obj_ids[rec.class_idx] if obj_ids else rec.class_idx + 1
        try:
            key = (int(rec.scene), int(rec.frame), int(oid))
        except ValueError:
            continue
        hit = best.get(key)
        if hit is not None:
            init[i] = hit[1]
            matched += 1
    return matched


class TrainBatcher:
    """Shuffled-epoch minibatches of on-disk frames (the reference's
    ``TrainDataLoader``, on-disk half).

    Every epoch takes a fresh ``np.random.RandomState(seed)`` permutation of
    the merged roidb, as the reference does.  The next batch loads on a
    background thread (decoded on the pool, stacked into a host slot)
    while the caller trains on this one.  Batches: obs_rgb, obs_depth,
    obs_mask (as :func:`stack_frames`), pose_tgt (B, 3, 4) float32 and
    class_idx (B,) int64; :func:`to_device` moves them.  A worker's
    exception is re-raised at :meth:`next` with its cause chained, and the
    iterator stays usable.

    ``num_shards``/``shard_index`` shard the roidb across ranks
    (``records[shard_index::num_shards]``; ``batch_size`` is then the
    rank's slice, ``parallel.process_local_batch_size(global_batch)``).
    """

    def __init__(self, dataset: LM6DDataset, objects: list[str], batch_size: int,
                 split: str = "train", seed: int = 0, pin_memory: bool | None = None,
                 num_threads: int = 4, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.records = [r for obj in objects for r in dataset.gt_roidb(obj, split)]
        if num_shards > 1:
            self.records = self.records[shard_index::num_shards]
        if not self.records:
            raise ValueError(f"no '{split}' records under {dataset.root}"
                             + (f" for shard {shard_index}/{num_shards}"
                                if num_shards > 1 else ""))
        self._rng = np.random.RandomState(seed)
        self._order: list[int] = []
        self._slots = HostSlots(_pin_default(pin_memory))
        self._pool = thread_pool(num_threads)
        self.wait_s = 0.0  # time next() spent waiting on the loader
        self._start_next()

    @property
    def num_records(self) -> int:
        return len(self.records)

    def _take(self) -> list[FrameRecord]:
        out = []
        while len(out) < self.batch_size:
            if not self._order:
                self._order = list(self._rng.permutation(len(self.records)))
            out.append(self.records[self._order.pop()])
        return out

    def _load(self, recs: list[FrameRecord]) -> dict:
        r0 = recs[0]
        return stack_frames(
            self._slots, self._pool, [partial(self.dataset.load_frame_raw, r) for r in recs],
            read_size(self.dataset._obs(r0.scene, r0.frame, "color.png")),
            {"pose_tgt": np.stack([r.pose for r in recs]),
             "class_idx": np.asarray([r.class_idx for r in recs], np.int64)})

    def _start_next(self):
        recs = self._take()
        box: dict = {}

        def work():
            try:
                box["batch"] = self._load(recs)
            except BaseException as e:  # noqa: BLE001 — re-raised in next()
                box["error"] = e

        self._pending = box
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self) -> dict:
        t0 = time.perf_counter()
        self._thread.join()
        self.wait_s += time.perf_counter() - t0
        box = self._pending
        self._start_next()  # also past a bad batch: the iterator stays usable
        if "error" in box:
            raise RuntimeError("TrainBatcher prefetch worker failed while loading a "
                               "batch") from box["error"]
        return box["batch"]
