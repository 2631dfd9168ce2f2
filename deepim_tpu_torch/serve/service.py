"""Batched pose-refinement service on the card (``deepim_tpu/serve/service.py``).

A thread-safe front over :func:`~deepim_tpu_torch.refine.refine_poses`:

- **One fixed device batch.** Every request is split into samples and
  coalesced into batches of exactly ``batch`` rows, short batches padded
  with their first sample, so the kernels and convolutions always see the
  same shapes.
- **Micro-batching.** One worker thread, the only thread that touches the
  card, fills a batch from the queue up to ``batch`` samples or until a
  short gather window after the first sample has passed.
- **Synchronous facade.** ``refine()`` blocks its caller on one future
  per sample; a batch's error reaches every future of the batch.

The service runs on ``cuda:0`` unless given ``device``; without CUDA it
refuses to start unless the caller asks for the CPU, where the kernels'
plain versions run.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from deepim_tpu_torch.cli.train import load_assets_and_names
from deepim_tpu_torch.config.config import Config, update_config
from deepim_tpu_torch.refine.refiner import refine_poses
from deepim_tpu_torch.train.checkpoint import (
    checkpoint_dir, latest_step, load_params, orbax_dir, require_port_checkpoint,
    restore_checkpoint)
from deepim_tpu_torch.train.train import make_model


@dataclass
class ServiceStats:
    requests: int = 0
    poses: int = 0
    device_batches: int = 0
    padded_slots: int = 0
    # Worker time per phase, summed over batches: stacking the samples on
    # the host and copying them to the device; refine_poses and the copy
    # of its result back.
    host_seconds: float = 0.0
    refine_seconds: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, requests: int = 0, poses: int = 0, batches: int = 0,
               padded: int = 0, host_s: float = 0.0, refine_s: float = 0.0) -> None:
        with self.lock:
            self.requests += requests
            self.poses += poses
            self.device_batches += batches
            self.padded_slots += padded
            self.host_seconds += host_s
            self.refine_seconds += refine_s


def _service_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("PoseRefinerService runs on the card and found no CUDA "
                               "device; pass device='cpu' to serve on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)


class PoseRefinerService:
    """Thread-safe pose refinement over a fixed device batch.

    Args:
        cfg: a Config or a path to an experiment YAML.
        batch_size: device batch (default ``cfg.test.batch_size``).
        load_checkpoint: restore the experiment's latest port checkpoint
            (``train/checkpoint.py §checkpoint_dir``; a training
            checkpoint's decoder is dropped), if it has one; otherwise the
            initial weights of generator seed 0.  Raises when the
            experiment has only the reference's orbax checkpoints (import
            them with ``import_flax_params``).
        gather_window_s: how long the worker waits to fill a batch after
            the first sample arrives.
        num_iters: refine iterations (default ``cfg.test.test_iter``).
        device: where the model, the assets and every batch live (default
            ``cuda:0``).
        calibration_batches: for ``network.quant: int8_static``, the
            eval-style batch dicts (``obs_rgb``, ``pose_src``,
            ``class_idx`` on ``device``) the static activation scales are
            calibrated on at construction; default two
            :func:`~deepim_tpu_torch.data.synthetic_batch` draws of the
            device batch from generators seeded 4200 and 4201 at the
            config's noise model.
        calibration_mode: the estimator (``models/quant.py
            §CALIB_MODES``).

    ``network.quant: int8`` serves the dynamic int8 model; ``int8_static``
    calibrates before the worker starts, and a failed calibration raises
    here: the service never serves an uncalibrated static model.
    """

    def __init__(self, cfg, batch_size: int | None = None,
                 load_checkpoint: bool = True, gather_window_s: float = 0.002,
                 num_iters: int | None = None, device=None,
                 calibration_batches=None, calibration_mode: str = "max_c"):
        if not isinstance(cfg, Config):
            cfg = update_config(cfg)
        self.cfg = cfg
        self.device = _service_device(device)
        self.assets, self.names, _ = load_assets_and_names(cfg, device=self.device)
        self.model = make_model(cfg, self.assets.num_classes, inference=True,
                                generator=torch.Generator().manual_seed(0)
                                ).to(self.device).eval()
        self.step = 0
        ckpt_dir = checkpoint_dir(cfg)
        if load_checkpoint:
            # The reference would serve its trained orbax steps here.
            require_port_checkpoint(ckpt_dir, orbax_dir(cfg))
        if load_checkpoint and latest_step(ckpt_dir) is not None:
            self.step, params = restore_checkpoint(ckpt_dir, device=self.device)
            load_params(self.model, params)

        self.batch = int(batch_size or cfg.test.batch_size)
        self.num_iters = int(num_iters or cfg.test.test_iter)
        self.gather_window_s = gather_window_s
        self.stats = ServiceStats()

        n = cfg.network
        self._out_size = (n.input_height, n.input_width)
        self._coarse = (n.coarse_height, n.coarse_width) if n.coarse_height else None
        self._coarse_iters = cfg.test.coarse_iters
        self._image_size = (cfg.dataset.image_height, cfg.dataset.image_width)
        if n.quant == "int8_static":
            self.model = self._calibrate(calibration_batches, calibration_mode)

        self._queue: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._running = True
        self._worker.start()

    def _calibrate(self, batches, mode: str):
        """The int8_static model: scales from ``batches`` (default two
        synthetic batches, generators seeded 4200 and 4201)."""
        from deepim_tpu_torch.data.synthetic import synthetic_batch
        from deepim_tpu_torch.models.quant import calibrate_model
        from deepim_tpu_torch.raster.camera import make_intrinsics

        d, t = self.cfg.dataset, self.cfg.train
        k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=self.device)
        if batches is None:
            batches = [synthetic_batch(
                torch.Generator(device=self.device).manual_seed(4200 + i), self.assets,
                self.batch, k_cam, self._image_size, rot_noise_deg=t.rot_noise_deg,
                rot_max_deg=t.rot_noise_max_deg, trans_noise=tuple(t.trans_noise),
                trans_max=tuple(t.trans_noise_max)) for i in range(2)]
        return calibrate_model(self.model, self.assets, batches, k_cam, self._out_size,
                               num_iters=self.num_iters, mode=mode)

    # --- public API -------------------------------------------------------

    def refine(self, obs_rgb, init_pose, k, class_idx, obs_depth=None, obs_mask=None):
        """Refine N poses; blocks until done.  Arrays are numpy, shapes
        (N, H, W, 3), (N, 3, 4), (N, 3, 3), (N,) -> (N, 3, 4).

        ``obs_depth`` (N, H, W) metric depth and ``obs_mask`` (N, H, W)
        foreground mask feed the model's ``input_depth``/``input_mask``
        channels and are required when the model has them: serving with
        the rendered-image fallback would silently diverge from how the
        weights were validated.
        """
        if not self._running:
            raise RuntimeError("PoseRefinerService is closed")
        obs_rgb = np.asarray(obs_rgb, np.float32)
        init_pose = np.asarray(init_pose, np.float32)
        k = np.asarray(k, np.float32)
        class_idx = np.asarray(class_idx, np.int32)
        n = obs_rgb.shape[0]
        if n == 0:
            return np.zeros((0, 3, 4), np.float32)
        if obs_rgb.shape[1:3] != self._image_size:
            raise ValueError(f"observed frame {obs_rgb.shape[1:3]} != configured "
                             f"dataset image size {self._image_size}")
        nw = self.cfg.network
        if nw.input_depth and obs_depth is None:
            raise ValueError("model was trained with network.input_depth; "
                             "refine() requires obs_depth")
        if nw.input_mask and obs_mask is None:
            raise ValueError("model was trained with network.input_mask; "
                             "refine() requires obs_mask")
        obs_depth = None if obs_depth is None else np.asarray(obs_depth, np.float32)
        obs_mask = None if obs_mask is None else np.asarray(obs_mask, bool)

        futures = []
        for i in range(n):  # one item per sample; the worker coalesces
            f: Future = Future()
            self._queue.put((obs_rgb[i], init_pose[i], k[i], class_idx[i],
                             None if obs_depth is None else obs_depth[i],
                             None if obs_mask is None else obs_mask[i], f))
            futures.append(f)
        out = np.stack([f.result() for f in futures])
        self.stats.record(requests=1, poses=n)
        return out

    def close(self) -> None:
        self._running = False
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=10)
        # Fail what is still queued: its callers would wait forever.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[-1].done():
                item[-1].set_exception(RuntimeError(
                    "PoseRefinerService closed before this request was processed"))

    # --- worker -----------------------------------------------------------

    def _gather(self):
        """Block for one item, then fill up to ``self.batch`` within the
        gather window."""
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self.gather_window_s
        while len(items) < self.batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the shutdown for the next loop
                break
            items.append(nxt)
        return items

    def _worker_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        nw = self.cfg.network
        dev = self.device

        def col(items, j, pad):
            rows = np.stack([it[j] for it in items] + [items[0][j]] * pad)
            return torch.from_numpy(rows).to(dev)

        while self._running:
            items = self._gather()
            if items is None:
                break
            pad = self.batch - len(items)
            try:
                t0 = time.perf_counter()
                obs, poses, ks, cls = (col(items, j, pad) for j in range(4))
                # refine() puts depth and mask on every item when the model
                # reads them; otherwise they are ignored.
                depth = col(items, 4, pad) if nw.input_depth else None
                mask = col(items, 5, pad) if nw.input_mask else None
                t1 = time.perf_counter()
                out = refine_poses(
                    self.model, self.assets, obs, poses, ks, cls,
                    num_iters=self.num_iters, out_size=self._out_size,
                    obs_depth=depth, obs_mask=mask,
                    coarse_iters=self._coarse_iters, coarse_size=self._coarse,
                ).cpu().numpy()
                t2 = time.perf_counter()
            except Exception as e:  # a device error reaches every caller
                for it in items:
                    if not it[-1].done():
                        it[-1].set_exception(e)
                continue
            for i, it in enumerate(items):
                it[-1].set_result(out[i])
            self.stats.record(batches=1, padded=pad, host_s=t1 - t0, refine_s=t2 - t1)
