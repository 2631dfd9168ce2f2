"""Config system: typed dataclass defaults + YAML experiment overlay.

Port of ``deepim_tpu/config/config.py``: the same dataclasses, field for
field and default for default (so every experiment YAML of the repo loads
into both packages alike), ``QUANT_MODES``, ``_validate``, ``_merge``,
``update_config``, ``config_from_dict`` and ``save_config``.

Differences: ``yaml`` is imported only by the function that reads a file
(the card's machine may lack PyYAML; ``config_from_dict`` needs none, and
``save_config`` writes its YAML itself), and ``_validate`` checks the flow
stride against this module's own copy of the flow pyramid's
``FLOW_LEVEL_WEIGHTS``.  Fields that select a JAX renderer
(``train.renderer``, ``test.renderer``) are kept so the YAMLs load; in the port they select nothing: the device of
the tensors decides between the CUDA kernels and their plain versions.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class NetworkConfig:
    rot_type: str = "quat"  # "quat" | "euler"  (reference ROT_TYPE)
    class_agnostic: bool = False  # single shared head (ModelNet
    # unseen-category mode: refine classes never seen in training)
    with_flow: bool = True  # flow aux head (reference PRED_FLOW)
    with_mask: bool = True  # mask aux head
    input_mask: bool = False  # 8-ch input: append rendered + observed
    # segmentation masks to the RGB pair (reference INPUT_MASK cfg)
    input_depth: bool = False  # +2 ch: append rendered + observed depth
    # (reference INPUT_DEPTH cfg), each normalized by the current
    # estimate's object z (d/z - 1; background 0) for depth-scale
    # invariance
    pose_head: str = "flatten"  # "flatten" (reference) | "gap"
    fc_dim: int = 1024
    input_height: int = 480  # network input after dynamic zoom
    input_width: int = 640
    dtype: str = "bfloat16"  # compute dtype ("float32" for CPU tests)
    # Coarse-to-fine refinement: resolution for the first
    # ``test.coarse_iters`` refine iterations (0 = half of input_*).  The
    # flatten pose head is shared across resolutions by resizing the
    # bottleneck to the full-resolution grid (models.flownet head_grid).
    coarse_height: int = 0
    coarse_width: int = 0
    # MXNet symmetric conv padding (pad=k//2).  REQUIRED when running
    # weights converted from reference MXNet checkpoints: XLA's SAME
    # shifts the stride-2 encoder convs one pixel vs MXNet (proven in
    # tests/test_convert_math.py).  Default off: self-trained SAME
    # checkpoints stay loadable.
    mxnet_pad: bool = False
    # Quantized INFERENCE: "int8" (dynamic per-sample activation scales,
    # per-output-channel weight scales) or "int8_static" (calibrated
    # static activation scales — entry points run a short calibration
    # pass over real batches first; see models/quant.py).  Applied only
    # by inference entry points (cli.test/serve/bench) — training always
    # runs the configured f32/bf16 dtype, and the parameter tree is
    # unchanged, so any checkpoint serves both modes.  "none" = off.
    # Validated against QUANT_MODES at config load.
    quant: str = "none"


@dataclass
class TrainConfig:
    batch_size: int = 16  # global (split over the data mesh axis)
    num_steps: int = 20000
    optimizer: str = "sgd"  # "sgd" (reference: SGD+momentum) | "adam"
    lr: float = 1e-4
    momentum: float = 0.975
    weight_decay: float = 5e-4
    warmup_steps: int = 500
    lr_decay_steps: tuple = (12000, 17000)  # reference lr_step epochs analog
    lr_decay_factor: float = 0.1
    grad_clip: float = 10.0
    # SE(3) perturbation noise for synthetic src poses (reference
    # TRAIN noise: gaussian per-axis angles + gaussian translation).
    rot_noise_deg: float = 15.0
    rot_noise_max_deg: float = 45.0
    trans_noise: tuple = (0.01, 0.01, 0.05)
    trans_noise_max: tuple = (0.03, 0.03, 0.15)
    # On-disk datasets: fraction of steps trained on in-graph synthetic
    # pairs instead of disk frames (reference merges real + syn roidbs).
    syn_fraction: float = 0.5
    train_iter: int = 1  # iterative training (reference update_data_batch)
    # Fraction of synthetic train steps run at the coarse resolution
    # (network.coarse_height/width) so one checkpoint serves the
    # coarse-to-fine eval schedule (test.coarse_iters).  0 = all full-res.
    coarse_fraction: float = 0.0
    w_pm: float = 1.0
    # "pm" (point-matching, the paper's main loss) | "separate" (direct
    # L1 on the untangled delta: quat-up-to-sign + trans — the
    # reference's alternative loss wiring / paper ablation baseline).
    pose_loss: str = "pm"
    w_rot: float = 1.0
    w_trans: float = 1.0
    # Symmetry-aware PM loss (min over the object's symmetry set).  Turn
    # OFF when object textures/colors resolve the symmetry and the raw-
    # rotation metrics matter: min-over-sym lets training snap symmetric
    # objects to any equivalent slot, which coarse-resolution steps
    # reinforce until even full-res refinement stops color-locking
    # (measured: 5deg5cm 98 -> 62 after mixed-res fine-tuning with
    # sym-aware PM; exact-pose PM restores the lock).
    sym_aware_pm: bool = True
    w_flow: float = 0.1
    w_mask: float = 0.1
    # Pixel stride of the flow-GT visibility (occlusion) check.  The flow
    # loss pools its masks to the decoder pyramid (finest level = 4 px),
    # so the default matches supervision granularity; 1 = the reference's
    # per-pixel check (a full-res scattered gather XLA:TPU runs at
    # ~70M idx/s — it was 66% of the flagship train step; DESIGN §20).
    flow_occ_stride: int = 4
    renderer: str = "pallas"  # kept for the YAMLs; selects nothing here
    checkpoint_every: int = 1000
    log_every: int = 20
    seed: int = 3
    debug_nans: bool = False  # jax_debug_nans for CI runs (SURVEY.md §5)
    # Pretrained init (reference: load FlowNet arg_params, re-init new
    # heads): checkpoint dir of another experiment; matching-shape params
    # load, conv kernels wider in input channels load the overlapping
    # slice (RGB -> RGB-D transfer), everything else keeps fresh init.
    pretrained: str = ""
    pretrained_step: int = 0  # 0 = latest step in the source dir
    # Substrings forcing a fresh init even on a shape match (per-class
    # fine-tune: ("fc_rot", "fc_trans")).
    pretrained_reinit: tuple = ()


@dataclass
class TestConfig:
    test_iter: int = 4  # reference cfg.TEST.test_iter
    # Run the first N of test_iter iterations at the coarse resolution
    # (network.coarse_height/width); 0 = all iterations at full res.
    coarse_iters: int = 0
    batch_size: int = 16
    renderer: str = "pallas"  # kept for the YAMLs; selects nothing here
    init: str = "perturb"  # "perturb" (noisy GT) | "posecnn" (external init)
    init_pose_dir: str = ""  # PoseCNN-style init poses when init="posecnn"


@dataclass
class DatasetConfig:
    name: str = "synthetic"  # synthetic | lm6d | lm6d_occ | ycb | modelnet
    root: str = "data"
    objects: tuple = ("box", "icosphere", "cylinder", "torus")
    # BOP object ids parallel to ``objects`` (used to match/emit external
    # BOP results CSVs).  Empty = positional default ``class_idx + 1``,
    # which only round-trips CSVs written by this repo; real datasets need
    # the true ids (e.g. LINEMOD 'driller' is BOP obj 8 — ids 1..15 with
    # bowl/cup absent from the 13-class protocol).
    obj_ids: tuple = ()
    # Evaluation object set; empty = same as ``objects``.  Distinct sets +
    # network.class_agnostic reproduce the reference's ModelNet
    # unseen-category protocol (refine meshes never seen in training).
    eval_objects: tuple = ()
    # ModelNet-protocol shape zoo (dataset.name == "modelnet"): train on
    # zoo_size random-parameter procedural meshes, evaluate on eval_objects
    # (category-level generalization needs many training shapes).
    zoo_size: int = 24
    zoo_seed: int = 0
    # Zoo shape families to train on; empty = all.  Excluding the eval
    # shapes' families makes the protocol truly unseen-CATEGORY.
    zoo_families: tuple = ()
    # Real CAD meshes for the ModelNet protocol: a directory of
    # .off/.obj/.ply files.  When set (dataset.name == "modelnet"), the
    # EVAL set loads every mesh in the directory (sorted by filename,
    # normalized to cad_diameter meters) instead of procedural
    # eval_objects — the reference's actual unseen-category ModelNet
    # evaluation (SURVEY.md §2.3).
    cad_dir: str = ""
    cad_diameter: float = 0.15  # normalized CAD object diameter (m)
    image_height: int = 480
    image_width: int = 640
    # Default LINEMOD intrinsics (the reference's LM6d K).
    fx: float = 572.4114
    fy: float = 573.5704
    cx: float = 325.2611
    cy: float = 242.0490
    max_faces: int = 4096  # decimation budget per mesh
    # Coarse level-of-detail face budget for coarse-to-fine refinement:
    # the refine loop's COARSE iterations render every mesh decimated to
    # this budget (RenderAssets.lod).  They only correct gross pose error
    # at half resolution, so ~1k faces is visually sufficient while
    # cutting the dense-mesh raster cost ~2x per coarse iteration
    # (measured at the 4,096-face real-asset budget, B=128 v5e).
    # 0 disables (coarse iterations render the full max_faces level).
    lod_faces: int = 1024
    num_points: int = 3000  # PM-loss / metric point samples
    # Per-pixel texture sampling for textured meshes (YCB-style): "auto"
    # uses the deferred-texturing raster path when meshes carry textures,
    # "off" forces baked vertex colors (cheaper; no per-pixel texture
    # gather), "on" requires textures.
    use_textures: str = "auto"  # auto | on | off
    # Fraction of procedural/zoo meshes that get a random procedural
    # texture + planar UVs (YCB-scanned-mesh stand-in; the repo ships no
    # real textured assets).  With use_textures "auto"/"on" these train
    # and evaluate through the per-pixel deferred-texturing raster path.
    texture_prob: float = 0.0
    znear: float = 0.25
    zfar: float = 6.0


@dataclass
class Config:
    network: NetworkConfig = field(default_factory=NetworkConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    output_dir: str = "output"
    experiment: str = "default"


# cfg.network.quant values the entry points understand.
QUANT_MODES = ("none", "int8", "int8_static")

# The flow loss's pyramid levels (2 = 1/4 scale) and their weights: a copy
# of ``deepim_tpu/losses/losses.py §FLOW_LEVEL_WEIGHTS``, which the flow
# stride check below reads.
FLOW_LEVEL_WEIGHTS = {6: 0.32, 5: 0.08, 4: 0.04, 3: 0.02, 2: 0.01}


def _validate(cfg: "Config") -> "Config":
    """Reject config values that would otherwise fail silently downstream."""
    if cfg.network.quant not in QUANT_MODES:
        raise ValueError(
            f"network.quant={cfg.network.quant!r} is not one of "
            f"{QUANT_MODES} — a typo here would silently run the plain "
            "unquantized path")
    if cfg.train.flow_occ_stride < 1:
        raise ValueError(
            f"train.flow_occ_stride={cfg.train.flow_occ_stride} must be "
            ">= 1 (1 = the reference's per-pixel visibility check)")
    # The stride is only supervision-exact while it stays at or below the
    # flow pyramid's finest level (level 2 = 1/4 scale); a finer future
    # pyramid must lower the stride with it.
    finest = 2 ** min(FLOW_LEVEL_WEIGHTS)
    if cfg.train.flow_occ_stride > finest:
        raise ValueError(
            f"train.flow_occ_stride={cfg.train.flow_occ_stride} exceeds "
            f"the flow pyramid's finest supervision cell ({finest} px) — "
            "the visibility mask would be coarser than the loss resolves")
    return cfg


def _merge(dc, overrides: dict[str, Any]):
    """Deep-merge a dict onto a dataclass (reference ``update_config``
    semantics: unknown keys are errors, nested dicts recurse)."""
    updates = {}
    names = {f.name: f for f in dataclasses.fields(dc)}
    for key, val in overrides.items():
        if key not in names:
            raise KeyError(
                f"unknown config key '{key}' for {type(dc).__name__}"
            )
        cur = getattr(dc, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = _merge(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            updates[key] = tuple(val)
        else:
            updates[key] = type(cur)(val) if cur is not None else val
    return dataclasses.replace(dc, **updates)


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading or writing a YAML config needs PyYAML (the "
                          "'yaml' module); config_from_dict needs none") from e
    return yaml


def update_config(yaml_path: str, base: Config | None = None) -> Config:
    """Load an experiment YAML over the defaults -> Config."""
    yaml = _yaml()
    with open(yaml_path) as f:
        overrides = yaml.safe_load(f) or {}
    return _validate(_merge(base or Config(), overrides))


def config_from_dict(overrides: dict[str, Any], base: Config | None = None) -> Config:
    return _validate(_merge(base or Config(), overrides))


def _scalar(v) -> str:
    """One config value as a YAML 1.1 scalar or flow list that PyYAML reads
    back as the same value (floats always carry a dot: '1.0e-05')."""
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mant, _, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        return mant + ("e" + exp if exp else "")
    return json.dumps(str(v))  # a JSON string is a YAML double-quoted scalar


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as YAML (block mappings of scalars) -> ``update_config``
    reads it back equal, with no PyYAML needed to write it."""
    lines = []
    for key, val in dataclasses.asdict(cfg).items():
        if isinstance(val, dict):
            lines.append(f"{key}:")
            lines += [f"  {k}: {_scalar(v)}" for k, v in val.items()]
        else:
            lines.append(f"{key}: {_scalar(val)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
