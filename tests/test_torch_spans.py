"""deepim_tpu_torch.utils.profiling's spans and host-sync counter (CPU, and
three cases on the card that skip without one).

- Off (no profiler recording): ``stage`` hands back one shared no-op,
  records nothing, opens no ``record_function`` and allocates nothing.
- On: ids, parents, roots and attrs; the buffer's cap and drop counter;
  a span's ``time.time_ns()`` bracket holds the kineto event of the op
  run inside it; syncs land on the innermost open span (here a stub
  raises the warning CUDA's sync debug mode raises).
- A tiny ``refine_poses`` and a tiny fused train step record the span
  trees of PERF.md §3, every ``render.*`` span under a ``render``.  A
  one-convolution stand-in for the network keeps them to a second.
- On the card: a kernel's device interval lies inside the span that
  launched and waited for it, a planted ``int(t.max())`` counts 1, and
  the network's conv1, under its ``network.conv1`` span, launches no
  kernel of cuDNN's generic CUDA-core engine.

Nothing here imports JAX, so the card cases run on the card's machine:
``python -m pytest --noconftest tests/test_torch_spans.py -m card``.
"""

import threading
import time
import tracemalloc
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data import synthetic_batch
from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
from deepim_tpu_torch.refine import build_assets, refine_poses
from deepim_tpu_torch.train import train as train_t
from deepim_tpu_torch.utils import profiling
from deepim_tpu_torch.utils.profiling import SYNC_WARNING, clear_spans, spans, stage

CPU = torch.profiler.ProfilerActivity.CPU
K = np.array([[120.0, 0, 48.0], [0, 120.0, 32.0], [0, 0, 1]], np.float32)
IMG = (64, 96)
ITER_CHILDREN = ["zoom.box", "render", "zoom.image", "network.input", "network.forward"]
RENDER_CHILDREN = ["render.pack", "render.bin", "render.raster"]


class TinyNet(torch.nn.Module):
    """What ``refine_poses`` and the train step read of ``DeepIMFlowNet``:
    pose heads on the pooled input, flow and mask on a 1x1 convolution."""

    rot_type = "quat"
    input_mask = input_depth = False
    with_flow = with_mask = True

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes, self.head_grid = num_classes, (1, 1)
        self.pose = torch.nn.Linear(6, num_classes * 7)
        self.conv = torch.nn.Conv2d(6, 3, 1)

    def forward(self, x, pose_only=False):
        x = x.permute(0, 3, 1, 2)
        p = self.pose(x.mean((2, 3))).reshape(-1, self.num_classes, 7)
        out = {"rot_raw": p[..., :4] + torch.tensor([1.0, 0.0, 0.0, 0.0]),
               "trans": 0.01 * p[..., 4:]}
        if not pose_only:
            y = self.conv(F.avg_pool2d(x, 4)).permute(0, 2, 3, 1)
            out["flow"], out["mask_logit"] = {2: y[..., :2]}, y[..., 2:]
        return out


@pytest.fixture(scope="module")
def assets():
    meshes = [box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05, subdivisions=2)]
    return build_assets(meshes, num_points=32, device="cpu")


def _recorded(fn):
    """Run ``fn`` under a CPU profiler -> the spans it recorded."""
    clear_spans()
    with torch.profiler.profile(activities=[CPU]):
        fn()
    return spans()


def _tree(recorded, parent=None):
    """[(name, subtree)] of ``parent``'s children, in the order they opened."""
    kids = sorted((s for s in recorded if s.parent == parent), key=lambda s: s.start_ns)
    return [(s.name, _tree(recorded, s.id)) for s in kids]


def _names(tree):
    return [name for name, _ in tree]


def _render_tree_ok(tree):
    """Every ``render.*`` span sits directly under a ``render``."""
    for name, sub in tree:
        if name == "render":
            assert _names(sub) == RENDER_CHILDREN
        else:
            assert not any(n.startswith("render.") for n in _names(sub)), name
            _render_tree_ok(sub)


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: opened.append(a))
    clear_spans()
    assert not torch.autograd._profiler_enabled()
    assert stage("render") is stage("refine.iter", it=0, coarse=True)
    for _ in range(100):  # warm anything lazily allocated once
        with stage("render"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10000):
            with stage("render"):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024  # nothing kept per call
    assert opened == [] and spans() == ()


def test_nesting_ids_parents_roots_and_attrs():
    def work():
        with stage("a", batch=2):
            with stage("b", it=0):
                with stage("c"):
                    pass
            with stage("b", it=1):
                pass
        with stage("d"):
            pass

    got = {(s.name, s.attrs.get("it")): s for s in _recorded(work)}
    a, b0, b1, c, d = (got[k] for k in (("a", None), ("b", 0), ("b", 1), ("c", None),
                                        ("d", None)))
    assert a.parent is None and a.root == a.id and dict(a.attrs) == {"batch": 2}
    assert b0.parent == b1.parent == a.id and c.parent == b0.id
    assert {b0.root, b1.root, c.root} == {a.id} and d.root == d.id != a.id
    assert a.start_ns <= b0.start_ns <= c.start_ns <= c.end_ns <= b0.end_ns <= b1.start_ns
    assert b1.end_ns <= a.end_ns <= d.start_ns
    with pytest.raises(TypeError):  # records are read-only
        a.attrs["batch"] = 3


def test_buffer_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)

    def work():
        for i in range(8):
            with stage("s", i=i):
                pass

    got = _recorded(work)
    assert [s.attrs["i"] for s in got] == [0, 1, 2, 3, 4]
    assert profiling.dropped_spans() == 3
    clear_spans()
    assert spans() == () and profiling.dropped_spans() == 0


def test_span_brackets_the_kineto_event_of_its_op():
    """Kineto stamps its events on ``time.time_ns()``'s clock."""
    a = torch.ones(128, 128)
    clear_spans()
    with torch.profiler.profile(activities=[CPU]) as prof:
        with stage("mm"):
            a @ a
    (span,) = spans()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span.start_ns <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() \
        <= span.end_ns
    assert any(e.name() == "mm" for e in prof.profiler.kineto_results.events())


def test_syncs_land_on_the_innermost_open_span():
    """The stub raises what CUDA's sync debug mode raises at each sync;
    other warnings reach the user, and the filters are restored."""
    def sync():
        warnings.warn(f"{SYNC_WARNING} (Triggered internally at CUDAFunctions.cpp)",
                      UserWarning)

    filters = list(warnings.filters)

    def work():
        with stage("root"):
            with stage("inner"):
                sync()
                sync()
                with stage("leaf"):
                    pass
            sync()
            with pytest.warns(RuntimeWarning, match="another"):
                warnings.warn("another warning", RuntimeWarning)
        with stage("second"):
            sync()

    got = {s.name: s for s in _recorded(work)}
    assert {n: s.syncs for n, s in got.items()} == {"root": 1, "inner": 2, "leaf": 0,
                                                  "second": 1}
    # the sync filter was put first once; the two roots mutated nothing more
    assert warnings.filters[0] == profiling._SYNC_FILTER and warnings.filters[1:] == filters
    with pytest.warns(UserWarning, match=SYNC_WARNING):  # no longer counted once closed
        sync()


def test_overlapping_roots_of_two_threads_restore_the_warning_state(monkeypatch):
    """The first root of the process to open installs the watch, the last to
    close removes it, however the roots of two threads interleave."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    clear_spans()
    shown = warnings.showwarning
    a_open, b_open, a_closed = threading.Event(), threading.Event(), threading.Event()
    watched = []

    def sync():
        warnings.warn(SYNC_WARNING, UserWarning)

    def first():
        with stage("a"):
            a_open.set()
            b_open.wait(10)
            sync()
        a_closed.set()

    def second():
        a_open.wait(10)
        with stage("b"):
            b_open.set()
            a_closed.wait(10)
            watched.append(warnings.showwarning is profiling._seen)
            sync()

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert watched == [True]  # a's close left b's root watched
    assert {s.name: s.syncs for s in spans()} == {"a": 1, "b": 1}
    assert warnings.showwarning is shown and profiling._watching == 0


def test_refine_poses_records_its_span_tree(assets):
    batch = synthetic_batch(torch.Generator().manual_seed(0), assets, 2,
                            torch.from_numpy(K), IMG)
    model = TinyNet(assets.num_classes)
    got = _recorded(lambda: refine_poses(
        model, assets, batch["obs_rgb"], batch["pose_src"], batch["k"], batch["class_idx"],
        num_iters=2, out_size=(64, 64), coarse_iters=1, coarse_size=(32, 32)))
    tree = _tree(got)
    assert _names(tree) == ["refine_poses"]
    iters = tree[0][1]
    assert _names(iters) == ["refine.iter", "refine.iter"]
    for _, sub in iters:
        assert _names(sub) == ITER_CHILDREN + ["refine.compose"]
    _render_tree_ok(tree)
    root = next(s for s in got if s.name == "refine_poses")
    assert dict(root.attrs) == {"batch": 2, "iters": 2}
    assert [dict(s.attrs) for s in got if s.name == "refine.iter"] == [
        {"it": 0, "coarse": True, "size": (32, 32)},
        {"it": 1, "coarse": False, "size": (64, 64)}]
    assert {s.root for s in got} == {root.id} and sum(s.syncs for s in got) == 0


def test_synthetic_train_step_records_its_span_tree(assets):
    from deepim_tpu_torch.raster.camera import make_intrinsics

    cfg = config_from_dict({
        "network": {"input_height": 32, "input_width": 32, "dtype": "float32"},
        "dataset": {"objects": ["box", "icosphere"], "image_height": IMG[0],
                    "image_width": IMG[1], "fx": 120.0, "fy": 120.0, "cx": 48.0,
                    "cy": 32.0},
        "train": {"batch_size": 2, "train_iter": 2, "warmup_steps": 0, "lr": 1e-3}})
    model = TinyNet(assets.num_classes)
    state = train_t.init_state(cfg, model)
    step = train_t.make_synthetic_train_step(model, assets, cfg,
                                             make_intrinsics(120.0, 120.0, 48.0, 32.0, "cpu"))
    out = []
    got = _recorded(lambda: out.append(step(state, torch.Generator().manual_seed(0))))
    assert torch.isfinite(out[0][1]["loss"])
    tree = _tree(got)
    assert _names(tree) == ["train.step"]
    parts = tree[0][1]
    assert _names(parts) == ["train.synthesis", "train.iter", "train.iter", "train.backward",
                             "train.optimizer"]
    assert _names(parts[0][1]) == ["render"]
    for _, sub in parts[1:3]:
        assert _names(sub) == ITER_CHILDREN + ["train.losses"]
    _render_tree_ok(tree)
    assert [s.attrs["it"] for s in got if s.name == "train.iter"] == [0, 1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _card_profile():
    """The benchmark's profiler: the card's activity only."""
    return torch.autograd.profiler.profile(use_device="cuda", use_kineto=True, use_cpu=False)


@pytest.mark.card
def test_card_kernel_lies_inside_its_span():
    from torch.autograd import DeviceType

    dev = _card()
    a = torch.randn(2048, 2048, device=dev)
    a @ a
    torch.cuda.synchronize(dev)
    clear_spans()
    with _card_profile() as prof:
        assert torch.autograd._profiler_enabled()
        time.sleep(0.01)
        with stage("mm"):
            a @ a
            torch.cuda.synchronize(dev)
        time.sleep(0.01)
    (span,) = spans()
    kernels = [e for e in prof.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert kernels
    for e in kernels:
        assert span.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= span.end_ns


@pytest.mark.card
def test_card_planted_sync_counts_one():
    dev = _card()
    t = torch.arange(1000, device=dev, dtype=torch.float32)
    clear_spans()
    with _card_profile():
        with stage("root"):
            with stage("planted"):
                int(t.max())
            (t * 2).sum()
    got = {s.name: s.syncs for s in spans()}
    assert got == {"planted": 1, "root": 0}
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.card
def test_card_conv1_takes_no_cuda_core_engine():
    # conv1's 6 input channels, padded to 8 and folded inside
    # network.conv1, leave cuDNN's generic CUDA-core NHWC engine.
    from torch.autograd import DeviceType

    from deepim_tpu_torch.models.flownet import DeepIMFlowNet

    dev = _card()
    net = DeepIMFlowNet(pose_head="gap", fc_dim=16).to(dev).eval()
    x = torch.rand(4, 480, 640, 6, device=dev) - 0.5
    with torch.no_grad():
        net(x, pose_only=True)
        torch.cuda.synchronize(dev)
        clear_spans()
        with _card_profile() as prof:
            net(x, pose_only=True)
            torch.cuda.synchronize(dev)
    kernels = [e.name() for e in prof.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert kernels
    assert [k for k in kernels if "convolve_common_engine" in k] == []
    assert [dict(s.attrs) for s in spans() if s.name == "network.conv1"] == [
        {"cin": 6, "cin_padded": 8}]
