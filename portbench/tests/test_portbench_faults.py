"""A run whose timed path is broken underneath comes out not correct.

Each case drives the rest of a run (set-up, window, the reference's check)
on the CPU at a test's size, the look for a chip skipped, with one fault
planted in the program: answers altered where they are produced
(``portbench/faults.py``: every pose the refine loop returns, the poses
of one class, or the pose in slot 0 of each device batch, moved 2 mm), a
training step that leaves its state unchanged (the optimizer's update
skipped), and a training step on half of its batch (the loss's mean taken
over the rest).  The same runs without the fault come out correct.  The
cells' committed limits apply.
"""

import pytest
import torch

from conftest import tiny
from portbench import faults, run

CELLS = {"refine": "c2f_refine_b128", "serve": "c2f_serve_poisson",
         "train": "synthetic_all_train_b32"}


def execute(kind, seconds=2.0, seed=4294967311, traffic=None):
    torch.set_num_threads(4)
    args = run.parse(["--workload", CELLS[kind], "--seed", str(seed), "--seconds", str(seconds)])
    over = tiny(kind)
    over["traffic"].update(traffic or {})
    return run.execute(args, torch.device("cpu"), over)


@pytest.mark.parametrize("kind", ["refine", "serve", "train"])
def test_sound_runs_are_correct(kind):
    res = execute(kind, seconds=4.0 if kind == "serve" else 2.0)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["refine", "serve"])
def test_an_altered_answer_is_not_correct(kind):
    with faults.plant("all"):
        res = execute(kind, seconds=4.0 if kind == "serve" else 2.0)
    assert not res["correct"]
    share = res["checks"]["pose_off_share"]
    assert share["value"] == 100.0 and share["value"] > share["limit"]


@pytest.mark.parametrize("kind,fault,traffic", [
    ("refine", "class", {"batch": 16, "check_rows_per_batch": 16}),
    ("serve", "slot", {"check_rows": 16}),
])
def test_a_fault_in_part_of_the_batch_is_not_correct(kind, fault, traffic):
    """One class of four, or one slot of each device batch: the largest
    gap catches what the share of poses off may let through."""
    with faults.plant(fault):
        res = execute(kind, seconds=4.0 if kind == "serve" else 2.0, traffic=traffic)
    assert not res["correct"]
    gap = res["checks"]["pose_gap"]
    assert gap["value"] > gap["limit"]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = execute("train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_step_on_half_its_batch_is_not_correct(monkeypatch):
    import deepim_tpu_torch.train.train as train

    full = train.compute_losses

    def half(model, assets, batch, cfg):
        n = batch["class_idx"].shape[0] // 2
        return full(model, assets, {k: v[:n] for k, v in batch.items()}, cfg)

    monkeypatch.setattr(train, "compute_losses", half)
    res = execute("train")
    assert not res["correct"]
    checks = res["checks"]
    assert any(checks[n]["value"] > checks[n]["limit"] for n in ("loss_gap", "grad_gap"))
