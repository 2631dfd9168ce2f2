"""deepim_tpu_torch.tools.supervise_train against tests/test_supervisor.py
(CPU): its seven cases (the probe gating, the probe itself on the CPU and
timing out, the done marker, the per-launch step scan), the forwarded
``--device`` picking the probe's device, and a supervised ``cli.train`` on
the CPU killed with SIGKILL after its first checkpoint: the supervisor
relaunches it with ``--resume``, it resumes from that checkpoint and the
supervisor exits 0 on the done line.

The other tools are tests/test_torch_tools.py's.
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml

from deepim_tpu_torch.tools import supervise_train as sup

ROOT = Path(__file__).resolve().parents[1]


# -- supervise_train: the cases of tests/test_supervisor.py ---------------------


def test_wait_for_device_no_wait_when_alive():
    sleeps = []
    sup.wait_for_device(alive=lambda _t: True, sleep=sleeps.append)
    assert sleeps == []


def test_wait_for_device_retries_until_alive():
    answers = iter([False, False, True])
    sleeps = []
    sup.wait_for_device(alive=lambda _t: next(answers), sleep=sleeps.append, retry_sec=7)
    assert sleeps == [7, 7]


def test_device_alive_on_the_cpu():
    # the probe subprocess does its round trip through the CPU device
    assert sup.device_alive(timeout_sec=300, device="cpu")


def test_device_alive_times_out(monkeypatch):
    # A probe that can never finish inside the timeout reports dead
    # rather than hanging the supervisor.
    monkeypatch.setattr(sup, "PROBE_SRC", "import time; time.sleep(60)")
    assert not sup.device_alive(timeout_sec=1)


def test_tail_done(tmp_path):
    log = tmp_path / "t.log"
    log.write_bytes(b"step 99/100\n")
    assert not sup.tail_done(str(log))
    log.write_bytes(b"step 100/100\ndone; checkpoints in /x\n")
    assert sup.tail_done(str(log))


def test_stepped_since_scopes_to_current_launch(tmp_path):
    # Step lines from a PREVIOUS run (before the relaunch offset) must
    # not count: a relaunched process is starting up again and needs the
    # 3x start-up budget, not the 1x steady-state budget.
    log = tmp_path / "t.log"
    log.write_bytes(b"launch\nstep 100/200 loss=1\nstep 200/200\n")
    offset = log.stat().st_size
    assert not sup.stepped_since(str(log), offset)
    with open(log, "ab") as f:
        f.write(b"relaunch banner\nstarting...\n")
    assert not sup.stepped_since(str(log), offset)
    with open(log, "ab") as f:
        f.write(b"step 201/400 loss=1\n")
    assert sup.stepped_since(str(log), offset)


def test_stepped_since_fresh_log_and_straddle(tmp_path):
    log = tmp_path / "t.log"
    log.write_bytes(b"step 1/10\n")
    assert sup.stepped_since(str(log), 0)  # file-start step line counts
    # A "\nstep " whose newline falls exactly at the offset still counts.
    log.write_bytes(b"banner")
    off = log.stat().st_size
    with open(log, "ab") as f:
        f.write(b"\nstep 2/10\n")
    assert sup.stepped_since(str(log), off + 1)
    assert not sup.stepped_since(str(tmp_path / "missing.log"), 0)


@pytest.mark.parametrize("extra,device", [
    ([], "cuda:0"), (["--", "--device", "cpu"], "cpu"), (["--device=cuda:1"], "cuda:1"),
    (["--num-steps", "5"], "cuda:0")])
def test_the_probe_takes_the_forwarded_device(extra, device):
    assert sup.train_device(extra) == device


def _spec(tmp_path, **train):
    return {
        "experiment": "tools", "output_dir": str(tmp_path / "out"),
        "network": {"input_height": 48, "input_width": 64, "dtype": "float32", "fc_dim": 32,
                    "with_flow": False, "with_mask": False},
        "dataset": {"name": "synthetic", "objects": ["box", "icosphere"], "image_height": 48,
                    "image_width": 64, "fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0,
                    "num_points": 64},
        "train": {"batch_size": 2, "num_steps": 2, "optimizer": "adam", "lr": 1e-4,
                  "log_every": 1, "checkpoint_every": 2, "warmup_steps": 0, "w_flow": 0.0,
                  "w_mask": 0.0, **train},
        "test": {"test_iter": 2, "batch_size": 4},
    }


def _cfg(tmp_path, **train) -> str:
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_spec(tmp_path, **train)))
    return str(path)


def test_supervised_training_recovers_from_a_kill(tmp_path):
    from deepim_tpu_torch.train.checkpoint import latest_step

    cfg = _cfg(tmp_path, num_steps=30)
    ckpt = tmp_path / "out" / "tools" / "checkpoints_torch"
    log = tmp_path / "sup.log"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "deepim_tpu_torch.tools.supervise_train", "--cfg", cfg,
         "--log", str(log), "--poll-sec", "0.5", "--", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    lines, killed = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"launched pid (\d+)", line)
            if m and killed is None:
                deadline = time.time() + 120
                while latest_step(str(ckpt)) is None and time.time() < deadline:
                    time.sleep(0.05)
                killed = latest_step(str(ckpt))
                os.killpg(int(m.group(1)), signal.SIGKILL)
        assert proc.wait(timeout=300) == 0, "".join(lines)
    finally:
        proc.kill()
    out = "".join(lines)
    assert killed is not None and "pid died unfinished (rc=-9); resume #1" in out
    assert "training complete (rc=0)" in out and out.count("--resume") == 2
    text = log.read_text()
    assert f"resumed from step {killed}" in text and "done; checkpoints in" in text
    assert latest_step(str(ckpt)) == 30
