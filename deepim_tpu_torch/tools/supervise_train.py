"""Failure-detecting training supervisor.

The reference has no resilience story (crash = rerun by hand).  The
training CLI checkpoints, so a supervisor can make any run self-healing:
launch ``deepim_tpu_torch.cli.train``, watch its log for liveness, and on
a crash *or* a wedge (process alive but the log stale) kill and relaunch
with ``--resume``.

Usage:
    python -m deepim_tpu_torch.tools.supervise_train --cfg experiments/cfgs/foo.yaml \
        [--stale-sec 600] [--log <tmp>/supervise_foo.log] [-- extra cli args]

Relaunches are gated on a device-liveness probe: relaunching into a dead
device burns a restart budget slot each time.  Probe failures wait, they
don't count as restarts.  The probe is a subprocess that does one round
trip through ``cuda:0`` (``--device cpu`` among the extra arguments probes
the CPU instead).

Exits 0 when the training run prints its completion line.  Port of
``tools/supervise_train.py``: its arguments, log and ``[supervisor]``
lines; ``--poll-sec`` (default 30, the reference's fixed interval) sets
how often the log and the process are checked.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

DONE_MARKER = "done; checkpoints"

# Tiny device round trip: one matmul on the device and one scalar read
# back to the host.  Runs in a subprocess so a wedged device can be timed
# out without poisoning the supervisor's own process.
PROBE_SRC = (
    "import sys, torch;"
    "d = torch.device(sys.argv[1]);"
    "x = torch.ones((8, 128), device=d) * 2;"
    "assert float((x @ x.T)[0, 0]) == 512.0"
)


def device_alive(timeout_sec: int = 180, device: str = "cuda:0") -> bool:
    """True iff a fresh subprocess can complete a round trip through ``device``."""
    try:
        rc = subprocess.run(
            [sys.executable, "-u", "-c", PROBE_SRC, device],
            timeout=timeout_sec,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        ).returncode
        return rc == 0
    except subprocess.TimeoutExpired:
        return False


def wait_for_device(probe_timeout: int = 180, retry_sec: int = 120,
                    alive=device_alive, sleep=time.sleep) -> None:
    """Block until the device answers.  Outages don't consume restarts."""
    probes = 0
    while not alive(probe_timeout):
        probes += 1
        print(f"[supervisor] device probe #{probes} failed; "
              f"retrying in {retry_sec}s")
        sleep(retry_sec)
    if probes:
        print(f"[supervisor] device back after {probes} failed probes")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", required=True)
    p.add_argument("--stale-sec", type=int, default=600,
                   help="kill+resume if the log is silent this long")
    p.add_argument("--log", default=None,
                   help="log file (default <tmp>/supervise_<experiment>.log)")
    p.add_argument("--max-restarts", type=int, default=20)
    p.add_argument("--poll-sec", type=float, default=30.0,
                   help="seconds between checks of the log and the process")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="extra args forwarded to cli.train (after --)")
    return p.parse_args(argv)


def train_device(extra) -> str:
    """The ``--device`` among the forwarded cli.train arguments (cli.train's
    default, ``cuda:0``, without one)."""
    args = [a for a in extra if a != "--"]
    for i, a in enumerate(args):
        if a == "--device" and i + 1 < len(args):
            return args[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda:0"


def launch(cfg: str, log_path: str, resume: bool, extra) -> subprocess.Popen:
    cmd = [sys.executable, "-u", "-m", "deepim_tpu_torch.cli.train", "--cfg", cfg]
    if resume:
        cmd.append("--resume")
    cmd += [a for a in extra if a != "--"]
    env = dict(os.environ, DEEPIM_SUPERVISED="1")
    with open(log_path, "ab", buffering=0) as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env)
    print(f"[supervisor] launched pid {proc.pid}: {' '.join(cmd)}", flush=True)
    return proc


def stepped_since(log_path: str, offset: int) -> bool:
    """True iff a "step N" progress line was written at/after ``offset``.

    The start-up 3x stale budget must be scoped to the CURRENT launch: the
    log is append-only across kill+resume cycles, so step lines from a
    previous run would otherwise grant the relaunched process (which is
    starting up again) only the 1x budget.  Scanning from the per-launch
    offset also bounds each poll's read to new bytes.
    """
    try:
        with open(log_path, "rb") as f:
            f.seek(max(0, offset - 6))  # catch "\nstep " straddling offset
            data = f.read()
        return b"\nstep " in data or (offset == 0 and data.startswith(b"step "))
    except OSError:
        return False


def tail_done(log_path: str) -> bool:
    try:
        with open(log_path, "rb") as f:
            f.seek(max(0, os.path.getsize(log_path) - (1 << 16)))
            return DONE_MARKER.encode() in f.read()
    except OSError:
        return False


def main(argv=None) -> int:
    args = parse_args(argv)
    name = os.path.splitext(os.path.basename(args.cfg))[0]
    log_path = args.log or os.path.join(tempfile.gettempdir(), f"supervise_{name}.log")
    open(log_path, "wb").close()
    device = train_device(args.rest)

    def alive(timeout):
        return device_alive(timeout, device)

    wait_for_device(alive=alive)
    launch_offset = os.path.getsize(log_path)
    proc = launch(args.cfg, log_path, resume=True, extra=args.rest)
    restarts = 0
    stepped = False  # has THIS launch produced a "step N" line yet?
    while True:
        time.sleep(args.poll_sec)
        rc = proc.poll()
        if rc is not None:
            if tail_done(log_path):
                print(f"[supervisor] training complete (rc={rc})", flush=True)
                return 0
            restarts += 1
            if restarts > args.max_restarts:
                print("[supervisor] too many restarts; giving up")
                return 1
            print(f"[supervisor] pid died unfinished (rc={rc}); "
                  f"resume #{restarts}", flush=True)
            wait_for_device(alive=alive)
            launch_offset = os.path.getsize(log_path)
            proc = launch(args.cfg, log_path, resume=True, extra=args.rest)
            stepped = False
            continue
        age = time.time() - os.path.getmtime(log_path)
        # Before the first "step N/M" line the process is starting up (the
        # CUDA context, the kernels' build, data set-up), which writes
        # little: give that phase 3x the budget, scoped to output since the
        # CURRENT launch (see stepped_since).
        if not stepped:
            stepped = stepped_since(log_path, launch_offset)
        stale_budget = args.stale_sec if stepped else 3 * args.stale_sec
        if age > stale_budget:
            restarts += 1
            if restarts > args.max_restarts:
                print("[supervisor] too many restarts; giving up")
                return 1
            print(f"[supervisor] log stale {age:.0f}s; killing pid "
                  f"{proc.pid} and resuming (#{restarts})", flush=True)
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
                time.sleep(10)
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            time.sleep(5)
            wait_for_device(alive=alive)
            launch_offset = os.path.getsize(log_path)
            proc = launch(args.cfg, log_path, resume=True, extra=args.rest)
            stepped = False


if __name__ == "__main__":
    raise SystemExit(main())
