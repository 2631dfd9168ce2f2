"""Train, then evaluate: ``python -m deepim_tpu_torch.cli.train_test --cfg <yaml>``.

Port of ``deepim_tpu/cli/train_test.py``: :func:`deepim_tpu_torch.cli.train.main`
over the training schedule, then :func:`deepim_tpu_torch.cli.test.main` on
the checkpoint it wrote, both on ``--device`` (default ``cuda:0``) and on
the ``--n-devices`` ranks (``parallel.launch``: one group of ranks runs
both halves, data-parallel).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train, then evaluate (deepim_train_test.py)")
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--n-devices", type=int, default=0,
                   help="data-parallel ranks, one process each (0 = every visible card; "
                        "with --device cpu, that many CPU ranks; under torchrun the "
                        "environment's world)")
    p.add_argument("--num-steps", type=int, default=0, help="override cfg.train.num_steps")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the latest checkpoint")
    p.add_argument("--num-samples", type=int, default=0,
                   help="eval set size for generated sets (0 = default)")
    p.add_argument("--vis", type=int, default=0,
                   help="write overlay montages for the first N eval samples")
    p.add_argument("--device", default="cuda:0",
                   help="torch device (default cuda:0; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from deepim_tpu_torch.parallel import launch

    args = parse_args(argv)
    return launch(train_test, args.n_devices, args.device, args)


def train_test(dev, args) -> int:
    """Both halves on this rank (inside a group, each half runs in place)."""
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli import train as cli_train

    common = ["--cfg", args.cfg, "--device", args.device, "--n-devices", str(args.n_devices)]
    train_argv = list(common)
    if args.num_steps:
        train_argv += ["--num-steps", str(args.num_steps)]
    if args.resume:
        train_argv.append("--resume")
    rc = cli_train.main(train_argv)
    if rc:
        return rc
    test_argv = list(common)
    if args.num_samples:
        test_argv += ["--num-samples", str(args.num_samples)]
    if args.vis:
        test_argv += ["--vis", str(args.vis)]
    return cli_test.main(test_argv)


if __name__ == "__main__":
    raise SystemExit(main())
