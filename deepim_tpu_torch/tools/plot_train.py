"""Plot training curves from an experiment's train_log.jsonl.

Port of ``tools/plot_train.py``: small multiples, one panel per metric
family (the reference's six, in its 2x3 grid and palette), each series
EMA-smoothed with the reference's :func:`ema`, a log y axis for the
losses, written as a PNG.  The reference draws with matplotlib, which the
card's machine lacks; here the panels are drawn with numpy (grid lines,
axes, 2-px polylines; no text) and written by ``data/png.py
§write_png``.  The printed line names the panels' series and their last
smoothed values instead of the reference's in-plot labels.

Usage:
    python -m deepim_tpu_torch.tools.plot_train output/<experiment>/train_log.jsonl \\
        [--out output/<experiment>/train_curves.png] [--ema 0.9]
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

# Validated categorical palette (fixed order, never cycled) + ink tokens.
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
INK, INK2 = "#0b0b0b", "#52514e"
SURFACE, GRID = "#fcfcfb", "#e7e6e2"

PANELS = [
    ("total loss", ["loss"], True),
    ("point-matching loss", ["pm_loss_"], True),
    ("aux losses", ["flow_loss_", "mask_loss_"], True),
    ("rotation error (deg)", ["rot_err_deg_"], False),
    ("translation error (m)", ["trans_err_"], False),
    ("ADD (m)", ["add_"], False),
]
SIZE = (825, 1650)  # the reference's 15 x 7.5 in at 110 dpi, (height, width)


def load(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def ema(values, alpha: float):
    out, acc = [], None
    for v in values:
        acc = v if acc is None else alpha * acc + (1 - alpha) * v
        out.append(acc)
    return out


def panel_series(recs: list[dict], alpha: float) -> list[tuple[str, bool, dict]]:
    """(title, log y, {metric: smoothed values}) of each panel, as the
    reference plots them (a metric missing from a record is NaN)."""
    keys = sorted({k for r in recs for k in r} - {"step", "time"})
    out = []
    for title, prefixes, log_y in PANELS:
        cols = [k for k in keys if any(k == pre or k.startswith(pre) for pre in prefixes)]
        series = {}
        for k in sorted(cols):
            ys = [r.get(k, float("nan")) for r in recs]
            series[k] = ema(ys, alpha) if alpha else ys
        out.append((title, log_y, series))
    return out


def _rgb(hex_color: str) -> np.ndarray:
    return np.array([int(hex_color[i:i + 2], 16) for i in (1, 3, 5)], np.uint8)


def _polyline(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color, width: int = 2):
    """Draw the segments between consecutive finite points, ``width`` px."""
    h, w = img.shape[:2]
    pts = []
    for (x0, y0), (x1, y1) in zip(zip(xs[:-1], ys[:-1]), zip(xs[1:], ys[1:])):
        if not all(map(math.isfinite, (x0, y0, x1, y1))):
            continue
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        pts.append(np.stack([x0 + (x1 - x0) * t, y0 + (y1 - y0) * t], 1))
    if len(xs) == 1 and math.isfinite(xs[0]) and math.isfinite(ys[0]):
        pts.append(np.array([[xs[0], ys[0]]]))
    if not pts:
        return
    p = np.rint(np.concatenate(pts)).astype(np.int64)
    for dx in range(width):
        for dy in range(width):
            x = np.clip(p[:, 0] + dx - width // 2, 0, w - 1)
            y = np.clip(p[:, 1] + dy - width // 2, 0, h - 1)
            img[y, x] = color


def draw(steps: list, panels: list[tuple[str, bool, dict]],
         size: tuple[int, int] = SIZE) -> np.ndarray:
    """The 2x3 panels as a (H, W, 3) uint8 image."""
    h, w = size
    img = np.empty((h, w, 3), np.uint8)
    img[:] = _rgb(SURFACE)
    grid = _rgb(GRID)
    x = np.asarray(steps, np.float64)
    cell_h, cell_w = (h - 40) // 2, w // 3
    for i, (_, log_y, series) in enumerate(panels):
        if not series:
            continue
        top, left = 40 + (i // 3) * cell_h + 20, (i % 3) * cell_w + 50
        ph, pw = cell_h - 60, cell_w - 80
        ys = {k: np.asarray(v, np.float64) for k, v in series.items()}
        if log_y:
            ys = {k: np.where(v > 0, np.log10(np.where(v > 0, v, 1.0)), np.nan)
                  for k, v in ys.items()}
        finite = np.concatenate([v[np.isfinite(v)] for v in ys.values()] + [np.zeros(0)])
        lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
        if hi <= lo:
            lo, hi = lo - 0.5, hi + 0.5
        x0, x1 = x.min(), x.max() if x.max() > x.min() else x.min() + 1.0
        for j in range(5):  # grid lines
            img[top + round(j * (ph - 1) / 4), left:left + pw] = grid
            img[top:top + ph, left + round(j * (pw - 1) / 4)] = grid
        for ci, (k, v) in enumerate(sorted(ys.items())):
            px = left + (x - x0) / (x1 - x0) * (pw - 1)
            py = top + (ph - 1) - (v - lo) / (hi - lo) * (ph - 1)
            _polyline(img, px, py, _rgb(SERIES[ci % len(SERIES)]))
    return img


def main(argv=None) -> int:
    from deepim_tpu_torch.data.png import write_png

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("log", help="path to train_log.jsonl")
    p.add_argument("--out", default="")
    p.add_argument("--ema", type=float, default=0.9,
                   help="EMA smoothing factor (0 = raw)")
    args = p.parse_args(argv)

    recs = load(args.log)
    if not recs:
        print("empty log")
        return 1
    steps = [r["step"] for r in recs]
    keys = sorted({k for r in recs for k in r} - {"step", "time"})
    panels = panel_series(recs, args.ema)
    out = args.out or os.path.join(os.path.dirname(args.log), "train_curves.png")
    write_png(out, draw(steps, panels))
    print(f"wrote {out} ({len(recs)} log records, {len(keys)} metrics)")
    for title, _, series in panels:
        if series:
            print(f"  {title}: " + ", ".join(f"{k}={v[-1]:.4g}" for k, v in series.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
