"""chip_smoke.py §bound: the work each raster kernel call must do.

Runs on the CPU through the kernels' plain versions.  The winners that
``winning_faces`` reads back from one coded call must be the faces that
a brute-force depth test over every face finds, and the bytes counted
must not grow with the padding of the id arrays or with faces no list
holds.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from deepim_tpu_torch import headline as hl
from deepim_tpu_torch.ops.zoom import compute_zoom_box, zoom_intrinsics
from deepim_tpu_torch.raster import raster_cuda as rc
from deepim_tpu_torch.refine import gather_class

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

B, SIZE = 2, (48, 64)


def _binned(name, bbox, ok):
    if name == "raster_sorted":
        return rc.raster_sorted_ref, rc.bin_faces_sorted(bbox, ok, SIZE, sy_span=1, sx_span=1)
    if name == "raster_cols":
        return rc.raster_cols_ref, rc.bin_faces_packed(bbox, ok, SIZE)
    return rc.raster_topk_ref, rc.bin_faces_topk(bbox, ok, SIZE, 4096)


@pytest.fixture(scope="module")
def crops():
    """Packed crops of the sort-route headline classes: (params, bbox, ok)."""
    dev = torch.device("cpu")
    assets = hl.headline_assets(dev, dense_sphere=False)
    _, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, B)
    ab = gather_class(assets, cls)
    kz = zoom_intrinsics(ks, compute_zoom_box(init, ks, ab.corners, SIZE))
    return rc.pack_tri_params(ab.tri_pos, ab.tri_col, ab.tri_nrm, init, kz,
                              rc.FLAT_LIGHTING, 0.01, ab.cull_dir)


def _brute_winners(params):
    """Faces that win a pixel centre over every face of the sample, the
    first of the largest inverse depths among the covering faces."""
    h, w = SIZE
    ys, xs = torch.meshgrid(torch.arange(h) + 0.5, torch.arange(w) + 0.5, indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)

    def plane(i):
        p = params[..., i:i + 3]
        return (p[..., 0, None] * px + p[..., 1, None] * py) + p[..., 2, None]

    inside = (plane(0) >= 0) & (plane(3) >= 0) & (plane(6) >= 0)
    z, win = torch.where(inside, plane(9), 0.0).max(dim=1)
    return sum(len(set(win[b][z[b] > 0].tolist())) for b in range(params.shape[0]))


@pytest.mark.parametrize("name", ["raster_sorted", "raster_cols", "raster_topk"])
def test_winning_faces_match_brute_force(crops, name):
    # Every binning here is lossless (spans and cap cover every face), so
    # the winners are those of a depth test over all faces.
    params, bbox, ok = crops
    plain, binned = _binned(name, bbox, ok)
    n = cs.winning_faces(plain, (params, *binned, *SIZE))
    assert n == _brute_winners(params) and n > 0


@pytest.mark.parametrize("name", ["raster_sorted", "raster_cols", "raster_topk"])
def test_bytes_ignore_padding_and_unlisted_faces(crops, name):
    # 300 more faces that no list holds: params, the id arrays' padding
    # and the top-k lists' width grow; the work does not.
    params, bbox, ok = crops
    pad = 300
    params2 = torch.cat([params, params[:, :pad]], dim=1)
    bbox2 = torch.cat([bbox, bbox[:, :pad]], dim=1)
    ok2 = torch.cat([ok, torch.zeros_like(ok[:, :pad])], dim=1)
    plain, binned = _binned(name, bbox, ok)
    plain2, binned2 = _binned(name, bbox2, ok2)
    args, args2 = (params, *binned, *SIZE), (params2, *binned2, *SIZE)
    n = cs.winning_faces(plain, args)
    w1, w2 = cs.work(name, args, bbox, n), cs.work(name, args2, bbox2, n)
    assert w1 == w2
    walked = w1["bytes"] - B * SIZE[0] * SIZE[1] * 16
    everything = params.numel() * 4 + sum(a.numel() * 4 for a in binned)
    assert 0 < walked < everything
    assert cs.winning_faces(plain2, args2) == n
