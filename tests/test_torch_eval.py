"""deepim_tpu_torch.eval against deepim_tpu.eval (CPU).

- ``compute_pose_errors`` and ``evaluate_poses`` on identical poses (a
  perfect estimate, a symmetric class turned about its axis, errors that
  grow with the sample, and chunks of 3 over 8 rows against one chunk):
  per-sample errors within 1e-6 (absolute and relative: a float32 ulp at
  18° is 1.9e-6).  The two frameworks round some errors one ulp apart, so
  the tables are held equal apart from what such rounding can move: a
  count, proportion or interval may differ only where a sample's error
  lies within 1e-5 (relative) of its threshold (one ADD-S error of the
  degrading case sits on an AUC threshold, 0.0217 m); means and the AUC
  (float32 reductions whose order differs by framework) agree to 1e-5
  relative beside that (the rotation error's arccos turns one ulp of a
  trace into 1.3e-5° at 15°); and the ``format_table`` text is identical
  when no error sits at a threshold.  The classes hold 3 and 5 of the 8 samples: a class AUC is
  then a multiple of 1/30 or 1/50 % and the mean of 1/300 %, none on a
  rounding boundary of the printed digit (with 4 samples a class every
  other AUC would be, and one ulp could change the text).
- The host side alone: the reference's ``evaluate_poses`` given the
  port's per-sample errors makes the port's table.
- The Wilson intervals to 1e-12.
- The BOP CSV written by each package and read by the other.
- ``quat_slerp`` against the reference (near-parallel and opposite-sign
  pairs included) within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.eval import bop_results as bop_j
from deepim_tpu.eval import evaluator as ev_j
from deepim_tpu.geometry import rotations as rot_j
from deepim_tpu.geometry.symmetry import rot_z_syms
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.eval import bop_results as bop_t
from deepim_tpu_torch.eval import evaluator as ev_t
from deepim_tpu_torch.geometry import rotations as rot_t
from deepim_tpu_torch.refine import refiner as ref_t
from test_torch_raster import _euler

K = np.array([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1]], np.float32)
NAMES = ["box", "torus"]
SYMMETRIC = [False, True]


@pytest.fixture(scope="module")
def assets():
    meshes = [mesh_j.box_mesh((0.08, 0.1, 0.06)), mesh_j.torus_mesh()]
    syms = [None, rot_z_syms(4)]
    return (ref_t.build_assets(meshes, sym_transforms=syms, num_points=64, device="cpu"),
            ref_j.build_assets(meshes, sym_transforms=syms, num_points=64))


def _gt(n, seed):
    rng = np.random.RandomState(seed)
    poses = [np.concatenate([_euler(*rng.uniform(-1.5, 1.5, 3)),
                             np.array([[rng.uniform(-0.05, 0.05)], [rng.uniform(-0.04, 0.04)],
                                       [rng.uniform(0.6, 0.9)]])], 1) for _ in range(n)]
    return np.asarray(poses, np.float32), (np.arange(n) >= 3).astype(np.int32)


def _case(name, n=8):
    gt, cls = _gt(n, seed=4)
    est = gt.copy()
    if name == "symmetric":  # the torus turned by a quarter about its axis: ADD-S 0
        est = np.einsum("bij,jk->bik", gt[:, :, :3], _euler(0, 0, np.pi / 2)).astype(np.float32)
        est = np.concatenate([est, gt[:, :, 3:]], 2)
    elif name == "degrading":  # rotation and translation errors growing with the row
        for i in range(n):
            r = _euler(0.02 * i, -0.03 * i, 0.025 * i) @ gt[i, :, :3]
            est[i] = np.concatenate([r, gt[i, :, 3:] + 0.004 * i * np.array([[1], [-1], [2]])], 1)
    return est.astype(np.float32), gt, cls


@pytest.mark.parametrize("case", ["perfect", "symmetric", "degrading"])
def test_pose_errors_match_reference(assets, case):
    at, aj = assets
    est, gt, cls = _case(case)
    ks = np.broadcast_to(K, (len(gt), 3, 3)).copy()
    ab_j = ref_j.gather_class(aj, jnp.asarray(cls))
    want = ev_j.compute_pose_errors(ab_j.points, ab_j.sym_poses, jnp.asarray(est),
                                    jnp.asarray(gt), jnp.asarray(ks), point_block=16)
    idx = torch.from_numpy(cls).long()
    got = ev_t.compute_pose_errors(at.points[idx], at.sym_poses[idx], torch.from_numpy(est),
                                   torch.from_numpy(gt), torch.from_numpy(ks), point_block=16)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    if case == "perfect":
        assert max(float(v.abs().max()) for v in got.values()) < 1e-4
    if case == "symmetric":  # the torus's rows: symmetric ADD vanishes, ADD does not
        torus = torch.from_numpy(cls == 1)
        assert got["add_sym"][torus].max() < 1e-5 and got["add"][torus].min() > 1e-2
        assert (got["adds"][torus] < 0.5 * got["add"][torus]).all()


def _near(err, thresholds, rel=1e-5):
    """How many of ``thresholds`` lie within ``rel`` (relative) of ``err``."""
    t = np.asarray(thresholds, np.float64)
    return int((np.abs(t - float(err)) <= rel * np.maximum(np.abs(t), 1e-3)).sum())


def _allowed(errs, diam, cls, ci, symmetric=SYMMETRIC, th=ev_t.EvalThresholds()):
    """Per table entry of class ``ci``: how many per-sample comparisons sit
    at their threshold (each can flip between frameworks)."""
    m = cls == ci
    add_like = errs["adds"] if symmetric[ci] else errs["add"]
    t_add = th.add_frac * float(diam[ci])
    auc_thr = np.linspace(0.0, th.auc_max_m, 1001)[1:]
    return {
        "add(-s)_0.1d": sum(_near(e, [t_add]) for e in add_like[m]),
        "add_0.1d": sum(_near(e, [t_add]) for e in errs["add"][m]),
        "adds_0.1d": sum(_near(e, [t_add]) for e in errs["adds"][m]),
        "5deg_5cm": sum(_near(r, [th.rot_deg]) + _near(t, [th.trans_m])
                        for r, t in zip(errs["rot_deg"][m], errs["trans_m"][m])),
        "proj2d_5px": sum(_near(e, [th.proj_px]) for e in errs["proj2d_px"][m]),
        "auc_add(-s)": sum(_near(e, auc_thr) for e in add_like[m]) / 1000.0,
    }


def _assert_tables_equal(got, want, allowed=None):
    """Counts, proportions and intervals equal (up to ``allowed[class][key]``
    flipped comparisons), means and AUC to 1e-5 relative beside that."""
    assert got["num_samples"] == want["num_samples"]
    assert list(got["per_class"]) == list(want["per_class"])
    rows = [(c, got["per_class"][c], want["per_class"][c]) for c in want["per_class"]]
    for c, a, b in rows + [("MEAN", got["mean"], want["mean"])]:
        assert a.keys() == b.keys()
        if c == "MEAN":
            slack = {k: sum(allowed[r][k] / got["per_class"][r]["n"] for r, _, _ in rows)
                     * 100.0 / len(rows) for k in allowed[rows[0][0]]} if allowed else {}
        else:
            slack = {k: v * 100.0 / a["n"] for k, v in (allowed or {}).get(c, {}).items()}
        for key in b:
            if key in ("n", "ci95") or key in ev_t.PROPORTION_METRICS:
                if slack.get(key, 0) == 0:
                    assert a[key] == b[key], (c, key)
                else:
                    assert abs(a[key] - b[key]) <= slack[key] + 1e-9, (c, key)
            else:
                tol = slack.get(key, 0) + 1e-5 * abs(b[key]) + 1e-9
                assert abs(a[key] - b[key]) <= tol, (c, key)


@pytest.mark.parametrize("case,chunk", [("perfect", 256), ("symmetric", 256),
                                        ("degrading", 256), ("degrading", 3)])
def test_evaluate_poses_tables_match_reference(assets, case, chunk):
    at, aj = assets
    est, gt, cls = _case(case)
    ks = np.broadcast_to(K, (len(gt), 3, 3)).copy()
    want = ev_j.evaluate_poses(aj, NAMES, SYMMETRIC, est, gt, cls, ks, chunk=chunk,
                               point_block=16)
    got = ev_t.evaluate_poses(at, NAMES, SYMMETRIC, est, gt, cls, ks, chunk=chunk,
                              point_block=16)
    idx = torch.from_numpy(cls).long()
    errs = {k: v.numpy() for k, v in ev_t.compute_pose_errors(
        at.points[idx], at.sym_poses[idx], torch.from_numpy(est), torch.from_numpy(gt),
        torch.from_numpy(ks), point_block=16).items()}
    diam = at.diameters.numpy()
    allowed = {NAMES[ci]: _allowed(errs, diam, cls, ci) for ci in range(len(NAMES))}
    _assert_tables_equal(got, want, allowed)
    if not any(v for row in allowed.values() for v in row.values()):
        assert ev_t.format_table(got, "t") == ev_j.format_table(want, "t")
    whole = ev_t.evaluate_poses(at, NAMES, SYMMETRIC, est, gt, cls, ks, point_block=16)
    assert got == whole  # chunking (and the padded last chunk) changes nothing
    assert ev_t.format_table(got, "t") == ev_j.format_table(got, "t")


@pytest.mark.parametrize("case", ["symmetric", "degrading"])
def test_host_side_matches_reference_on_the_same_errors(assets, case, monkeypatch):
    at, aj = assets
    est, gt, cls = _case(case)
    ks = np.broadcast_to(K, (len(gt), 3, 3)).copy()
    got = ev_t.evaluate_poses(at, NAMES, SYMMETRIC, est, gt, cls, ks, point_block=16)
    idx = torch.from_numpy(cls).long()
    errs = ev_t.compute_pose_errors(at.points[idx], at.sym_poses[idx], torch.from_numpy(est),
                                    torch.from_numpy(gt), torch.from_numpy(ks), point_block=16)
    monkeypatch.setattr(ev_j, "compute_pose_errors",
                        lambda *a, **kw: {k: jnp.asarray(v.numpy()) for k, v in errs.items()})
    want = ev_j.evaluate_poses(aj, NAMES, SYMMETRIC, est, gt, cls, ks, point_block=16)
    _assert_tables_equal(got, want)
    assert ev_t.format_table(got, "t") == ev_j.format_table(want, "t")


@pytest.mark.parametrize("p,n", [(0.0, 64), (100.0, 64), (37.5, 8), (50.0, 2048), (3.0, 1),
                                 (12.0, 0)])
def test_wilson_intervals_match_reference(p, n):
    lo_t, hi_t = ev_t.wilson_ci(p, n)
    lo_j, hi_j = ev_j.wilson_ci(p, n)
    if n == 0:
        assert np.isnan([lo_t, hi_t]).all() and np.isnan([lo_j, hi_j]).all()
        return
    assert abs(lo_t - lo_j) <= 1e-12 and abs(hi_t - hi_j) <= 1e-12
    assert abs(ev_t.ci_halfwidth(p, n) - ev_j.ci_halfwidth(p, n)) <= 1e-12
    rows = [{"n": n, "add_0.1d": p}, {"n": 3 * n + 1, "add_0.1d": 100.0 - p / 2}]
    assert abs(ev_t.macro_mean_halfwidth(rows, "add_0.1d")
               - ev_j.macro_mean_halfwidth(rows, "add_0.1d")) <= 1e-12


def test_bop_csv_is_read_by_both_packages(tmp_path):
    gt, _ = _gt(5, seed=9)
    obj = np.array([1, 8, 8, 2, 15])
    kw = dict(scene_ids=np.array([0, 0, 1, 1, 2]), im_ids=np.array([3, 4, 3, 4, 7]),
              scores=np.linspace(0.2, 1.0, 5), time_s=0.0125)
    bop_t.write_bop_csv(str(tmp_path / "t.csv"), gt, obj, **kw)
    bop_j.write_bop_csv(str(tmp_path / "j.csv"), gt, obj, **kw)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    for path in ("t.csv", "j.csv"):
        a = bop_t.read_bop_csv(str(tmp_path / path))
        b = bop_j.read_bop_csv(str(tmp_path / path))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_allclose(a["poses"], gt, atol=1e-6)
    (tmp_path / "bad.csv").write_text("not,a,bop,file\n")
    with pytest.raises(ValueError):
        bop_t.read_bop_csv(str(tmp_path / "bad.csv"))


def test_quat_slerp_matches_reference():
    rng = np.random.RandomState(2)
    q0 = rng.randn(6, 4).astype(np.float32)
    q1 = rng.randn(6, 4).astype(np.float32)
    q1[1] = q0[1] + 1e-7  # nearly parallel: the lerp branch
    q1[2] = -q0[2]  # opposite sign, the same rotation
    q1[3] = -q0[3] + 0.01 * rng.randn(4)  # the shortest path flips q1
    t = np.array([0.0, 0.3, 0.5, 0.7, 1.0, 0.25], np.float32)
    got = rot_t.quat_slerp(torch.from_numpy(q0), torch.from_numpy(q1), torch.from_numpy(t))
    want = rot_j.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # a scalar t broadcasts over the batch
    got_s = rot_t.quat_slerp(torch.from_numpy(q0), torch.from_numpy(q1), torch.tensor(0.4))
    want_s = rot_j.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.float32(0.4))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
