"""The procedural object set, built again from its definition (numpy).

Frozen plain copies of the four procedural meshes the synthetic
configurations name (box, icosphere, cylinder, torus: their vertices,
faces, colours and area-weighted vertex normals), the back-face cull sign
of a closed mesh, the area-weighted surface sample of the point-matching
loss (``RandomState(0)``), the AABB corners that size the zoom box and the
continuous z symmetry of the torus and the cylinder.  Nothing is read from
the program: the reference derives every table it renders or scores with.

Each class keeps its own face list (no padding), so a render walks only
that mesh's faces.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: Discrete stand-in of a continuous z symmetry in the symmetry set.
CONTINUOUS_Z_STEPS = 16
#: Classes with a continuous symmetry about their z axis.
CONTINUOUS_Z = ("torus", "cylinder")


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (v[f[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    n = np.zeros_like(v)
    for i in range(3):
        np.add.at(n, f[:, i], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def box():
    sx = sy = sz = 0.05  # a 0.1 m cube, a colour a side
    quads = [
        [(-sx, -sy, sz), (sx, -sy, sz), (sx, sy, sz), (-sx, sy, sz)],
        [(sx, -sy, -sz), (-sx, -sy, -sz), (-sx, sy, -sz), (sx, sy, -sz)],
        [(sx, -sy, sz), (sx, -sy, -sz), (sx, sy, -sz), (sx, sy, sz)],
        [(-sx, -sy, -sz), (-sx, -sy, sz), (-sx, sy, sz), (-sx, sy, -sz)],
        [(-sx, sy, sz), (sx, sy, sz), (sx, sy, -sz), (-sx, sy, -sz)],
        [(-sx, -sy, -sz), (sx, -sy, -sz), (sx, -sy, sz), (-sx, -sy, sz)],
    ]
    face_colors = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    verts, faces, cols = [], [], []
    for qi, quad in enumerate(quads):
        base = len(verts)
        verts.extend(quad)
        cols.extend([face_colors[qi]] * 4)
        faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return verts, faces, cols


def icosphere(radius=0.05, subdivisions=2, color=(0.8, 0.5, 0.2)):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    base = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
                     (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                    np.float64)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(p / np.linalg.norm(p)) for p in base]
    mids: dict[tuple[int, int], int] = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in mids:
            m = np.asarray(verts[i]) + np.asarray(verts[j])
            verts.append(tuple(m / np.linalg.norm(m)))
            mids[key] = len(verts) - 1
        return mids[key]

    for _ in range(subdivisions):
        split = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            split += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = split
    v = np.asarray(verts, np.float32) * radius
    c = np.clip((0.5 + 0.5 * (v / radius)) * np.asarray(color) * 1.4, 0, 1).astype(np.float32)
    return v, faces, c


def cylinder(radius=0.03, height=0.12, segments=24, color=(0.2, 0.6, 0.9)):
    s = segments
    ang = np.linspace(0, 2 * np.pi, s, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], -1)
    rings = [np.concatenate([ring, np.full((s, 1), z)], -1) for z in (height / 2, -height / 2)]
    verts = np.concatenate(rings + [[[0, 0, height / 2]], [[0, 0, -height / 2]]])
    top, bottom = 2 * s, 2 * s + 1
    faces = []
    for i in range(s):
        j = (i + 1) % s
        faces += [(i, s + i, s + j), (i, s + j, j), (top, i, j), (bottom, s + j, s + i)]
    c = np.tile(np.asarray(color, np.float32), (len(verts), 1))
    c[:s] *= 1.2
    return verts, faces, np.clip(c, 0, 1)


def torus(r_major=0.05, r_minor=0.02, n_major=24, n_minor=12, color=(0.8, 0.3, 0.5)):
    verts, cols = [], []
    for i in range(n_major):
        a = 2 * np.pi * i / n_major
        for j in range(n_minor):
            b = 2 * np.pi * j / n_minor
            verts.append(((r_major + r_minor * np.cos(b)) * np.cos(a),
                          (r_major + r_minor * np.cos(b)) * np.sin(a), r_minor * np.sin(b)))
            cols.append(tuple(np.asarray(color) * (0.6 + 0.4 * np.cos(b))))
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a0, a1 = i * n_minor + j, i * n_minor + (j + 1) % n_minor
            b0 = ((i + 1) % n_major) * n_minor + j
            b1 = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            faces += [(a0, b0, b1), (a0, b1, a1)]
    return verts, faces, cols


SHAPES = {"box": box, "icosphere": icosphere, "cylinder": cylinder, "torus": torus}


def cull_sign(v: np.ndarray, f: np.ndarray) -> float:
    """±1 when the mesh is closed and consistently wound (then a face whose
    projected signed area has the volume's sign faces away), else 0."""
    v64, f64 = v.astype(np.float64), f.astype(np.int64)
    _, remap = np.unique(v64.round(9), axis=0, return_inverse=True)
    fm = remap.reshape(-1)[f64]
    fm = fm[(fm[:, 0] != fm[:, 1]) & (fm[:, 1] != fm[:, 2]) & (fm[:, 0] != fm[:, 2])]
    edges = np.concatenate([fm[:, [0, 1]], fm[:, [1, 2]], fm[:, [2, 0]]])
    n = remap.max() + 1
    keys, rev = edges[:, 0] * n + edges[:, 1], edges[:, 1] * n + edges[:, 0]
    if np.unique(keys).shape[0] != keys.shape[0] or not np.isin(keys, rev).all():
        return 0.0
    vol = np.einsum("ij,ij->i", v64[f64[:, 0]], np.cross(v64[f64[:, 1]], v64[f64[:, 2]])).sum()
    if abs(vol / 6.0) < 1e-12 * float(np.abs(v64).max()) ** 3:
        return 0.0
    return float(np.sign(vol))


def surface_points(v: np.ndarray, f: np.ndarray, n: int) -> np.ndarray:
    rng = np.random.RandomState(0)
    v0, v1, v2 = (v[f[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    idx = rng.choice(f.shape[0], n, p=areas / max(areas.sum(), 1e-12))
    r1, r2 = rng.rand(n, 1), rng.rand(n, 1)
    s = np.sqrt(r1)
    return ((1 - s) * v0[idx] + s * (1 - r2) * v1[idx] + s * r2 * v2[idx]).astype(np.float32)


def z_rotations(n: int) -> np.ndarray:
    out = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        c, s = np.cos(a), np.sin(a)
        out.append(np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0]], np.float64))
    return np.asarray(out, np.float32)


@dataclass
class ObjectSet:
    """Per-class tensors on one device; lists are indexed by class."""

    names: list
    tri_pos: list  # (9, F) corner-major object-frame corners
    tri_col: list  # (9, F)
    tri_nrm: list  # (9, F)
    cull: torch.Tensor  # (C,) ±1 or 0
    corners: torch.Tensor  # (C, 8, 3)
    points: torch.Tensor  # (C, N, 3)
    sym_poses: torch.Tensor  # (C, S, 3, 4), identity first
    continuous: torch.Tensor  # (C,) bool
    diameters: torch.Tensor  # (C,)


def object_set(names, num_points: int, device) -> ObjectSet:
    meshes = []
    for name in names:
        v, f, c = SHAPES[name]()
        v, f, c = np.asarray(v, np.float32), np.asarray(f, np.int32), np.asarray(c, np.float32)
        meshes.append((v, f, c, vertex_normals(v, f)))
    n_sym = max(CONTINUOUS_Z_STEPS if n in CONTINUOUS_Z else 1 for n in names)

    def corner_major(a, f):
        return torch.from_numpy(a[f].reshape(-1, 9).T.copy()).to(device)

    corners, syms = [], []
    for name, (v, _, _, _) in zip(names, meshes):
        lo, hi = v.min(0), v.max(0)
        corners.append([[x[0], y[1], z[2]] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)])
        s = z_rotations(CONTINUOUS_Z_STEPS) if name in CONTINUOUS_Z else z_rotations(1)
        syms.append(np.concatenate([s, np.repeat(s[:1], n_sym - s.shape[0], 0)]))
    diam = [float(np.sqrt(((v[:, None] - v[None]) ** 2).sum(-1).max())) for v, *_ in meshes]

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return ObjectSet(
        names=list(names),
        tri_pos=[corner_major(v, f) for v, f, _, _ in meshes],
        tri_col=[corner_major(c, f) for _, f, c, _ in meshes],
        tri_nrm=[corner_major(n, f) for _, f, _, n in meshes],
        cull=tensor([cull_sign(v, f) for v, f, _, _ in meshes]),
        corners=tensor(np.asarray(corners, np.float32)),
        points=tensor(np.stack([surface_points(v, f, num_points) for v, f, _, _ in meshes])),
        sym_poses=tensor(np.stack(syms)),
        continuous=tensor([n in CONTINUOUS_Z for n in names], torch.bool),
        diameters=tensor(np.asarray(diam, np.float32)),
    )
