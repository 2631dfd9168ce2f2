"""Mesh containers, procedural meshes, padding, decimation, surface sampling.

Numpy copy of the parts of ``deepim_tpu/raster/mesh.py`` that
``build_assets`` and the headline protocol need: ``Mesh``, ``make_mesh``,
``compute_vertex_normals``, the four procedural builders (``box_mesh``,
``icosphere_mesh``, ``cylinder_mesh``, ``torus_mesh``), ``pad_mesh``,
``decimate_mesh``, ``sample_points`` and ``cull_direction``.

A copy and not an import: ``deepim_tpu/raster/__init__.py`` imports jax.
The reference routes meshes of 20,000+ faces to a C++ helper for vertex
normals and decimation; this copy always runs the numpy path, which is
that helper's oracle.  ``tests/test_torch_assets.py`` holds the copy
bit-identical to the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

@dataclass(frozen=True)
class Mesh:
    """A triangle mesh with per-vertex colors (all numpy, host-side).

    vertices: (V, 3) float32, object frame (meters).
    faces:    (F, 3) int32 vertex indices.
    colors:   (V, 3) float32 in [0, 1].
    normals:  (V, 3) float32 unit vertex normals (for Gouraud lighting).
    """

    vertices: np.ndarray
    faces: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    # Optional texture data (kept when a textured PLY is loaded; colors
    # above are then the baked-to-vertex fallback).  uv: (V, 2) in [0, 1];
    # texture: (Th, Tw, 3) float32 in [0, 1].
    uv: np.ndarray | None = None
    texture: np.ndarray | None = None

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def diameter(self) -> float:
        """Exact max pairwise vertex distance (the reference's
        models_info diameter, which sets the ADD 0.1d thresholds).

        The two extreme points lie on the convex hull, so big scanned
        meshes reduce to the hull's vertices first (typically a few
        hundred points for 100k-vertex scans); a random subsample — a
        strict underestimate that would bias reported accuracy low — is
        only the last-ditch fallback if the hull fails (degenerate/flat
        geometry)."""
        v = self.vertices
        if v.shape[0] > 1000:
            try:
                from scipy.spatial import ConvexHull

                v = v[ConvexHull(v).vertices]
            except Exception:
                idx = np.random.RandomState(0).choice(
                    v.shape[0], 1000, replace=False)
                v = v[idx]
        if v.shape[0] > 8192:  # pathological hull: chunk the pairwise max
            best = 0.0
            for i0 in range(0, v.shape[0], 2048):
                d2 = np.sum(
                    (v[i0:i0 + 2048, None, :] - v[None, :, :]) ** 2, -1)
                best = max(best, float(d2.max()))
            return float(np.sqrt(best))
        d2 = np.sum((v[:, None, :] - v[None, :, :]) ** 2, axis=-1)
        return float(np.sqrt(d2.max()))



def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (load-time only)."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normals
    normals = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def make_mesh(vertices, faces, colors=None, uv=None, texture=None) -> Mesh:
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    if colors is None:
        colors = np.full_like(vertices, 0.7)
    colors = np.asarray(colors, np.float32)
    return Mesh(vertices, faces, colors,
                compute_vertex_normals(vertices, faces),
                uv=None if uv is None else np.asarray(uv, np.float32),
                texture=texture)


# ---------------------------------------------------------------------------
# Procedural meshes (test fixtures + synthetic-data objects; they stand in
# for real scanned LINEMOD/YCB models, which the repo does not ship).
# ---------------------------------------------------------------------------


def box_mesh(size=(0.1, 0.1, 0.1), face_colors=None) -> Mesh:
    """Axis-aligned box centered at origin; 24 verts (faceted) 12 tris.

    Distinct per-face colors by default so orientation is observable in
    renders (used heavily by golden tests).
    """
    sx, sy, sz = (s * 0.5 for s in size)
    # 6 faces, each with its own 4 vertices (so colors/normals are flat).
    quads = [
        # +z, -z, +x, -x, +y, -y
        [(-sx, -sy, sz), (sx, -sy, sz), (sx, sy, sz), (-sx, sy, sz)],
        [(sx, -sy, -sz), (-sx, -sy, -sz), (-sx, sy, -sz), (sx, sy, -sz)],
        [(sx, -sy, sz), (sx, -sy, -sz), (sx, sy, -sz), (sx, sy, sz)],
        [(-sx, -sy, -sz), (-sx, -sy, sz), (-sx, sy, sz), (-sx, sy, -sz)],
        [(-sx, sy, sz), (sx, sy, sz), (sx, sy, -sz), (-sx, sy, -sz)],
        [(-sx, -sy, -sz), (sx, -sy, -sz), (sx, -sy, sz), (-sx, -sy, sz)],
    ]
    if face_colors is None:
        face_colors = [
            (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1),
        ]
    verts, faces, cols = [], [], []
    for qi, quad in enumerate(quads):
        base = len(verts)
        verts.extend(quad)
        cols.extend([face_colors[qi % len(face_colors)]] * 4)
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    return make_mesh(verts, faces, cols)


def icosphere_mesh(radius=0.05, subdivisions=2, color=(0.8, 0.5, 0.2)) -> Mesh:
    """Icosphere: 20 * 4^s faces (s=2 → 320 faces, 162 verts)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v / np.linalg.norm(v)) for v in verts]
    cache: dict[tuple[int, int], int] = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = np.asarray(verts[i]) + np.asarray(verts[j])
            verts.append(tuple(m / np.linalg.norm(m)))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, np.float32) * radius
    # Color varies with position so rotations are observable.
    c = 0.5 + 0.5 * (v / radius)
    c = np.clip(c * np.asarray(color) * 1.4, 0, 1).astype(np.float32)
    return make_mesh(v, faces, c)


def cylinder_mesh(radius=0.03, height=0.12, segments=24,
                  color=(0.2, 0.6, 0.9), rows=1) -> Mesh:
    """Closed cylinder along z, centered at origin.

    ``rows`` splits the side wall into that many vertex rings: rows=1
    keeps the classic full-height side quads; dense stand-ins for real
    scanned meshes should pick rows ≈ segments*height/(2πr) so faces are
    roughly ISOTROPIC like a real scan's — single-row dense cylinders
    produce thousands of full-height slivers, a tessellation no scanner
    emits and a worst case for span-limited raster binning.
    """
    s = segments
    angles = np.linspace(0, 2 * np.pi, s, endpoint=False)
    ring = np.stack([np.cos(angles) * radius, np.sin(angles) * radius], -1)
    zs = np.linspace(height / 2, -height / 2, rows + 1)
    rings = [np.concatenate([ring, np.full((s, 1), z)], -1) for z in zs]
    verts = np.concatenate(rings + [[[0, 0, height / 2]],
                                    [[0, 0, -height / 2]]])
    top_c, bot_c = (rows + 1) * s, (rows + 1) * s + 1
    faces = []
    for i in range(s):
        j = (i + 1) % s
        for r in range(rows):
            a, b = r * s, (r + 1) * s
            faces += [(a + i, b + i, b + j), (a + i, b + j, a + j)]
        # Cap windings REVERSE the side faces' ring edges (top side face
        # (i, b+j, j) holds j->i, so the top cap must hold i->j; bottom
        # side face (a+i, b+i, b+j) holds b+i->b+j, so the bottom cap
        # must hold b+j->b+i): the surface is then consistently oriented
        # and closed, which is what cull_direction requires to enable
        # exact back-face culling.  (The previous cap windings duplicated
        # every ring directed edge and silently disabled culling for
        # every cylinder-class mesh.)
        faces += [(top_c, i, j)]  # top cap
        faces += [(bot_c, rows * s + j, rows * s + i)]  # bottom cap
    c = np.tile(np.asarray(color, np.float32), (len(verts), 1))
    c[:s] *= 1.2  # brighter top ring → orientation visible
    return make_mesh(verts, faces, np.clip(c, 0, 1))


def torus_mesh(r_major=0.05, r_minor=0.02, n_major=24, n_minor=12,
               color=(0.8, 0.3, 0.5)) -> Mesh:
    """Torus in the xy-plane (a z-symmetric object for ADD-S testing)."""
    verts, cols = [], []
    for i in range(n_major):
        a = 2 * np.pi * i / n_major
        for j in range(n_minor):
            b = 2 * np.pi * j / n_minor
            x = (r_major + r_minor * np.cos(b)) * np.cos(a)
            y = (r_major + r_minor * np.cos(b)) * np.sin(a)
            z = r_minor * np.sin(b)
            verts.append((x, y, z))
            shade = 0.6 + 0.4 * np.cos(b)
            cols.append(tuple(np.asarray(color) * shade))
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a0 = i * n_minor + j
            a1 = i * n_minor + (j + 1) % n_minor
            b0 = ((i + 1) % n_major) * n_minor + j
            b1 = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            faces += [(a0, b0, b1), (a0, b1, a1)]
    return make_mesh(verts, faces, cols)


def pad_mesh(mesh: Mesh, num_vertices: int, num_faces: int) -> Mesh:
    """Pad to fixed budgets so meshes of different sizes batch together.

    Padding faces are degenerate (all three indices point at a padding
    vertex) and therefore rasterize to zero area — no masking needed in
    the raster kernel.
    """
    if mesh.num_vertices > num_vertices or mesh.num_faces > num_faces:
        raise ValueError(
            f"mesh ({mesh.num_vertices}V/{mesh.num_faces}F) exceeds budget "
            f"({num_vertices}V/{num_faces}F); decimate first"
        )
    pv = num_vertices - mesh.num_vertices
    pf = num_faces - mesh.num_faces
    vertices = np.concatenate([mesh.vertices, np.zeros((pv, 3), np.float32)])
    colors = np.concatenate([mesh.colors, np.zeros((pv, 3), np.float32)])
    normals = np.concatenate([mesh.normals, np.zeros((pv, 3), np.float32)])
    pad_face = np.full((pf, 3), mesh.num_vertices, np.int32)  # degenerate
    if pv == 0:
        pad_face = np.zeros((pf, 3), np.int32)
        pad_face[:] = mesh.faces[0, 0] if mesh.num_faces else 0
    faces = np.concatenate([mesh.faces, pad_face])
    uv = None if mesh.uv is None else np.concatenate(
        [mesh.uv, np.zeros((pv, 2), np.float32)]
    )
    return Mesh(vertices, faces, colors, normals, uv=uv,
                texture=mesh.texture)


def decimate_mesh(mesh: Mesh, max_faces: int, seed: int = 0) -> Mesh:
    """Cheap vertex-clustering decimation to bound raster cost.

    Quantizes vertices onto a uniform grid (binary-searched resolution),
    merges vertices per cell, drops degenerate faces.  Not feature-
    preserving like quadric decimation, but adequate for render-and-compare
    at 1-2 px triangle scale (the CNN compares crops, not silhouette
    microstructure).
    """
    if mesh.num_faces <= max_faces:
        return mesh
    lo, hi = 4, 512  # grid resolutions to search
    best = None
    vmin = mesh.vertices.min(0)
    extent = max(float((mesh.vertices.max(0) - vmin).max()), 1e-9)
    while lo <= hi:
        res = (lo + hi) // 2
        cell = np.floor((mesh.vertices - vmin) / extent * (res - 1e-4)).astype(np.int64)
        key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        # merged vertex = mean of cluster
        counts = np.bincount(inv)
        new_v = np.zeros((len(uniq), 3), np.float64)
        new_c = np.zeros((len(uniq), 3), np.float64)
        for d in range(3):
            new_v[:, d] = np.bincount(inv, mesh.vertices[:, d]) / counts
            new_c[:, d] = np.bincount(inv, mesh.colors[:, d]) / counts
        new_uv = None
        if mesh.uv is not None:
            # cluster-mean UVs (like colors) keep the texture path alive
            # through decimation; imperfect at seams but far better than
            # silently dropping the texture.
            new_uv = np.zeros((len(uniq), 2), np.float64)
            for d in range(2):
                new_uv[:, d] = np.bincount(inv, mesh.uv[:, d]) / counts
        nf = inv[mesh.faces]
        keep = (
            (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
        )
        nf = nf[keep]
        # dedupe faces irrespective of winding-preserving rotation
        sorted_f = np.sort(nf, axis=1)
        _, uidx = np.unique(sorted_f, axis=0, return_index=True)
        nf = nf[np.sort(uidx)]
        if nf.shape[0] <= max_faces:
            best = make_mesh(new_v, nf.astype(np.int32), new_c,
                             uv=new_uv, texture=mesh.texture)
            lo = res + 1  # try finer
        else:
            hi = res - 1
    if best is None:  # even res=4 too many faces (pathological) — subsample
        keep = np.random.RandomState(seed).choice(
            mesh.num_faces, max_faces, replace=False
        )
        best = make_mesh(mesh.vertices, mesh.faces[np.sort(keep)],
                         mesh.colors, uv=mesh.uv, texture=mesh.texture)
    return best


def sample_points(mesh: Mesh, n: int = 3000, seed: int = 0) -> np.ndarray:
    """Area-weighted surface point sampling → (n, 3) float32.

    The point set consumed by the point-matching loss and the ADD(-S)
    metrics (reference keeps these in per-object point files).
    """
    rng = np.random.RandomState(seed)
    v0, v1, v2 = (mesh.vertices[mesh.faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    probs = areas / max(areas.sum(), 1e-12)
    fidx = rng.choice(mesh.num_faces, n, p=probs)
    r1, r2 = rng.rand(n, 1), rng.rand(n, 1)
    s = np.sqrt(r1)
    pts = (1 - s) * v0[fidx] + s * (1 - r2) * v1[fidx] + s * r2 * v2[fidx]
    return pts.astype(np.float32)


def cull_direction(mesh: Mesh) -> float:
    """Back-face-cull safety check -> 0.0 (unsafe) or ±1.0 (cull sign).

    Culling a face whose screen-space signed area ``d`` satisfies
    ``d * cull_direction >= 0`` is EXACT (the face is also drawn by OpenGL,
    but always behind a front face) iff the mesh is a closed, consistently
    oriented surface.  This checks both on the host at asset-build time:

    - **consistent + closed**: after merging coincident vertices (seam
      duplicates from sharp edges / UV splits are common), every directed
      edge of every non-degenerate face appears exactly once, and its
      reverse also appears exactly once;
    - **orientation sign**: the signed volume (divergence theorem) gives
      the winding handedness; with the project-then-y-down screen
      convention, outward-wound (positive-volume) meshes project FRONT
      faces to ``d < 0``, so the KEEP predicate is
      ``d * sign(volume) < 0``.

    Returns ``sign(volume)`` when safe, else 0.0 (renderers treat 0 as
    "cull disabled").  The reference's GL renderer draws both sides
    (``lib/render_glumpy/render_py.py`` never enables GL_CULL_FACE); for
    the closed meshes this check accepts, the rendered output is identical
    up to z-fighting at silhouette-grazing pixels.
    """
    v = np.asarray(mesh.vertices, np.float64)
    f = np.asarray(mesh.faces, np.int64)
    if f.shape[0] == 0:
        return 0.0
    # Merge coincident vertices so seam-duplicated meshes (box/cylinder
    # constructors, OBJ UV splits) still read as closed surfaces.
    _, remap = np.unique(v.round(9), axis=0, return_inverse=True)
    fm = remap[f]
    nondegen = (
        (fm[:, 0] != fm[:, 1]) & (fm[:, 1] != fm[:, 2])
        & (fm[:, 0] != fm[:, 2])
    )
    fm = fm[nondegen]
    if fm.shape[0] == 0:
        return 0.0
    edges = np.concatenate([fm[:, [0, 1]], fm[:, [1, 2]], fm[:, [2, 0]]])
    # Each directed edge exactly once...
    keys = edges[:, 0] * (remap.max() + 1) + edges[:, 1]
    if np.unique(keys).shape[0] != keys.shape[0]:
        return 0.0
    # ...and its reverse exactly once (closed, consistently oriented).
    rev = edges[:, 1] * (remap.max() + 1) + edges[:, 0]
    if not np.isin(keys, rev).all():
        return 0.0
    vol = np.einsum(
        "ij,ij->i", v[f[:, 0]], np.cross(v[f[:, 1]], v[f[:, 2]])
    ).sum() / 6.0
    # Degenerate (flat) "solids" have ~zero volume: no reliable side.
    scale = float(np.abs(v).max()) or 1.0
    if abs(vol) < 1e-12 * scale**3:
        return 0.0
    return float(np.sign(vol))
