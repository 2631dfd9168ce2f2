"""Mesh containers, procedural meshes, padding, decimation, surface sampling.

Numpy copy of the parts of ``deepim_tpu/raster/mesh.py`` that
``build_assets``, the headline protocol and ``load_assets_and_names`` need:
``Mesh``, ``make_mesh``, ``compute_vertex_normals``, every procedural
builder (``box_mesh``, ``icosphere_mesh``, ``cylinder_mesh``,
``torus_mesh``, ``cone_mesh``, ``capsule_mesh``, ``prism_mesh``,
``star_mesh``, ``frustum_mesh``, ``tube_mesh``, ``lshape_mesh``, with
``merge_meshes``, ``_triangulate_polygon`` and ``extrude_polygon_mesh``),
``PROCEDURAL_MESHES``, ``ZOO_FAMILIES`` and ``random_mesh_zoo``,
``pad_mesh``, ``decimate_mesh``, ``sample_points`` and ``cull_direction``,
and the texture helpers ``procedural_texture``, ``planar_uv``,
``texturize`` and ``bake_texture_to_vertices``; and the mesh readers'
Python paths: ``load_ply`` with the writer ``save_ply``, ``load_obj``
(with ``_parse_mtl``), ``load_off``, ``normalize_mesh`` and ``load_mesh``,
their texture images read through :mod:`deepim_tpu_torch.data.png`.

A copy and not an import: ``deepim_tpu/raster/__init__.py`` imports jax.
Routed as the reference routes them: meshes of ``_NATIVE_MIN_FACES``
(20,000) faces and more get their vertex normals, and untextured ones their
decimation, from the port's C++ host runtime (:mod:`deepim_tpu_torch.native`),
which also parses untextured PLY and single-material OBJ files.  Below the
threshold, and for what the C++ refuses, the numpy and Python paths run;
``plain=True`` (``compute_vertex_normals``, ``make_mesh``,
``decimate_mesh`` and the loaders) takes them at every size, as the plain
versions the C++ is held to.  ``tests/test_torch_assets.py`` holds
the copy bit-identical to the reference on its default route.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from deepim_tpu_torch import native


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



# Face count from which load-time mesh ops route to the C++ host runtime
# (numpy's unbuffered np.add.at is slow on 100k+-face scans).  Below it,
# numpy keeps the procedural meshes' numerics byte-stable, as in the
# reference (``deepim_tpu/raster/mesh.py §_NATIVE_MIN_FACES``).
_NATIVE_MIN_FACES = 20_000


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray,
                           plain: bool = False) -> np.ndarray:
    """Area-weighted vertex normals (load-time only): C++
    (``csrc/deepim_native.cpp §dn_vertex_normals``) from
    ``_NATIVE_MIN_FACES`` faces up unless ``plain``, else numpy."""
    if len(faces) >= _NATIVE_MIN_FACES and not plain:
        return native.vertex_normals(vertices, faces)
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normals
    normals = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def make_mesh(vertices, faces, colors=None, uv=None, texture=None,
              plain: bool = False) -> Mesh:
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    if colors is None:
        colors = np.full_like(vertices, 0.7)
    colors = np.asarray(colors, np.float32)
    return Mesh(vertices, faces, colors,
                compute_vertex_normals(vertices, faces, plain),
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


def decimate_mesh(mesh: Mesh, max_faces: int, seed: int = 0, plain: bool = False) -> Mesh:
    """Cheap vertex-clustering decimation to bound raster cost.

    Quantizes vertices onto a uniform grid (binary-searched resolution),
    merges vertices per cell, drops degenerate faces.  Not feature-
    preserving like quadric decimation, but adequate for render-and-compare
    at 1-2 px triangle scale (the CNN compares crops, not silhouette
    microstructure).  Untextured meshes of ``_NATIVE_MIN_FACES`` faces and
    more decimate in C++ (``§dn_decimate``, the same clustering; its vertices
    come in the order the cells are first met), unless ``plain``.
    """
    if mesh.num_faces <= max_faces:
        return mesh
    if mesh.num_faces >= _NATIVE_MIN_FACES and mesh.uv is None and not plain:
        out = native.decimate(mesh.vertices, mesh.colors, mesh.faces, max_faces)
        if out is not None:
            v, c, f = out
            return make_mesh(v, f, c)
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
                             uv=new_uv, texture=mesh.texture, plain=plain)
            lo = res + 1  # try finer
        else:
            hi = res - 1
    if best is None:  # even res=4 too many faces (pathological) — subsample
        keep = np.random.RandomState(seed).choice(
            mesh.num_faces, max_faces, replace=False
        )
        best = make_mesh(mesh.vertices, mesh.faces[np.sort(keep)],
                         mesh.colors, uv=mesh.uv, texture=mesh.texture, plain=plain)
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


# ---------------------------------------------------------------------------
# Textures (procedural stand-ins for scanned texture maps)
# ---------------------------------------------------------------------------


def procedural_texture(seed: int, size: tuple[int, int] = (64, 64)
                       ) -> np.ndarray:
    """Random layered texture image -> (H, W, 3) float32 in [0, 1].

    Stand-in for YCB's scanned texture maps (the sandbox has no real
    assets): a base color plus 2-3 random layers drawn from
    {checkerboard, stripes, gaussian blobs, smooth noise} — enough spatial
    structure that per-pixel texture sampling carries real appearance
    signal (flow/pose supervision can latch onto texture detail the way it
    does on scanned meshes).
    """
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.ones((h, w, 3), np.float32) * (0.25 + 0.6 * rng.rand(3))

    def rand_color():
        return (0.1 + 0.9 * rng.rand(3)).astype(np.float32)

    for _ in range(rng.randint(2, 4)):
        kind = rng.randint(4)
        color = rand_color()
        alpha = 0.4 + 0.6 * rng.rand()
        if kind == 0:  # checkerboard
            cell = rng.randint(4, max(5, h // 4))
            m = ((yy // cell + xx // cell) % 2).astype(np.float32)
        elif kind == 1:  # stripes at a random angle
            ang = rng.rand() * np.pi
            period = rng.randint(6, max(7, h // 2))
            t = xx * np.cos(ang) + yy * np.sin(ang)
            m = (np.sin(2 * np.pi * t / period) > 0).astype(np.float32)
        elif kind == 2:  # gaussian blobs
            m = np.zeros((h, w), np.float32)
            for _b in range(rng.randint(3, 8)):
                cy, cx_ = rng.rand(2) * (h, w)
                s = (0.05 + 0.15 * rng.rand()) * h
                m += np.exp(-((yy - cy) ** 2 + (xx - cx_) ** 2)
                            / (2 * s * s))
            m = np.clip(m, 0, 1)
        else:  # smooth noise (upsampled coarse grid, bilinear)
            g = rng.rand(5, 5).astype(np.float32)
            fy = np.linspace(0, 4, h)
            fx = np.linspace(0, 4, w)
            y0 = np.clip(fy.astype(int), 0, 3)
            x0 = np.clip(fx.astype(int), 0, 3)
            ty = (fy - y0)[:, None]
            tx = (fx - x0)[None, :]
            m = ((1 - ty) * (1 - tx) * g[y0][:, x0]
                 + (1 - ty) * tx * g[y0][:, x0 + 1]
                 + ty * (1 - tx) * g[y0 + 1][:, x0]
                 + ty * tx * g[y0 + 1][:, x0 + 1])
        img = img * (1 - alpha * m[..., None]) \
            + color * (alpha * m[..., None])
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def planar_uv(vertices: np.ndarray, axis: int = 2) -> np.ndarray:
    """Planar-projection UVs: drop ``axis``, normalize the other two to
    [0, 1] -> (V, 2).

    Seam-free by construction (u, v are continuous in vertex position —
    no cylindrical wrap), which matters because the deferred-texturing
    raster interpolates per-corner UVs and the atlas sampler clamps to
    [0, 1]; the cost is mirrored texture on surfaces facing away from the
    projection axis, irrelevant for training-signal purposes.
    """
    keep = [i for i in range(3) if i != axis]
    p = vertices[:, keep].astype(np.float32)
    lo = p.min(0)
    ext = np.maximum(p.max(0) - lo, 1e-6)
    return (p - lo) / ext


def texturize(mesh: Mesh, seed: int, size: tuple[int, int] = (64, 64)
              ) -> Mesh:
    """Attach a procedural texture + planar UVs to a mesh (random
    projection axis per seed); colors are re-baked so the baked-vertex
    fallback path stays consistent with the texture."""
    rng = np.random.RandomState(seed)
    uv = planar_uv(mesh.vertices, axis=int(rng.randint(3)))
    tex = procedural_texture(seed, size)
    colors = bake_texture_to_vertices(uv, tex)
    return Mesh(mesh.vertices, mesh.faces, colors.astype(np.float32),
                mesh.normals, uv=uv.astype(np.float32), texture=tex)


def bake_texture_to_vertices(uv: np.ndarray, texture: np.ndarray) -> np.ndarray:
    """Sample a texture image at per-vertex UVs -> (V, 3) colors in [0, 1].

    YCB-style textured meshes sample in v1 via color baking (SURVEY.md §7
    step 2: dodge in-raster texture lookups; scanned meshes are dense
    enough that per-vertex color preserves appearance at crop scales).
    UV origin bottom-left (OpenGL convention, matching the reference's
    GLSL texture path); bilinear taps.
    """
    h, w = texture.shape[:2]
    x = np.clip(uv[:, 0], 0, 1) * (w - 1)
    y = (1.0 - np.clip(uv[:, 1], 0, 1)) * (h - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    t = texture[..., :3].astype(np.float32)
    if t.max() > 1.5:
        t = t / 255.0
    top = t[y0, x0] * (1 - tx) + t[y0, x1] * tx
    bot = t[y1, x0] * (1 - tx) + t[y1, x1] * tx
    return (top * (1 - ty) + bot * ty).astype(np.float32)


def cone_mesh(radius=0.04, height=0.1, segments=24,
              color=(0.3, 0.75, 0.4)) -> Mesh:
    """Cone with apex at +z (z-symmetric category for the shape zoo)."""
    verts = [(0.0, 0.0, height / 2), (0.0, 0.0, -height / 2)]
    cols = [tuple(np.asarray(color) * 1.2), tuple(np.asarray(color) * 0.5)]
    for i in range(segments):
        a = 2 * np.pi * i / segments
        verts.append((radius * np.cos(a), radius * np.sin(a), -height / 2))
        # Rotationally uniform ring color: the cone is treated as
        # z-symmetric (PM loss / ADD-S), so its appearance must be too.
        cols.append(tuple(np.asarray(color) * 0.85))
    faces = []
    for i in range(segments):
        a0 = 2 + i
        a1 = 2 + (i + 1) % segments
        faces += [(0, a0, a1), (1, a1, a0)]  # side + base fan
    return make_mesh(verts, faces, np.clip(np.asarray(cols), 0, 1))


def capsule_mesh(radius=0.03, height=0.08, segments=16, rings=6,
                 color=(0.85, 0.65, 0.25)) -> Mesh:
    """Cylinder with hemispherical caps (z-symmetric zoo category)."""
    verts, cols = [], []
    half = height / 2
    # Stacked latitude rings: bottom cap, straight section, top cap.
    lat = (
        [(-np.pi / 2 + (np.pi / 2) * (r / rings), -half) for r in range(rings)]
        + [(0.0, -half), (0.0, half)]
        + [((np.pi / 2) * (r / rings), half) for r in range(1, rings + 1)]
    )
    for phi, zc in lat:
        rr = radius * np.cos(phi)
        zz = zc + radius * np.sin(phi)
        for i in range(segments):
            a = 2 * np.pi * i / segments
            verts.append((rr * np.cos(a), rr * np.sin(a), zz))
            shade = 0.6 + 0.4 * (zz + half + radius) / (height + 2 * radius)
            cols.append(tuple(np.asarray(color) * shade))
    faces = []
    n_lat = len(lat)
    for r in range(n_lat - 1):
        for i in range(segments):
            a0 = r * segments + i
            a1 = r * segments + (i + 1) % segments
            b0 = (r + 1) * segments + i
            b1 = (r + 1) * segments + (i + 1) % segments
            faces += [(a0, b0, b1), (a0, b1, a1)]
    return make_mesh(verts, faces, np.clip(np.asarray(cols), 0, 1))


def merge_meshes(meshes: list[Mesh]) -> Mesh:
    """Concatenate meshes into one (faces re-indexed; normals recomputed).

    Overlapping interior geometry is harmless for z-buffered rendering and
    surface sampling — used to compose non-convex zoo shapes from boxes.
    """
    verts, faces, cols, base = [], [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + base)
        cols.append(m.colors)
        base += m.num_vertices
    return make_mesh(np.concatenate(verts), np.concatenate(faces),
                     np.concatenate(cols))


def _triangulate_polygon(poly: np.ndarray) -> list[tuple[int, int, int]]:
    """Ear-clipping triangulation of a simple CCW polygon (O(n^2))."""
    n = poly.shape[0]
    idx = list(range(n))

    def cross(o, a, b):
        return (poly[a, 0] - poly[o, 0]) * (poly[b, 1] - poly[o, 1]) - \
               (poly[a, 1] - poly[o, 1]) * (poly[b, 0] - poly[o, 0])

    tris = []
    guard = 0
    while len(idx) > 3 and guard < 4 * n * n:
        guard += 1
        n_cur = len(idx)
        for k in range(n_cur):
            a, b, c = idx[k - 1], idx[k], idx[(k + 1) % n_cur]
            if cross(a, b, c) <= 1e-18:  # reflex or degenerate corner
                continue
            # ear test: no other polygon vertex strictly inside (a, b, c)
            ear = True
            for m in idx:
                if m in (a, b, c):
                    continue
                if (cross(a, b, m) > 0 and cross(b, c, m) > 0
                        and cross(c, a, m) > 0):
                    ear = False
                    break
            if ear:
                tris.append((a, b, c))
                idx.pop(k)
                break
        else:  # numerical dead end: fan the rest (star-shaped fallback)
            break
    if len(idx) == 3:
        tris.append(tuple(idx))
    else:
        tris += [(idx[0], idx[k], idx[k + 1]) for k in range(1, len(idx) - 1)]
    return tris


def extrude_polygon_mesh(poly_xy, height, color=(0.6, 0.6, 0.8),
                         cap_shade=(1.15, 0.6)) -> Mesh:
    """Extrude a simple CCW 2D polygon along z; ear-clipped caps.

    Side shading varies with vertex index and the caps differ in
    brightness so orientation is observable in renders.
    """
    poly = np.asarray(poly_xy, np.float64)
    n = poly.shape[0]
    half = height / 2
    col = np.asarray(color, np.float64)
    top = np.concatenate([poly, np.full((n, 1), half)], -1)
    bot = np.concatenate([poly, np.full((n, 1), -half)], -1)
    verts = np.concatenate([top, bot])
    shade = (0.65 + 0.35 * np.cos(2 * np.pi * np.arange(n) / n))[:, None]
    cols = np.concatenate([
        col * shade * cap_shade[0],  # top ring brighter
        col * shade * cap_shade[1],  # bottom ring darker
    ])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [(i, n + i, n + j), (i, n + j, j)]  # side wall
    for a, b, c in _triangulate_polygon(poly):
        faces.append((a, b, c))                      # top cap
        faces.append((n + c, n + b, n + a))          # bottom cap
    return make_mesh(verts, faces, np.clip(cols, 0, 1))


def prism_mesh(n_sides=6, rx=0.04, ry=0.04, height=0.1,
               color=(0.55, 0.45, 0.8)) -> Mesh:
    """n-gonal prism with (optionally anisotropic) cross-section."""
    a = 2 * np.pi * np.arange(n_sides) / n_sides
    poly = np.stack([rx * np.cos(a), ry * np.sin(a)], -1)
    return extrude_polygon_mesh(poly, height, color)


def star_mesh(points=5, r_outer=0.05, r_inner=0.022, height=0.03,
              color=(0.85, 0.75, 0.25)) -> Mesh:
    """Extruded star polygon (non-convex silhouette zoo category)."""
    a = np.pi * np.arange(2 * points) / points
    r = np.where(np.arange(2 * points) % 2 == 0, r_outer, r_inner)
    poly = np.stack([r * np.cos(a), r * np.sin(a)], -1)
    return extrude_polygon_mesh(poly, height, color)


def frustum_mesh(r_bottom=0.045, r_top=0.02, height=0.09, segments=24,
                 color=(0.35, 0.7, 0.65)) -> Mesh:
    """Truncated cone along z (z-symmetric zoo category)."""
    a = 2 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.cos(a), np.sin(a)], -1)
    half = height / 2
    top = np.concatenate([ring * r_top, np.full((segments, 1), half)], -1)
    bot = np.concatenate([ring * r_bottom, np.full((segments, 1), -half)], -1)
    verts = np.concatenate([top, bot, [[0, 0, half]], [[0, 0, -half]]])
    col = np.asarray(color, np.float64)
    cols = np.concatenate([
        np.tile(col * 1.15, (segments, 1)), np.tile(col * 0.75, (segments, 1)),
        [col * 1.25], [col * 0.6],
    ])
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [(i, segments + i, segments + j), (i, segments + j, j)]
        faces += [(2 * segments, i, j)]
        faces += [(2 * segments + 1, segments + j, segments + i)]
    return make_mesh(verts, faces, np.clip(cols, 0, 1))


def tube_mesh(r_outer=0.045, r_inner=0.028, height=0.06, segments=24,
              color=(0.75, 0.4, 0.3)) -> Mesh:
    """Hollow cylinder (genus-1: a through-hole, without being a torus).

    The only training-zoo family with non-trivial topology — teaches the
    unseen-category net that objects can have holes (the eval torus does).
    """
    a = 2 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.cos(a), np.sin(a)], -1)
    half = height / 2
    rings = [  # outer-top, outer-bot, inner-top, inner-bot
        np.concatenate([ring * r_outer, np.full((segments, 1), half)], -1),
        np.concatenate([ring * r_outer, np.full((segments, 1), -half)], -1),
        np.concatenate([ring * r_inner, np.full((segments, 1), half)], -1),
        np.concatenate([ring * r_inner, np.full((segments, 1), -half)], -1),
    ]
    verts = np.concatenate(rings)
    col = np.asarray(color, np.float64)
    cols = np.concatenate([
        np.tile(col * 1.1, (segments, 1)), np.tile(col * 0.7, (segments, 1)),
        np.tile(col * 0.9, (segments, 1)), np.tile(col * 0.55, (segments, 1)),
    ])
    ot, ob, it_, ib = 0, segments, 2 * segments, 3 * segments
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        # outer wall (outward), inner wall (inward), top + bottom annuli
        faces += [(ot + i, ob + i, ob + j), (ot + i, ob + j, ot + j)]
        faces += [(it_ + i, ib + j, ib + i), (it_ + i, it_ + j, ib + j)]
        faces += [(ot + i, ot + j, it_ + j), (ot + i, it_ + j, it_ + i)]
        faces += [(ob + i, ib + j, ob + j), (ob + i, ib + i, ib + j)]
    return make_mesh(verts, faces, np.clip(cols, 0, 1))


def lshape_mesh(leg=0.1, width=0.04, thickness=0.035,
                color=(0.4, 0.55, 0.85)) -> Mesh:
    """Extruded L-bracket (non-convex zoo category; ear-clipped caps)."""
    lg, w = leg, width
    poly = np.array([(0, 0), (lg, 0), (lg, w), (w, w), (w, lg), (0, lg)],
                    np.float64) - lg / 2  # AABB-centered
    return extrude_polygon_mesh(poly, thickness, color)


PROCEDURAL_MESHES = {
    "box": box_mesh,
    "icosphere": icosphere_mesh,
    "cylinder": cylinder_mesh,
    "torus": torus_mesh,
    "cone": cone_mesh,
    "capsule": capsule_mesh,
    "prism": prism_mesh,
    "star": star_mesh,
    "frustum": frustum_mesh,
    "tube": tube_mesh,
    "lshape": lshape_mesh,
    # Dense stand-ins for real scanned assets (~8-20k faces) — the
    # tessellation regime of YCB scans.  Same shapes/slot order as
    # tools/decimation_ab.py's dense list, so a checkpoint trained on
    # these (experiments/cfgs/synthetic_dense.yaml) is IN-domain for the
    # decimation accuracy A/B (round-4 VERDICT weak #3: the original A/B
    # used an out-of-domain checkpoint and measured training-domain
    # mismatch, not decimation fidelity).
    "icosphere_dense": lambda: icosphere_mesh(0.06, subdivisions=5),
    "icosphere_dense2": lambda: icosphere_mesh(0.05, subdivisions=5),
    "torus_dense": lambda: torus_mesh(n_major=96, n_minor=48),
    "cylinder_dense": lambda: cylinder_mesh(segments=256, rows=16),
}


ZOO_FAMILIES = ("box", "sphere", "cylinder", "torus", "cone", "capsule",
                "prism", "star", "frustum", "tube", "lshape")


def random_mesh_zoo(n: int, seed: int = 0,
                    families: tuple[str, ...] = ZOO_FAMILIES,
                    texture_prob: float = 0.0) -> dict[str, Mesh]:
    """n random-parameter procedural meshes — the ModelNet-protocol shape
    zoo (unseen-category generalization needs MANY training shapes;
    reference trains on hundreds of ModelNet categories).

    Shapes cycle through ``families`` with randomized dimensions, colors,
    and (for boxes) per-face palettes.  Restricting ``families`` holds
    whole shape CATEGORIES out of training — the honest unseen-category
    protocol (evaluating on a canonical sphere after training on random
    spheres is only unseen-instance).
    """
    rng = np.random.RandomState(seed)
    # Separate stream for texturing decisions: texture_prob must not
    # perturb the geometry draws (same zoo shapes with or without textures).
    tex_rng = np.random.RandomState(seed + 987654)
    zoo: dict[str, Mesh] = {}
    for i in range(n):
        kind = families[i % len(families)]
        color = tuple(0.25 + 0.75 * rng.rand(3))
        if kind == "box":
            size = tuple(0.04 + 0.12 * rng.rand(3))
            face_colors = [tuple(0.2 + 0.8 * rng.rand(3)) for _ in range(6)]
            m = box_mesh(size, face_colors=face_colors)
            name = f"zoo_box_{i:03d}"
        elif kind == "sphere":
            m = icosphere_mesh(0.03 + 0.04 * rng.rand(), subdivisions=2,
                               color=color)
            name = f"zoo_sphere_{i:03d}"
        elif kind == "cylinder":
            m = cylinder_mesh(0.02 + 0.03 * rng.rand(),
                              0.06 + 0.1 * rng.rand(),
                              segments=int(12 + 16 * rng.rand()),
                              color=color)
            name = f"zoo_cyl_{i:03d}"
        elif kind == "torus":
            r_mj = 0.03 + 0.04 * rng.rand()
            m = torus_mesh(r_mj, 0.25 * r_mj + 0.015 * rng.rand(),
                           color=color)
            name = f"zoo_torus_{i:03d}"
        elif kind == "cone":
            m = cone_mesh(0.025 + 0.035 * rng.rand(),
                          0.06 + 0.09 * rng.rand(),
                          segments=int(12 + 16 * rng.rand()), color=color)
            name = f"zoo_cone_{i:03d}"
        elif kind == "capsule":
            m = capsule_mesh(0.02 + 0.025 * rng.rand(),
                             0.04 + 0.08 * rng.rand(),
                             segments=int(12 + 8 * rng.rand()), color=color)
            name = f"zoo_capsule_{i:03d}"
        elif kind == "prism":
            m = prism_mesh(int(rng.randint(3, 9)),
                           0.02 + 0.035 * rng.rand(),
                           0.02 + 0.035 * rng.rand(),
                           0.05 + 0.1 * rng.rand(), color=color)
            name = f"zoo_prism_{i:03d}"
        elif kind == "star":
            ro = 0.035 + 0.03 * rng.rand()
            m = star_mesh(int(rng.randint(4, 8)), ro,
                          ro * (0.35 + 0.2 * rng.rand()),
                          0.02 + 0.04 * rng.rand(), color=color)
            name = f"zoo_star_{i:03d}"
        elif kind == "frustum":
            rb = 0.03 + 0.03 * rng.rand()
            m = frustum_mesh(rb, rb * (0.25 + 0.45 * rng.rand()),
                             0.05 + 0.08 * rng.rand(),
                             segments=int(12 + 16 * rng.rand()), color=color)
            name = f"zoo_frustum_{i:03d}"
        elif kind == "tube":
            ro = 0.03 + 0.03 * rng.rand()
            m = tube_mesh(ro, ro * (0.45 + 0.3 * rng.rand()),
                          0.03 + 0.08 * rng.rand(),
                          segments=int(12 + 16 * rng.rand()), color=color)
            name = f"zoo_tube_{i:03d}"
        elif kind == "lshape":
            lg = 0.06 + 0.07 * rng.rand()
            m = lshape_mesh(lg, lg * (0.25 + 0.2 * rng.rand()),
                            lg * (0.2 + 0.25 * rng.rand()), color=color)
            name = f"zoo_lshape_{i:03d}"
        else:
            raise ValueError(f"unknown zoo family {kind!r}")
        if texture_prob > 0.0 and tex_rng.rand() < texture_prob:
            m = texturize(m, seed * 100003 + i)
        zoo[name] = m
    return zoo


# ---------------------------------------------------------------------------
# PLY IO (``deepim_tpu/raster/mesh.py §_sniff_texture, §load_ply, §save_ply``).
# An untextured file is parsed by the C++ host runtime, as in the reference;
# the Python parser below reads the rest and is the C++'s plain version.
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
    "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
}


def _sniff_texture(path: str) -> str | None:
    """Header peek: per-vertex UVs and 'comment TextureFile <f>' -> the
    texture's path (YCB textured.ply style), else None."""
    tex_file = None
    has_uv = False
    with open(path, "rb") as f:
        for _ in range(100):
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("comment TextureFile"):
                tex_file = line.split()[-1]
            if line.startswith("property") and line.split()[-1] in ("texture_u", "s", "u"):
                has_uv = True  # the property's name, not a suffix of the line
            if line == "end_header" or not line:
                break
    if has_uv and tex_file:
        cand = os.path.join(os.path.dirname(path), tex_file)
        if os.path.exists(cand):
            return cand
    return None


def _read_ply_elements(f, fmt: str, elements) -> dict:
    data = {}
    if fmt == "ascii":
        for name, count, props in elements:
            data[name] = ([f.readline().decode("ascii").split() for _ in range(count)], props)
        return data
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format: {fmt}")
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dt = np.dtype([(p[2], "<" + _PLY_TYPES[p[1]]) for p in props])
            data[name] = (np.frombuffer(f.read(dt.itemsize * count), dtype=dt), props)
            continue
        rows = []  # list properties (faces): row by row
        for _ in range(count):
            row = []
            for p in props:
                if p[0] == "list":
                    cnt_t = np.dtype("<" + _PLY_TYPES[p[1]])
                    idx_t = np.dtype("<" + _PLY_TYPES[p[2]])
                    n = int(np.frombuffer(f.read(cnt_t.itemsize), cnt_t)[0])
                    row.append(np.frombuffer(f.read(idx_t.itemsize * n), idx_t))
                else:
                    st = np.dtype("<" + _PLY_TYPES[p[1]])
                    row.append(np.frombuffer(f.read(st.itemsize), st)[0])
            rows.append(row)
        data[name] = (rows, props)
    return data


def load_ply(path: str, plain: bool = False) -> Mesh:
    """PLY reader: xyz (+ rgb) and faces, ascii or binary little endian.

    Covers the LM6d ``models/<obj>/textured.ply`` vertex-coloured meshes;
    polygons are fan-triangulated.  A textured PLY (per-vertex UVs and a
    ``comment TextureFile`` naming a PNG) bakes its texture to the vertex
    colours and keeps uv and texture on the mesh.  An untextured file is
    parsed in C++ (``csrc/deepim_native.cpp §dn_load_ply``) unless ``plain``;
    what the C++ refuses comes here, to the Python parser.
    """
    textured = _sniff_texture(path)
    if textured is None and not plain:
        out = native.load_ply(path)
        if out is not None:
            v, c, f = out
            return make_mesh(v, f, c)
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        elements = []  # (name, count, [(kind, types..., prop)])
        for line in header:
            parts = line.split()
            if parts and parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts and parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append(("scalar", parts[1], parts[2]))
        data = _read_ply_elements(f, fmt, elements)

    vrows, vprops = data["vertex"]
    names = [p[2] for p in vprops if p[0] == "scalar"]
    if isinstance(vrows, np.ndarray):
        def get(n):
            return vrows[n].astype(np.float32)
    else:
        cols_arr = np.asarray(vrows, np.float64)

        def get(n):
            return cols_arr[:, names.index(n)].astype(np.float32)
    vertices = np.stack([get("x"), get("y"), get("z")], -1)
    if "red" in names:
        colors = np.stack([get("red"), get("green"), get("blue")], -1) / 255.0
    else:
        colors = np.full_like(vertices, 0.7)
    uv_names = ("texture_u", "texture_v") if "texture_u" in names else (
        ("s", "t") if "s" in names and "t" in names else None)
    uv = texture = None
    if textured is not None and uv_names is not None:
        from deepim_tpu_torch.data.png import read_png

        uv = np.stack([get(uv_names[0]), get(uv_names[1])], -1)
        tex_img = read_png(textured)
        if tex_img.ndim != 3:
            raise ValueError(f"{textured}: a texture must be an RGB image")
        colors = bake_texture_to_vertices(uv, tex_img)
        texture = tex_img[..., :3].astype(np.float32) / 255.0

    tris = []
    for row in data.get("face", ([], []))[0]:
        if isinstance(row[0], str):  # ascii: ["3", "0", "1", "2", ...]
            idx = np.asarray(row[1: 1 + int(row[0])], np.int64)
        else:  # binary: the first entry is the parsed index array
            idx = np.asarray(row[0], np.int64)
        for k in range(1, len(idx) - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
    faces = np.asarray(tris, np.int32).reshape(-1, 3)
    m = make_mesh(vertices, faces, colors, plain=plain)
    if uv is not None:
        m = Mesh(m.vertices, m.faces, m.colors, m.normals, uv=uv.astype(np.float32),
                 texture=texture)
    return m


def save_ply(path: str, mesh: Mesh) -> None:
    """ASCII PLY writer: xyz, 8-bit rgb, triangles (``load_ply`` reads it)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {mesh.num_vertices}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {mesh.num_faces}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v, c in zip(mesh.vertices, mesh.colors):
            r, g, b = (int(np.clip(x * 255, 0, 255)) for x in c)
            f.write(f"{v[0]} {v[1]} {v[2]} {r} {g} {b}\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------------
# OBJ (+ MTL and texture) and OFF IO (``deepim_tpu/raster/mesh.py
# §_parse_mtl, §load_obj, §load_off, §normalize_mesh, §load_mesh``): YCB
# ships textured.obj beside textured.ply, ModelNet .off CAD files.  A
# single-material OBJ is parsed by the C++ host runtime, as in the
# reference; the Python parser reads the rest and is the C++'s plain version.
# ---------------------------------------------------------------------------


def _read_rgb(path: str) -> np.ndarray:
    """A texture map as uint8 (H, W, 3) (grey maps repeat their channel)."""
    from deepim_tpu_torch.data.png import read_png

    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a texture map must be an 8-bit image")
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


def _parse_mtl(path: str) -> dict[str, dict]:
    """Wavefront MTL -> {material: {"kd": (3,) float32, "map_kd": path or None}}."""
    mats: dict[str, dict] = {}
    cur = None
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = parts[1] if len(parts) > 1 else ""
                mats[cur] = {"kd": np.array([0.7, 0.7, 0.7], np.float32), "map_kd": None}
            elif cur is not None and parts[0] == "Kd" and len(parts) >= 4:
                mats[cur]["kd"] = np.asarray(parts[1:4], np.float32)
            elif cur is not None and parts[0].lower() == "map_kd":
                # the file name may hold spaces: everything after the key
                rel = line.split(None, 1)[1].strip()
                cand = os.path.join(os.path.dirname(path), rel)
                mats[cur]["map_kd"] = cand if os.path.exists(cand) else None
    return mats


def _load_obj_native(path: str) -> Mesh | None:
    """``load_obj``'s C++ route (``deepim_tpu/raster/mesh.py §load_obj``'s
    native branch): the geometry from ``csrc/deepim_native.cpp
    §dn_load_obj``, the materials here -> the mesh, or None for a file the
    C++ refuses or one with several materials."""
    out = native.load_obj(path)
    if out is None or out[5] > 1:
        return None
    nv, nc, nuv, nfaces, mtllib, _ = out
    mtl: dict[str, dict] = {}
    if mtllib:
        mpath = os.path.join(os.path.dirname(path), mtllib)
        if os.path.exists(mpath):
            mtl = _parse_mtl(mpath)
    if nc.max() > 1.5:  # 0-255-valued vertex colors
        nc = nc / 255.0
    tex_path = next((m["map_kd"] for m in mtl.values() if m.get("map_kd")), None)
    if tex_path is not None and nuv is not None:
        img = _read_rgb(tex_path)
        mesh = make_mesh(nv, nfaces, bake_texture_to_vertices(nuv, img))
        return Mesh(mesh.vertices, mesh.faces, mesh.colors, mesh.normals, uv=nuv,
                    texture=img[..., :3].astype(np.float32) / 255.0)
    if mtl and np.allclose(nc, 0.7, atol=1e-6):
        # no vertex colors, no texture -> the flat material Kd
        kd = next(iter(mtl.values()))["kd"]
        nc = np.tile(np.asarray(kd, np.float32)[None], (len(nv), 1))
    return make_mesh(nv, nfaces, nc)


def load_obj(path: str, plain: bool = False) -> Mesh:
    """Wavefront .obj: v/vt/f, with MTL diffuse colours and texture maps.

    Faces are fan-triangulated; (vertex, uv) corner pairs are deduplicated
    into one vertex array, so UVs live per vertex.  Colours: the
    ``v x y z r g b`` extension, else the texture baked to the vertices,
    else each material's Kd, else grey 0.7.  The uv and texture arrays stay
    on the mesh when exactly one texture map is used.  Negative (relative)
    indices are honoured.  A file of at most one material is parsed in C++
    (:func:`_load_obj_native`) unless ``plain``; a multi-material one, or
    one the C++ refuses, by the Python parser below.
    """
    if not plain:
        mesh = _load_obj_native(path)
        if mesh is not None:
            return mesh
    positions: list[list[float]] = []
    vcolors: list[list[float]] = []
    uvs: list[list[float]] = []
    faces_raw: list[tuple[list[int], list[int | None], str | None]] = []
    mtl: dict[str, dict] = {}
    cur_mat: str | None = None

    def _vidx(tok: str, n: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else n + i

    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    vcolors.append([float(x) for x in parts[4:7]])
            elif key == "vt":
                uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif key == "f":
                vi, ti = [], []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi.append(_vidx(comps[0], len(positions)))
                    ti.append(_vidx(comps[1], len(uvs)) if len(comps) > 1 and comps[1] else None)
                faces_raw.append((vi, ti, cur_mat))
            elif key == "mtllib" and len(parts) > 1:
                mpath = os.path.join(os.path.dirname(path), line.split(None, 1)[1].strip())
                if os.path.exists(mpath):
                    mtl.update(_parse_mtl(mpath))
            elif key == "usemtl":
                cur_mat = parts[1] if len(parts) > 1 else None

    if not positions:
        raise ValueError(f"OBJ has no vertices: {path}")
    pos = np.asarray(positions, np.float32)
    uv_arr = np.asarray(uvs, np.float32) if uvs else None

    # Unify (position, uv) corner pairs -> per-vertex UVs.
    has_uv = uv_arr is not None and any(t is not None for _, ti, _ in faces_raw for t in ti)
    corner_map: dict[tuple[int, int], int] = {}
    out_pos: list[np.ndarray] = []
    out_uv: list[np.ndarray] = []
    out_src: list[int] = []  # the original vertex of each corner (its colour)
    tris: list[tuple[int, int, int]] = []
    tri_mat: list[str | None] = []

    def _corner(v: int, t: int | None) -> int:
        if not has_uv:
            return v
        key = (v, -1 if t is None else t)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(out_pos)
            corner_map[key] = idx
            out_pos.append(pos[v])
            out_uv.append(uv_arr[t] if t is not None else np.zeros(2, np.float32))
            out_src.append(v)
        return idx

    for vi, ti, mat in faces_raw:
        corners = [_corner(v, t) for v, t in zip(vi, ti)]
        for k in range(1, len(corners) - 1):
            tris.append((corners[0], corners[k], corners[k + 1]))
            tri_mat.append(mat)

    faces = np.asarray(tris, np.int32).reshape(-1, 3)
    if has_uv:
        vertices, uv_final, src = np.stack(out_pos), np.stack(out_uv), np.asarray(out_src)
    else:
        vertices, uv_final, src = pos, None, np.arange(len(pos))

    if vcolors and len(vcolors) == len(positions):
        colors = np.asarray(vcolors, np.float32)[src]
        if colors.max() > 1.5:
            colors = colors / 255.0
    else:
        colors = np.full((len(vertices), 3), 0.7, np.float32)

    tex_paths = sorted({m["map_kd"] for m in mtl.values() if m.get("map_kd")})
    texture = None
    if tex_paths and uv_final is not None:
        # Bake every map onto its material's vertices; keep the texture
        # on the mesh only when there is one map (one atlas slot an object).
        for tp in tex_paths:
            img = _read_rgb(tp)
            mat_names = {n for n, m in mtl.items() if m.get("map_kd") == tp}
            baked = bake_texture_to_vertices(uv_final, img)
            verts_of = np.unique(faces[np.asarray([m in mat_names for m in tri_mat], bool)])
            colors[verts_of] = baked[verts_of]
        if len(tex_paths) == 1:
            texture = _read_rgb(tex_paths[0]).astype(np.float32) / 255.0
    elif mtl and not vcolors:
        for name, m in mtl.items():
            verts_of = (np.unique(faces[np.asarray([mm == name for mm in tri_mat], bool)])
                        if any(mm == name for mm in tri_mat) else np.arange(0))
            colors[verts_of] = m["kd"]

    mesh = make_mesh(vertices, faces, colors, plain=plain)
    if texture is not None:
        mesh = Mesh(mesh.vertices, mesh.faces, mesh.colors, mesh.normals, uv=uv_final,
                    texture=texture)
    return mesh


def load_off(path: str, plain: bool = False) -> Mesh:
    """OFF/COFF (ModelNet CAD files): counts glued to the magic
    (``OFF490 430 980``), vertex colours (COFF) and per-face trailing
    colours (scattered onto the face's vertices); faces fan-triangulated.
    Parsed in Python; ``plain`` reaches the vertex normals."""
    with open(path, errors="replace") as f:
        lines: list[list[str]] = []
        magic = None
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if magic is None:
                for m in ("COFF", "OFF"):
                    if line.upper().startswith(m):
                        magic = m
                        line = line[len(m):].strip()  # the glued-counts quirk
                        break
                else:
                    raise ValueError(f"not an OFF file: {path}")
                if not line:
                    continue
            lines.append(line.split())
    if magic is None or not lines:
        raise ValueError(f"truncated OFF file: {path}")
    nv, nf = int(lines[0][0]), int(lines[0][1])
    if len(lines) < 1 + nv + nf:
        raise ValueError(f"truncated OFF file: {path} ({len(lines) - 1} rows, need {nv + nf})")
    vdata = np.asarray(lines[1:1 + nv], np.float64)
    vertices = vdata[:, :3].astype(np.float32)
    colors = None
    if magic == "COFF" and vdata.shape[1] >= 6:
        colors = vdata[:, 3:6].astype(np.float32)
        if colors.max() > 1.5:
            colors = colors / 255.0
    tris: list[tuple[int, int, int]] = []
    face_color: np.ndarray | None = None
    for row in lines[1 + nv:1 + nv + nf]:
        cnt = int(row[0])
        idx = [int(t) for t in row[1:1 + cnt]]
        trailing = row[1 + cnt:]
        if len(trailing) >= 3 and colors is None:
            fc = np.asarray(trailing[:3], np.float32)
            if fc.max() > 1.5:
                fc = fc / 255.0
            if face_color is None:
                face_color = np.full((nv, 3), 0.7, np.float32)
            face_color[idx] = fc
        for k in range(1, cnt - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
    faces = np.asarray(tris, np.int32).reshape(-1, 3)
    return make_mesh(vertices, faces, colors if colors is not None else face_color,
                     plain=plain)


def normalize_mesh(mesh: Mesh, diameter: float = 0.15) -> Mesh:
    """Centred on its bounding box and scaled to ``diameter`` metres (CAD
    files are unitless and placed anywhere)."""
    v = mesh.vertices
    v = v - (v.max(0) + v.min(0)) / 2.0
    scale = diameter / max(mesh.diameter, 1e-12)
    return Mesh((v * scale).astype(np.float32), mesh.faces, mesh.colors, mesh.normals,
                uv=mesh.uv, texture=mesh.texture)


def load_mesh(path: str, plain: bool = False) -> Mesh:
    """The loader of ``path``'s suffix: .ply, .obj (+ MTL) or .off, given
    ``plain``."""
    ext = os.path.splitext(path)[1].lower()
    loader = {".ply": load_ply, ".obj": load_obj, ".off": load_off}.get(ext)
    if loader is None:
        raise ValueError(f"unsupported mesh format {ext!r}: {path}")
    return loader(path, plain=plain)
