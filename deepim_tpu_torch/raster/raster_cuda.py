"""Tiled, sort-binned rasterizer with hand-written CUDA kernels.

Port of ``deepim_tpu/raster/raster_pallas.py``: the plane packing
(``_plane_pack``, ``pack_corner_major``, ``pack_tri_params``), the sort
binning (``bin_faces_sorted``, ``bin_faces_packed``), the launchers
(``_render_from_params_cols`` with its overflow fallback,
``_render_from_params_sorted``, ``_render_chunk``, ``_render_dispatch``)
and ``render_batch_tri``.

The two TPU kernels ``_raster_kernel_cols`` and ``_raster_kernel_sorted``
become the CUDA kernels in ``csrc/raster_cols.cu`` and
``csrc/raster_sorted.cu``.  Each has a wrapper here (:func:`raster_cols`,
:func:`raster_sorted`) and a plain PyTorch version beside it
(:func:`raster_cols_ref`, :func:`raster_sorted_ref`) that takes the same
binned inputs and gives the same outputs.  Dispatch rule, with no
fallback: a CUDA tensor goes to the kernel (a build or launch failure
raises), a CPU tensor goes to the plain version.

What every kernel computes: for each pixel centre (x+0.5, y+0.5) and each
face of the pixel's list, in list order, the face covers the pixel when
its three barycentric planes are all >= 0; it wins when its inverse-depth
plane is strictly greater than the z-buffer (which starts at 0 =
background) and the winner's three colour-numerator planes are kept.  One
divide per pixel at the end gives metric depth (0 = background) and rgb.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepim_tpu_torch.raster.raster_ref import FLAT_LIGHTING, Lighting, light_direction

#: Launches of each hand-written kernel, and renders that took the cols
#: path's lossless sorted fallback.  Only the wrappers and the cols
#: launcher add to these; a caller resets them to count one run.
LAUNCHES = {"raster_cols": 0, "raster_sorted": 0, "cols_fallback": 0}

# The cols kernel's sub-tile and the sorted kernel's tile (both fixed in
# the CUDA sources).
COLS_TILE = (8, 128)
SORT_TILE = (32, 256)
# Above this face count the reference renders in face chunks and z-merges
# them; the port has not ported that path yet (ROADMAP queue B).
_FACE_CHUNK = 12288
# "auto" binning crossover of the sparse full-frame regime, and the
# crop-regime crossover that render_crops dispatches on (both chosen on
# the reference's hardware; the port keeps them so routes match).
_COLS_MIN_FACES = 4096
_COLS_MIN_FACES_CROP = 1024
# Cap of the cols kernel's per-column global list; a batch with more big
# faces in any sample renders through the sorted fallback.
_COLS_GLOBAL_CAP = 120


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------------
# Plane packing
# --------------------------------------------------------------------------


def _plane_pack(xy, z, col, face_ok, cull_dir=None):
    """Per-corner component tensors -> (params (B, F, 24), bbox (B, F, 4), ok).

    ``xy`` = ((x0, y0), (x1, y1), (x2, y2)), ``z`` = (z0, z1, z2),
    ``col`` = ((r0, g0, b0), ...): all (B, F).  ``cull_dir`` (B, 1) or None.

    params layout: [A0 B0 C0 | A1 B1 C1 | A2 B2 C2 | az bz cz |
                    ar br cr | ag bg cg | ab bb cb | 0 0 0]
    λ_i = A_i x + B_i y + C_i are barycentrics (either winding).  Culled and
    degenerate faces pack zeros, so they never win a pixel.
    """
    (x0, y0), (x1, y1), (x2, y2) = xy
    z0, z1, z2 = z
    d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)  # 2*signed area
    face_ok = face_ok & (d.abs() > 1e-12)
    if cull_dir is not None:
        face_ok = face_ok & ((cull_dir == 0.0) | (d * cull_dir < 0.0))
    inv_d = torch.where(d.abs() > 1e-12, 1.0 / d, 0.0)

    a0 = (y1 - y2) * inv_d
    b0 = (x2 - x1) * inv_d
    c0 = -a0 * x2 - b0 * y2
    a1 = (y2 - y0) * inv_d
    b1 = (x0 - x2) * inv_d
    c1 = -a1 * x0 - b1 * y0
    a2 = (y0 - y1) * inv_d
    b2 = (x1 - x0) * inv_d
    c2 = -a2 * x1 - b2 * y1

    iz0 = 1.0 / z0.clamp_min(1e-8)
    iz1 = 1.0 / z1.clamp_min(1e-8)
    iz2 = 1.0 / z2.clamp_min(1e-8)
    az = a0 * iz0 + a1 * iz1 + a2 * iz2
    bz = b0 * iz0 + b1 * iz1 + b2 * iz2
    cz = c0 * iz0 + c1 * iz1 + c2 * iz2

    rows = [a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz]
    for ch in range(3):
        v0 = col[0][ch] * iz0
        v1 = col[1][ch] * iz1
        v2 = col[2][ch] * iz2
        rows.append(a0 * v0 + a1 * v1 + a2 * v2)
        rows.append(b0 * v0 + b1 * v1 + b2 * v2)
        rows.append(c0 * v0 + c1 * v1 + c2 * v2)
    okf = face_ok.to(x0.dtype)
    zero = torch.zeros_like(x0)
    params = torch.stack([r * okf for r in rows] + [zero, zero, zero], dim=-1)
    bbox = torch.stack(
        [
            torch.minimum(torch.minimum(x0, x1), x2),
            torch.maximum(torch.maximum(x0, x1), x2),
            torch.minimum(torch.minimum(y0, y1), y2),
            torch.maximum(torch.maximum(y0, y1), y2),
        ],
        dim=-1,
    )
    return params, bbox, face_ok


def pack_corner_major(tri_pos, tri_nrm, pose, k, lighting: Lighting,
                      z_near: float, channels_fn: Callable, cull_dir=None):
    """Corner-major projection + two-sided Gouraud lighting, batched.

    ``tri_pos``/``tri_nrm`` are (B, 9, F), row 3*corner+coord; ``pose``
    (B, 3, 4); ``k`` (B, 3, 3); ``cull_dir`` (B,) or None.
    ``channels_fn(corner, intensity) -> (c0, c1, c2)`` supplies the three
    interpolated channels per corner.
    """
    r, t = pose[:, :, :3], pose[:, :, 3]
    l = light_direction(lighting, tri_pos)

    def rc(i, j):
        return r[:, i, j, None]

    xy, zs, col = [], [], []
    ok = None
    for c in range(3):
        px, py, pz = tri_pos[:, 3 * c], tri_pos[:, 3 * c + 1], tri_pos[:, 3 * c + 2]
        cx = rc(0, 0) * px + rc(0, 1) * py + rc(0, 2) * pz + t[:, 0, None]
        cy = rc(1, 0) * px + rc(1, 1) * py + rc(1, 2) * pz + t[:, 1, None]
        cz = rc(2, 0) * px + rc(2, 1) * py + rc(2, 2) * pz + t[:, 2, None]
        z_safe = torch.where(cz.abs() < 1e-8, 1e-8, cz)
        u = k[:, 0, 0, None] * cx / z_safe + k[:, 0, 2, None]
        v = k[:, 1, 1, None] * cy / z_safe + k[:, 1, 2, None]
        xy.append((u, v))
        zs.append(cz)
        ok = (cz > z_near) if ok is None else ok & (cz > z_near)

        nx, ny, nz = tri_nrm[:, 3 * c], tri_nrm[:, 3 * c + 1], tri_nrm[:, 3 * c + 2]
        ncx = rc(0, 0) * nx + rc(0, 1) * ny + rc(0, 2) * nz
        ncy = rc(1, 0) * nx + rc(1, 1) * ny + rc(1, 2) * nz
        ncz = rc(2, 0) * nx + rc(2, 1) * ny + rc(2, 2) * nz
        ndotl = ncx * l[0] + ncy * l[1] + ncz * l[2]
        intensity = lighting.ambient + lighting.diffuse * ndotl.abs()
        col.append(channels_fn(c, intensity))
    cd = None if cull_dir is None else cull_dir[:, None]
    return _plane_pack(tuple(xy), tuple(zs), tuple(col), ok, cd)


def pack_tri_params(tri_pos, tri_col, tri_nrm, pose, k, lighting: Lighting,
                    z_near: float, cull_dir=None):
    """Corner-major pack with baked per-corner shaded colors (B, 9, F) inputs."""
    return pack_corner_major(
        tri_pos, tri_nrm, pose, k, lighting, z_near,
        lambda c, intensity: tuple(
            torch.clamp(tri_col[:, 3 * c + ch] * intensity, 0.0, 1.0)
            for ch in range(3)
        ),
        cull_dir,
    )


# --------------------------------------------------------------------------
# Binning (batched over the leading sample axis; torch ops)
# --------------------------------------------------------------------------


def _tile_span(bbox, face_ok, image_size, tile, sy_span, sx_span):
    """Per-face tile ranges and the small/on-screen predicates, (B, F)."""
    h, w = image_size
    th, tw = tile
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    umin, umax, vmin, vmax = bbox.unbind(-1)
    tx0 = torch.floor(umin / tw).clamp(0, tx - 1).to(torch.int32)
    tx1 = torch.floor(umax / tw).clamp(0, tx - 1).to(torch.int32)
    ty0 = torch.floor(vmin / th).clamp(0, ty - 1).to(torch.int32)
    ty1 = torch.floor(vmax / th).clamp(0, ty - 1).to(torch.int32)
    onscreen = face_ok & (umax >= 0) & (umin <= w) & (vmax >= 0) & (vmin <= h)
    small = onscreen & (tx1 - tx0 < sx_span) & (ty1 - ty0 < sy_span)
    return tx0, tx1, ty0, ty1, onscreen, small


def _span_cells(tx0, tx1, ty0, ty1, small, sy_span, sx_span):
    """(B, F, S) tile coordinates of each face's span cells + validity."""
    s = torch.arange(sy_span * sx_span, dtype=torch.int32, device=tx0.device)
    tyc = ty0[..., None] + s // sx_span
    txc = tx0[..., None] + s % sx_span
    valid = small[..., None] & (tyc <= ty1[..., None]) & (txc <= tx1[..., None])
    return tyc, txc, valid


def _searchsorted(sorted_keys, bounds):
    """Left-sided batched searchsorted of int32 ``bounds`` (N,) -> (B, N) int32."""
    b = sorted_keys.shape[0]
    return torch.searchsorted(
        sorted_keys, bounds.expand(b, -1).contiguous(), right=False
    ).to(torch.int32)


def bin_faces_sorted(bbox, face_ok, image_size, sy_span: int = 4,
                     sx_span: int = 2, global_cap: int = 128):
    """Sort binning of (tile, face) pairs for the sorted kernel.

    Every face registers with the <= sy_span x sx_span row-major tiles its
    bbox covers, or, if its bbox is larger, goes on a global list every
    tile processes (capped at ``global_cap``; the reference drops the rest,
    and so does the port so that both compare like with like).

    Returns (vals (B, F*S) int32 face ids sorted by tile, starts (B, T+1)
    int32, glob (B, 1 + min(F, global_cap)) int32 ``[count, ids...]``).
    """
    b, f = face_ok.shape
    h, w = image_size
    th, tw = SORT_TILE
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    t_total = ty * tx
    s = sy_span * sx_span
    dev = bbox.device
    tx0, tx1, ty0, ty1, onscreen, small = _tile_span(
        bbox, face_ok, image_size, SORT_TILE, sy_span, sx_span)
    tyc, txc, valid = _span_cells(tx0, tx1, ty0, ty1, small, sy_span, sx_span)
    keys = torch.where(valid, tyc * tx + txc, t_total).reshape(b, f * s)
    # Stable sort: within a tile, faces keep ascending id order.
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    vals = (order // s).to(torch.int32)
    starts = _searchsorted(
        keys_s, torch.arange(t_total + 1, dtype=torch.int32, device=dev))

    big = onscreen & ~small
    ids = torch.arange(f, dtype=torch.int32, device=dev).expand(b, f)
    gsort = torch.sort(torch.where(big, ids, f), dim=1).values[:, :global_cap]
    gcount = big.sum(1, dtype=torch.int32).clamp_max(global_cap)
    glob = torch.cat([gcount[:, None], torch.where(gsort < f, gsort, 0)], dim=1)
    return vals, starts, glob


def bin_faces_packed(bbox, face_ok, image_size, sy_span: int = 6,
                     sx_span: int = 2, global_cap: int = _COLS_GLOBAL_CAP):
    """Column-major packed-key binning for the cols kernel.

    Tile ids are column-major (``t = tx * TY + ty``) and one packed int32
    key ``(tile << shift) | slot`` is sorted per sample (slot = face*S+k).
    Big faces go on a per-column global list.

    Returns ``(face_ids (B, F*S) int32, starts (B, T+1) int32, glob_col)``
    with ``glob_col`` (B, TX+1 + G*TX + 8 + 1) int32 laid out as
    ``[gstarts (TX+1) | ids (G*TX) | 8 zeros | uncapped global count]``
    (the reference's layout; the last element tells the launcher whether
    the capped list overflowed).
    """
    b, f = face_ok.shape
    h, w = image_size
    th, tw = COLS_TILE
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    t_total = ty * tx
    s = sy_span * sx_span
    n = f * s
    shift = max(int(n - 1).bit_length(), 1)
    if (t_total << shift) >= 2**31:
        raise ValueError("packed key overflows int32")
    dev = bbox.device
    i32 = torch.int32
    tx0, tx1, ty0, ty1, onscreen, small = _tile_span(
        bbox, face_ok, image_size, COLS_TILE, sy_span, sx_span)
    tyc, txc, valid = _span_cells(tx0, tx1, ty0, ty1, small, sy_span, sx_span)
    tid = torch.where(valid, txc * ty + tyc, t_total)  # COLUMN-major
    slot = torch.arange(n, dtype=i32, device=dev).reshape(1, f, s)
    packed = torch.sort(((tid << shift) | slot).reshape(b, n), dim=1).values
    starts = _searchsorted(
        packed, torch.arange(t_total + 1, dtype=i32, device=dev) << shift)
    face_ids = ((packed & ((1 << shift) - 1)) // s).to(i32)

    # Global (big-bbox) faces, grouped per 128-px column.
    big = onscreen & ~small
    ids = torch.arange(f, dtype=i32, device=dev).expand(b, f)
    gkey = torch.cat(
        [torch.where(big, ids, f), torch.full((b, global_cap), f, dtype=i32, device=dev)],
        dim=1,
    )
    gsort = torch.sort(gkey, dim=1).values[:, :global_cap]
    gvalid = gsort < f
    gids = torch.where(gvalid, gsort, 0)
    gtx0 = torch.where(gvalid, torch.gather(tx0, 1, gids.long()), tx)
    gtx1 = torch.where(gvalid, torch.gather(tx1, 1, gids.long()), -1)
    n2 = global_cap * tx
    shift2 = max(int(n2 - 1).bit_length(), 1)
    cols = torch.arange(tx, dtype=i32, device=dev).reshape(1, 1, tx)
    hit = (gtx0[..., None] <= cols) & (cols <= gtx1[..., None])
    slot2 = torch.arange(n2, dtype=i32, device=dev).reshape(1, global_cap, tx)
    key2 = torch.where(hit, (cols << shift2) | slot2, (tx << shift2) | slot2)
    key2 = torch.sort(key2.reshape(b, n2), dim=1).values
    gstarts = _searchsorted(
        key2, torch.arange(tx + 1, dtype=i32, device=dev) << shift2)
    gid_sorted = torch.gather(gids, 1, ((key2 & ((1 << shift2) - 1)) // tx).long())
    gtotal = big.sum(1, dtype=i32)
    glob_col = torch.cat(
        [gstarts, gid_sorted, torch.zeros((b, 8), dtype=i32, device=dev),
         gtotal[:, None]],
        dim=1,
    )
    return face_ids, starts, glob_col


# --------------------------------------------------------------------------
# Plain PyTorch versions of the two kernels
# --------------------------------------------------------------------------


def _range_lists(ids, lo, hi):
    """Gather ``ids[b, lo[b, t]:hi[b, t]]`` into padded (B, T, L) lists + mask."""
    b, t = lo.shape
    lengths = (hi - lo).clamp_min(0)
    width = int(lengths.max()) if lengths.numel() else 0
    ar = torch.arange(width, device=ids.device)
    valid = ar < lengths[..., None]
    if ids.shape[1] == 0:
        return torch.zeros((b, t, width), dtype=torch.int32, device=ids.device), valid
    idx = (lo[..., None].long() + ar).clamp(0, ids.shape[1] - 1)
    lists = torch.gather(ids, 1, idx.reshape(b, -1)).reshape(b, t, width)
    return lists, valid


def _resolve_ref(params, lists, valid, oy, ox, tile, chunk_elems=1 << 24):
    """Depth-resolve padded per-tile face lists -> (z, r, g, b), each (B, T, P).

    ``oy``/``ox`` (T,) are the tiles' pixel origins, P = th*tw pixels per
    tile.  The winner at a pixel is the FIRST face in list order with the
    largest positive inverse-depth score — exactly the sequential strict-
    ``>`` z-test (``torch.max`` returns the first maximum).  Chunked over
    tiles to bound memory.
    """
    b, t, width = lists.shape
    th, tw = tile
    dev = params.device
    pix = torch.arange(th * tw, device=dev)
    out = torch.zeros((4, b * t, th * tw), dtype=torch.float32, device=dev)
    if width == 0 or b * t == 0:
        return out.reshape(4, b, t, th * tw).unbind(0)
    flat = lists.reshape(b * t, width).long()
    fvalid = valid.reshape(b * t, width)
    bidx = torch.arange(b, device=dev).repeat_interleave(t)
    tidx = torch.arange(t, device=dev).repeat(b)
    step = max(1, chunk_elems // (width * th * tw))
    for c0 in range(0, b * t, step):
        sl = slice(c0, c0 + step)
        p = params[bidx[sl, None], flat[sl]]  # (n, L, 24)
        px = ((ox[tidx[sl], None] + pix % tw).float() + 0.5)[:, None, :]  # (n, 1, P)
        py = ((oy[tidx[sl], None] + pix // tw).float() + 0.5)[:, None, :]

        def plane(q, i):
            return q[..., i, None] * px + q[..., i + 1, None] * py + q[..., i + 2, None]

        l0, l1, l2, iz = plane(p, 0), plane(p, 3), plane(p, 6), plane(p, 9)
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & fvalid[sl, :, None]
        z, win = torch.where(inside, iz, 0.0).max(dim=1)  # first maximum
        hit = z > 0
        pw = torch.gather(p, 1, win[..., None].expand(-1, -1, 24))  # (n, P, 24)
        pxw, pyw = px[:, 0], py[:, 0]

        def wplane(i):
            return pw[..., i] * pxw + pw[..., i + 1] * pyw + pw[..., i + 2]

        acc = torch.stack([z, wplane(12), wplane(15), wplane(18)])
        out[:, sl] = torch.where(hit, acc, 0.0)
    return out.reshape(4, b, t, th * tw).unbind(0)


def _finish(z, r, g, bl):
    """One divide per pixel: (inverse-depth, colour numerators) -> (rgb, depth)."""
    inv = 1.0 / z.clamp_min(1e-9)
    depth = torch.where(z > 0, inv, 0.0)
    return torch.stack([r * inv, g * inv, bl * inv], dim=1), depth


def raster_cols_ref(params, face_ids, starts, glob_col, h: int, w: int):
    """Plain PyTorch version of the cols kernel (same inputs and outputs).

    Pixel (y, x) belongs to sub-tile ``t = (x // 128) * TY + y // 8``; its
    face list is ``face_ids[starts[t]:starts[t+1]]`` followed by its
    column's global range of ``glob_col``.  -> (rgb (B,3,H,W), depth (B,H,W)).
    """
    b = params.shape[0]
    sub_h, col_w = COLS_TILE
    n_subs, n_cols = _cdiv(h, sub_h), _cdiv(w, col_w)
    dev = params.device
    lists1, valid1 = _range_lists(face_ids, starts[:, :-1], starts[:, 1:])
    g_ids = glob_col[:, n_cols + 1:]
    lists2, valid2 = _range_lists(g_ids, glob_col[:, :n_cols], glob_col[:, 1:n_cols + 1])
    col_of = torch.arange(n_cols, device=dev).repeat_interleave(n_subs)
    lists = torch.cat([lists1, lists2[:, col_of]], dim=2)
    valid = torch.cat([valid1, valid2[:, col_of]], dim=2)
    t = torch.arange(n_subs * n_cols, device=dev)
    acc = _resolve_ref(params, lists, valid, (t % n_subs) * sub_h,
                       (t // n_subs) * col_w, COLS_TILE)
    img = [a.reshape(b, n_cols, n_subs, sub_h, col_w).permute(0, 2, 3, 1, 4)
           .reshape(b, n_subs * sub_h, n_cols * col_w)[:, :h, :w] for a in acc]
    return _finish(*img)


def raster_sorted_ref(params, vals, starts, glob, h: int, w: int):
    """Plain PyTorch version of the sorted kernel (same inputs and outputs).

    Pixel (y, x) belongs to row-major tile ``t = (y // 32) * TX + x // 256``;
    its face list is ``vals[starts[t]:starts[t+1]]`` followed by the global
    list ``glob[1:1+glob[0]]``.  -> (rgb (B,3,H,W), depth (B,H,W)).
    """
    b = params.shape[0]
    th, tw = SORT_TILE
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    dev = params.device
    lists1, valid1 = _range_lists(vals, starts[:, :-1], starts[:, 1:])
    g = glob.shape[1] - 1
    lists2 = glob[:, None, 1:].expand(b, ty * tx, g)
    valid2 = (torch.arange(g, device=dev) < glob[:, :1])[:, None, :].expand(b, ty * tx, g)
    lists = torch.cat([lists1, lists2], dim=2)
    valid = torch.cat([valid1, valid2], dim=2)
    t = torch.arange(ty * tx, device=dev)
    acc = _resolve_ref(params, lists, valid, (t // tx) * th, (t % tx) * tw, SORT_TILE)
    img = [a.reshape(b, ty, tx, th, tw).permute(0, 1, 3, 2, 4)
           .reshape(b, ty * th, tx * tw)[:, :h, :w] for a in acc]
    return _finish(*img)


# --------------------------------------------------------------------------
# Kernel wrappers: CUDA tensor -> kernel, CPU tensor -> plain version
# --------------------------------------------------------------------------


def _check_inputs(params, ids, starts, glob, n_tiles: int, min_glob: int):
    dev = params.device
    for name, x, dt in (("params", params, torch.float32), ("ids", ids, torch.int32),
                        ("starts", starts, torch.int32), ("glob", glob, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, params on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dim() != (3 if name == "params" else 2) or x.shape[0] != params.shape[0]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}")
    if params.shape[2] != 24 or params.data_ptr() % 16:
        raise ValueError("params must be (B, F, 24) and 16-byte aligned")
    if starts.shape[1] != n_tiles + 1 or glob.shape[1] < min_glob:
        raise ValueError(f"starts {tuple(starts.shape)} / glob {tuple(glob.shape)} "
                         f"do not fit {n_tiles} tiles")
    if not 0 < params.shape[0] <= 65535:
        raise ValueError("batch must be in 1..65535 (grid y dimension)")


def _launch(entry: str, params, ids, starts, glob, h: int, w: int):
    from deepim_tpu_torch.raster import _build

    b, f = params.shape[0], params.shape[1]
    rgb = torch.empty((b, 3, h, w), dtype=torch.float32, device=params.device)
    depth = torch.empty((b, h, w), dtype=torch.float32, device=params.device)
    lib = _build.load()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            params.data_ptr(), ids.data_ptr(), starts.data_ptr(), glob.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), b, f, h, w, ids.shape[1],
            glob.shape[1], stream)
    if err:
        raise RuntimeError(
            f"{entry} launch failed: {lib.deepim_error_string(err).decode()}")
    return rgb, depth


def raster_cols(params, face_ids, starts, glob_col, h: int, w: int):
    """Cols raster kernel (``csrc/raster_cols.cu``) on binned inputs.

    ``params`` (B, F, 24) f32; ``face_ids``/``starts``/``glob_col`` from
    :func:`bin_faces_packed` -> (rgb (B, 3, H, W), depth (B, H, W)).
    """
    if params.device.type == "cpu":
        return raster_cols_ref(params, face_ids, starts, glob_col, h, w)
    if not params.is_cuda:
        raise ValueError(f"no raster kernel for device {params.device}")
    n_cols = _cdiv(w, COLS_TILE[1])
    _check_inputs(params, face_ids, starts, glob_col,
                  _cdiv(h, COLS_TILE[0]) * n_cols, n_cols + 1)
    out = _launch("deepim_raster_cols", params, face_ids, starts, glob_col, h, w)
    LAUNCHES["raster_cols"] += 1
    return out


def raster_sorted(params, vals, starts, glob, h: int, w: int):
    """Sorted raster kernel (``csrc/raster_sorted.cu``) on binned inputs.

    ``params`` (B, F, 24) f32; ``vals``/``starts``/``glob`` from
    :func:`bin_faces_sorted` -> (rgb (B, 3, H, W), depth (B, H, W)).
    """
    if params.device.type == "cpu":
        return raster_sorted_ref(params, vals, starts, glob, h, w)
    if not params.is_cuda:
        raise ValueError(f"no raster kernel for device {params.device}")
    _check_inputs(params, vals, starts, glob,
                  _cdiv(h, SORT_TILE[0]) * _cdiv(w, SORT_TILE[1]), 1)
    out = _launch("deepim_raster_sorted", params, vals, starts, glob, h, w)
    LAUNCHES["raster_sorted"] += 1
    return out


# --------------------------------------------------------------------------
# Launchers
# --------------------------------------------------------------------------


def _render_from_params_sorted(params, bbox, face_ok, image_size,
                               sy_span: int = 4, sx_span: int = 2):
    """Sort-bin, then the sorted kernel -> (rgb (B,3,H,W), depth (B,H,W))."""
    vals, starts, glob = bin_faces_sorted(bbox, face_ok, image_size, sy_span, sx_span)
    return raster_sorted(params, vals, starts, glob, *image_size)


def _render_from_params_cols(params, bbox, face_ok, image_size):
    """Packed-bin, then the cols kernel, or the lossless sorted fallback.

    When any sample has more than ``_COLS_GLOBAL_CAP`` big faces, the whole batch
    renders through the sorted kernel with spans covering the full tile
    grid (every face binned exactly, nothing global, nothing dropped), as
    the reference's ``lax.cond`` does.  Here the branch is a host decision:
    one device->host read per render.
    """
    h, w = image_size
    face_ids, starts, glob = bin_faces_packed(bbox, face_ok, image_size)
    if int(glob[:, -1].max()) > _COLS_GLOBAL_CAP:
        LAUNCHES["cols_fallback"] += 1
        return _render_from_params_sorted(
            params, bbox, face_ok, image_size,
            sy_span=_cdiv(h, SORT_TILE[0]), sx_span=_cdiv(w, SORT_TILE[1]))
    return raster_cols(params, face_ids, starts, glob, h, w)


def _render_chunk(params, bbox, face_ok, image_size, binning, spans=(4, 2)):
    """One kernel route -> (rgb NCHW, depth)."""
    if binning == "auto":
        binning = "cols" if params.shape[1] >= _COLS_MIN_FACES else "sort"
    if binning == "cols":
        return _render_from_params_cols(params, bbox, face_ok, image_size)
    if binning == "sort":
        return _render_from_params_sorted(params, bbox, face_ok, image_size,
                                          sy_span=spans[0], sx_span=spans[1])
    if binning == "topk":
        raise NotImplementedError(
            "binning='topk' (the capped legacy kernel) is not ported yet "
            "(ROADMAP queue B, last)")
    raise ValueError(binning)


def _render_dispatch(params, bbox, face_ok, image_size, binning, spans=(4, 2)):
    """Pick the kernel route; returns (rgb (B, H, W, 3) view, depth (B, H, W))."""
    if params.shape[1] > _FACE_CHUNK:
        raise NotImplementedError(
            f"{params.shape[1]} faces > {_FACE_CHUNK}: face chunking with "
            "z-merge is not ported yet (ROADMAP queue B)")
    rgb, depth = _render_chunk(params, bbox, face_ok, image_size, binning, spans)
    return rgb.permute(0, 2, 3, 1), depth


@torch.no_grad()
def render_batch_tri(tri_pos, tri_col, tri_nrm, poses, ks,
                     image_size: tuple[int, int],
                     lighting: Lighting = FLAT_LIGHTING, z_near: float = 0.01,
                     binning: str = "auto", spans: tuple[int, int] = (4, 2),
                     cull_dir=None):
    """Render corner-major meshes -> (rgb (B, H, W, 3), depth (B, H, W)).

    ``tri_*`` (B, 9, F); ``poses`` (B, 3, 4); ``ks`` (B, 3, 3);
    ``cull_dir`` (B,) ±1 back-face cull sign, 0 or None = two-sided.
    ``binning``: "auto" | "cols" | "sort"; ``spans``: sort-binning (sy, sx)
    tile spans.  rgb is an NHWC view of the kernels' NCHW output.
    """
    params, bbox, face_ok = pack_tri_params(tri_pos, tri_col, tri_nrm, poses, ks,
                                            lighting, z_near, cull_dir)
    return _render_dispatch(params, bbox, face_ok, image_size, binning, spans)
