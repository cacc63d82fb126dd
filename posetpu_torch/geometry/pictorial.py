"""Recursive Pictorial Structure Model (RPSM): 3D pose refinement.

The reference (lib/multiviews/pictorial.py:19-250) samples heatmaps with
scipy interpolators in a triple host loop, loads its limb-length tables from
scipy.sparse pickles and runs max-product inference per group. Here every
step is batched tensor work over a chunk of groups:

* the unary term projects every grid bin into every view and samples the
  heatmaps bilinearly, one gather for all views and joints;
* the pairwise limb-length indicator is a dense [nbins, nbins] distance test
  built from each group's own grid;
* max-product inference runs the static 16-node tree (leaves to root with
  per-edge argmax tables, then backtracking), each edge one batched op;
* the recursive refinement (per-joint 2^3 local grids) is a Python loop of
  a static depth.

:func:`rpsm` takes as many groups a chunk as a fifth of the device's free
memory holds: the first level's 15 tables are 15 x nbins^6 float32 a group
(1.0 GB at 16 bins).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from posetpu_torch.geometry.body import CHILDREN, ROOT_IDX, edges, nodes_by_level_desc
from posetpu_torch.geometry.cameras import CameraParams, project_pose
from posetpu_torch.ops.affine import affine_transform_points, get_affine_transform

EDGES = edges()
ORDER = nodes_by_level_desc()


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32, rounded as XLA's CPU
    build computes it: the step is ``i * (1 / (num - 1))`` and the sum
    ``start * (1 - step) + i * (stop / (num - 1))`` is contracted into one
    fused multiply-add, on ``start`` where ``i`` is 1 and the loop is
    unrolled (``num`` <= 34), on ``i`` elsewhere. ``torch.linspace`` rounds
    otherwise: one ulp moves a limb-length table entry."""
    f32, f64 = np.float32, np.float64
    s, e = f32(start), f32(stop)
    if num == 1:
        return np.array([s], f32)
    r = f32(1) / f32(num - 1)
    er = f32(e * r)
    out = np.empty(num, f32)
    for i in range(num - 1):
        one_m = f32(f32(1) - f32(f32(i) * r))
        if i == 1 and num <= 34:
            out[i] = f32(f64(s) * f64(one_m) + f64(er))
        else:
            out[i] = f32(f64(i) * f64(er) + f64(f32(s * one_m)))
    out[num - 1] = e
    return out


def compute_grid(box_size, box_center, n_bins: int):
    """Cubic grid of n_bins^3 points around box_center [..., 3], flattened
    in the reference's meshgrid-xy order (pictorial.py:108-119). Returns
    [..., n_bins^3, 3]."""
    box_size = float(box_size)
    g1d = torch.from_numpy(_linspace(-box_size / 2.0, box_size / 2.0, n_bins)).to(
        box_center.device)
    gx, gy, gz = (g1d + box_center[..., i, None] for i in range(3))  # [..., n]
    n = n_bins
    shape = gx.shape[:-1] + (n, n, n)
    # meshgrid(x, y, z, indexing="xy"): gx[i, j, k] = x[j], gy = y[i], gz = z[k]
    grid = torch.stack([gx[..., None, :, None].expand(shape),
                        gy[..., :, None, None].expand(shape),
                        gz[..., None, None, :].expand(shape)], dim=-1)
    return grid.reshape(shape[:-3] + (n ** 3, 3))


def pairwise_constraints(grid_parent, grid_child, limb_length, tolerance):
    """Limb-length indicator [..., nb_parent, nb_child]
    (compute_pairwise_constrain, pictorial.py:122-143): 1 where the two
    bins lie within ``tolerance`` of ``limb_length`` apart."""
    diff = grid_parent[..., :, None, :] - grid_child[..., None, :, :]
    d = (diff * diff).sum(-1).sqrt()
    return ((d - limb_length).abs() <= tolerance).float()


def _sample_heatmap_bilinear(hmap, xy, h: int, w: int):
    """RegularGridInterpolator-equivalent bilinear sample, zero outside the
    [0, w-1] x [0, h-1] domain (pictorial.py:178-187). hmap [..., h, w];
    xy [..., N, 2] (x, y) heatmap coords with the same leading dims."""
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    flat = hmap.reshape(hmap.shape[:-2] + (h * w,))
    at = lambda yi, xi: torch.gather(flat, -1, yi * w + xi)
    val = ((at(y0i, x0i) * (1 - fx) + at(y0i, x1i) * fx) * (1 - fy)
           + (at(y1i, x0i) * (1 - fx) + at(y1i, x1i) * fx) * fy)
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return val * inside.to(val.dtype)


def compute_unary(heatmaps, grids, cams: CameraParams, centers, scales,
                  image_size, heatmap_size):
    """Sum over views of bilinear heatmap samples at the projected grid
    points (compute_unary_term, pictorial.py:146-190), in H36M's projection
    (:func:`~posetpu_torch.geometry.cameras.project_pose`).

    heatmaps [..., V, J, h, w]; grids [..., J, nbins, 3] (or [..., 1, nbins,
    3], one grid for all joints); cams leading [..., V]; centers, scales
    [..., V, 2]. Returns [..., J, nbins]."""
    j, h, w = heatmaps.shape[-3:]
    jg, nbins = grids.shape[-3], grids.shape[-2]
    scale_hm = torch.tensor([w / float(image_size[0]), h / float(image_size[1])],
                            device=heatmaps.device)
    pts = grids.reshape(grids.shape[:-3] + (1, jg * nbins, 3))
    xy = project_pose(pts, cams)  # [..., V, jg * nbins, 2] image pixels
    trans = get_affine_transform(centers, scales, 0.0, image_size)
    xy = affine_transform_points(xy, trans) * scale_hm  # heatmap coords
    xy = xy.reshape(xy.shape[:-2] + (jg, nbins, 2)).expand(xy.shape[:-2] + (j, nbins, 2))
    return _sample_heatmap_bilinear(heatmaps, xy, h, w).sum(dim=-3)


def infer_max_product(unary, pairwise_list):
    """Max-product inference over the 16-joint tree (infer,
    pictorial.py:19-86).

    unary [..., J, nbins]; pairwise_list: {edge_index: [..., nb_parent,
    nb_child]} (or a list) aligned with EDGES. Returns [..., J] selected bin
    indices; a tie picks the first bin, as ``jnp.argmax``."""
    j = unary.shape[-2]
    energy = {i: unary[..., i, :] for i in range(j)}
    argmax_tables = {}
    for node in ORDER:
        for child in CHILDREN[node]:
            pw = pairwise_list[EDGES.index((node, child))]
            best, arg = (pw * energy[child][..., None, :]).max(dim=-1)
            argmax_tables[(node, child)] = arg
            energy[node] = energy[node] * best

    selected = [None] * j
    selected[ROOT_IDX] = energy[ROOT_IDX].argmax(dim=-1)
    queue = [ROOT_IDX]  # breadth-first backtrack over the static tree
    while queue:
        node = queue.pop(0)
        for child in CHILDREN[node]:
            selected[child] = argmax_tables[(node, child)].gather(
                -1, selected[node][..., None])[..., 0]
            queue.append(child)
    return torch.stack(selected, dim=-1)


def _rpsm_groups(heatmaps, cams: CameraParams, centers, scales, grid_centers,
                 limb_lengths, image_size, heatmap_size, first_nbins: int,
                 recur_nbins: int, recur_depth: int, grid_size: float,
                 tolerance: float, pairwise0=None):
    """RPSM on a batch of C groups at once: heatmaps [C, V, J, h, w], cams
    leading [C, V], centers / scales [C, V, 2], grid_centers [C, 3] ->
    [C, J, 3]. Each group's tables come from its own grid."""
    c, j = heatmaps.shape[0], heatmaps.shape[2]
    limbs = torch.as_tensor(limb_lengths, dtype=torch.float32, device=heatmaps.device)
    unary_of = lambda grids: compute_unary(heatmaps, grids, cams, centers, scales,
                                           image_size, heatmap_size)

    # iteration 1: one global grid for all joints
    grid = compute_grid(grid_size, grid_centers, first_nbins)  # [C, nb, 3]
    unary = unary_of(grid[:, None])
    if pairwise0 is None:
        pairwise0 = [pairwise_constraints(grid, grid, limbs[e], tolerance)
                     for e in range(len(EDGES))]
    bins = infer_max_product(unary, pairwise0)  # [C, J]
    pose = grid.gather(1, bins[..., None].expand(c, j, 3))
    del pairwise0, unary

    # recursive refinement on per-joint local grids
    cur_size = grid_size / first_nbins
    for _ in range(recur_depth):
        grids = compute_grid(cur_size, pose, recur_nbins)  # [C, J, nb, 3]
        pairwise = [pairwise_constraints(grids[:, p], grids[:, ch], limbs[e], tolerance)
                    for e, (p, ch) in enumerate(EDGES)]
        bins = infer_max_product(unary_of(grids), pairwise)
        pose = grids.gather(2, bins[..., None, None].expand(c, j, 1, 3))[:, :, 0]
        cur_size = cur_size / recur_nbins
    return pose


def rpsm_one_group(heatmaps, cams: CameraParams, centers, scales, grid_center,
                   limb_lengths, image_size, heatmap_size, first_nbins: int = 16,
                   recur_nbins: int = 2, recur_depth: int = 10,
                   grid_size: float = 2000.0, tolerance: float = 150.0,
                   pairwise0=None):
    """Full RPSM for one 4-view group (rpsm, pictorial.py:214-250).

    heatmaps [V, J, h, w]; cams leading [V]; centers / scales [V, 2];
    grid_center [3]; limb_lengths [n_edges] in EDGES order. Returns [J, 3]
    world pose (mm). ``pairwise0`` injects the reference's precomputed
    first-level tables ({edge_idx: [nb, nb]})."""
    return _rpsm_groups(heatmaps[None], cams.map(lambda x: x[None]), centers[None],
                        scales[None], grid_center[None], limb_lengths, image_size,
                        heatmap_size, first_nbins, recur_nbins, recur_depth,
                        grid_size, tolerance, pairwise0)[0]


def _groups_per_chunk(device: torch.device, first_nbins: int, per_group_extra: int) -> int:
    """Groups whose first-level work fits in a fifth of the free memory:
    the 15 tables, the distance tensor that builds one and the product
    that scores one (~20 tables of nbins^6 float32 a group)."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    per_group = 20 * 4 * first_nbins ** 6 + per_group_extra
    return max(1, int(free // 5 // per_group))


def rpsm(heatmaps, cams, centers, scales, grid_centers, limb_lengths, cfg,
         pairwise0=None):
    """Batched RPSM over groups, in chunks of as many groups as the
    device's free memory holds (:func:`_groups_per_chunk`).

    heatmaps [G, V, J, h, w]; cams leading [G, V]; centers / scales
    [G, V, 2]; grid_centers [G, 3]; limb_lengths [n_edges]. Returns
    [G, J, 3]."""
    ps = cfg.PICT_STRUCT
    kw = dict(image_size=(int(cfg.NETWORK.IMAGE_SIZE[0]), int(cfg.NETWORK.IMAGE_SIZE[1])),
              heatmap_size=(int(cfg.NETWORK.HEATMAP_SIZE[0]), int(cfg.NETWORK.HEATMAP_SIZE[1])),
              first_nbins=int(ps.FIRST_NBINS), recur_nbins=int(ps.RECUR_NBINS),
              recur_depth=int(ps.RECUR_DEPTH), grid_size=float(ps.GRID_SIZE),
              tolerance=float(ps.LIMB_LENGTH_TOLERANCE), pairwise0=pairwise0)
    g = heatmaps.shape[0]
    chunk = _groups_per_chunk(heatmaps.device, kw["first_nbins"],
                              heatmaps[0].numel() * heatmaps.element_size())
    return torch.cat([
        _rpsm_groups(heatmaps[s:s + chunk], cams.map(lambda x: x[s:s + chunk]),
                     centers[s:s + chunk], scales[s:s + chunk],
                     grid_centers[s:s + chunk], limb_lengths, **kw)
        for s in range(0, g, chunk)])


def limb_lengths_from_pose(pose3d):
    """Template limb lengths [..., n_edges] in EDGES order from a 3D pose
    [..., J, 3]: the in-framework analogue of the reference's
    run/test/generate_pairwise_constraints.py limb-length stage."""
    e = torch.tensor(EDGES, device=pose3d.device)
    return torch.linalg.vector_norm(pose3d[..., e[:, 0], :] - pose3d[..., e[:, 1], :], dim=-1)
