"""The port's RPSM (geometry/pictorial.py) against the JAX package on the
CPU: the grid bit for bit, the limb-length tables, the unary term, the
max-product bins with ties, and a whole small RPSM; then the port's own
refine-to-GT check."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.config import default_config
from posetpu.data import synthetic as jsyn
from posetpu.geometry import pictorial as jpic
from posetpu.geometry.cameras import project_pose as jproject_pose
from posetpu.ops.affine import affine_transform_points, get_affine_transform
from posetpu.ops.heatmap import render_gaussian_heatmaps
from posetpu_torch.config import default_config as tdefault_config
from posetpu_torch.data import synthetic as tsyn
from posetpu_torch.geometry import pictorial as tpic

IMAGE, HEATMAP = (256, 256), (64, 64)


@pytest.mark.parametrize("n_bins", [2, 8, 16])
@pytest.mark.parametrize("box_size", [2000.0, 125.0, 1000.0 / 3.0])
def test_compute_grid_bit_for_bit(n_bins, box_size):
    """Off-origin centres, one at a time as JAX takes them and batched."""
    centres = np.random.RandomState(n_bins).uniform(-900, 1500, (3, 3)).astype(np.float32)
    got = tpic.compute_grid(box_size, torch.from_numpy(centres), n_bins).numpy()
    for c, g in zip(centres, got):
        want = np.asarray(jpic.compute_grid(box_size, jnp.asarray(c), n_bins))
        assert want.dtype == g.dtype and want.shape == g.shape == (n_bins ** 3, 3)
        assert np.array_equal(g, want)


def _pose(seed=0):
    return tsyn.make_skeleton_poses(1, seed=seed)[0]


def test_pairwise_constraints_equal():
    """Every edge on an 8-bin global grid and on 2-bin local grids, and the
    longest limb (the shin) on test_rpsm.yaml's 16-bin grid: equal, but for
    entries whose |d - L| lies within 1e-3 mm of the tolerance (counted:
    none at these inputs)."""
    pose = _pose()
    limbs = np.asarray(jpic.limb_lengths_from_pose(jnp.asarray(pose)))
    assert np.allclose(tpic.limb_lengths_from_pose(torch.from_numpy(pose)).numpy(), limbs,
                       rtol=1e-6)
    centre = torch.from_numpy(pose[6] + np.float32([3.3, -7.1, 11.9]))
    grid8, grid16 = (tpic.compute_grid(2000.0, centre, n) for n in (8, 16))
    local = tpic.compute_grid(125.0, torch.from_numpy(pose), 2)  # [J, 8, 3]
    shin = tpic.EDGES.index((1, 0))
    cases = [(e, grid8, grid8) for e in range(len(tpic.EDGES))] + [
        (e, local[p], local[c]) for e, (p, c) in enumerate(tpic.EDGES)] + [
        (shin, grid16, grid16)]
    near = 0
    for e, gp, gc in cases:
        got = tpic.pairwise_constraints(gp, gc, torch.tensor(limbs[e]), 150.0).numpy()
        want = np.asarray(jpic.pairwise_constraints(jnp.asarray(gp.numpy()),
                                                    jnp.asarray(gc.numpy()), limbs[e], 150.0))
        d = np.linalg.norm(gp.numpy()[:, None].astype(np.float64) - gc.numpy()[None], axis=-1)
        edge = np.abs(np.abs(d - limbs[e]) - 150.0) <= 1e-3
        near += int(edge.sum())
        assert np.array_equal(got[~edge], want[~edge]), e
    assert near == 0
    assert 0 < want.mean() < 0.5  # the 16-bin table holds both values


def _render(poses, tcams, jcams):
    """GT heatmaps of skeletons in the H36M projection (project_pose), crops
    at centre 500 and scale 5: heatmaps [G, 4, 16, 64, 64], centers and
    scales [G, 4, 2]."""
    g = len(poses)
    pix = np.asarray(jax.vmap(jax.vmap(jproject_pose, in_axes=(None, 0)))(
        jnp.asarray(poses), jcams))
    centers = np.full((g, 4, 2), 500.0, np.float32)
    scales = np.full((g, 4, 2), 5.0, np.float32)
    crop = affine_transform_points(pix, get_affine_transform(centers, scales, 0.0, IMAGE))
    hm, _ = render_gaussian_heatmaps(crop, jnp.ones((g, 4, 16)), HEATMAP, IMAGE, 2)
    return np.asarray(hm), centers, scales


def test_compute_unary_matches_jax():
    """Within 1e-5 of the largest score, on a shared 8-bin grid and on
    per-joint local grids (JAX's jitted: its eager call compiles op by op,
    3x slower)."""
    tcams = tsyn.make_camera_ring()
    jcams = jsyn.make_camera_ring()
    pose = _pose(1)
    hm, centers, scales = _render(pose[None], tsyn.tile_cameras(tcams, 1),
                                  jsyn.tile_cameras(jcams, 1))
    hm, centers, scales = hm[0], centers[0], scales[0]
    for grids in (tpic.compute_grid(1600.0, torch.from_numpy(pose[6]), 8)[None],
                  tpic.compute_grid(125.0, torch.from_numpy(pose), 2)):
        got = tpic.compute_unary(torch.from_numpy(hm), grids, tcams, torch.from_numpy(centers),
                                 torch.from_numpy(scales), IMAGE, HEATMAP).numpy()
        want = np.asarray(jax.jit(jpic.compute_unary, static_argnums=(5, 6))(
            jnp.asarray(hm), jnp.asarray(grids.numpy()), jcams, jnp.asarray(centers),
            jnp.asarray(scales), IMAGE, HEATMAP))
        assert got.shape == want.shape == (16, grids.shape[1]) and want.max() > 0.5
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("nb", [8, 27])
def test_infer_max_product_bins_equal_with_ties(nb):
    """Unary scores on four levels (many equal), sparse 0/1 tables with
    all-zero rows and columns: ties everywhere, and the first bin wins in
    both packages."""
    rs = np.random.RandomState(nb)
    unary = rs.randint(0, 4, (16, nb)).astype(np.float32)
    tables = (rs.rand(len(tpic.EDGES), nb, nb) < 0.3).astype(np.float32)
    tables[:, rs.randint(0, nb, 3)] = 0.0
    tables[:, :, rs.randint(0, nb, 3)] = 0.0
    got = tpic.infer_max_product(torch.from_numpy(unary), list(torch.from_numpy(tables))).numpy()
    want = np.asarray(jpic.infer_max_product(jnp.asarray(unary),
                                             {e: jnp.asarray(t) for e, t in enumerate(tables)}))
    assert np.array_equal(got, want)
    # batched over groups: each row as alone
    batched = tpic.infer_max_product(torch.from_numpy(np.stack([unary, unary[::-1].copy()])),
                                     list(torch.from_numpy(tables)))
    assert np.array_equal(batched[0].numpy(), got)


def _rpsm_cfg(package_default_config, nbins, depth, grid):
    cfg = package_default_config()
    cfg.NETWORK.IMAGE_SIZE = np.array(IMAGE)
    cfg.NETWORK.HEATMAP_SIZE = np.array(HEATMAP)
    cfg.PICT_STRUCT.FIRST_NBINS = nbins
    cfg.PICT_STRUCT.RECUR_DEPTH = depth
    cfg.PICT_STRUCT.GRID_SIZE = grid
    return cfg


def test_rpsm_matches_jax():
    """2 groups at 8 bins and depth 3 against JAX's eager call (as its CLI
    runs it): equal poses, so equal bins at every level (a pose is its bin's
    point on grids that are equal bit for bit), well within 1e-3 mm."""
    g = 2
    poses = tsyn.make_skeleton_poses(g, seed=3)
    tcams = tsyn.tile_cameras(tsyn.make_camera_ring(), g)
    jcams = jsyn.tile_cameras(jsyn.make_camera_ring(), g)
    hm, centers, scales = _render(poses, tcams, jcams)
    limbs = np.asarray(jpic.limb_lengths_from_pose(jnp.asarray(poses.mean(0))))
    roots = poses[:, 6] + np.float32([25.0, -40.0, 30.0])
    got = tpic.rpsm(torch.from_numpy(hm), tcams, torch.from_numpy(centers),
                    torch.from_numpy(scales), torch.from_numpy(roots), torch.from_numpy(limbs),
                    _rpsm_cfg(tdefault_config, 8, 3, 2000.0)).numpy()
    want = np.asarray(jpic.rpsm(jnp.asarray(hm), jcams, jnp.asarray(centers), jnp.asarray(scales),
                                jnp.asarray(roots), jnp.asarray(limbs),
                                _rpsm_cfg(default_config, 8, 3, 2000.0)))
    assert np.array_equal(got, want)
    assert np.linalg.norm(got - poses, axis=-1).mean() < 100.0


def test_rpsm_refines_rendered_maps_to_gt():
    """The JAX package's own check (tests/test_rpsm.py) on the port: GT
    maps of a skeleton refine to within 60 mm a joint on average and 150
    at most; one group alone gives the batch's row."""
    g = 3
    poses = tsyn.make_skeleton_poses(g, seed=4)
    tcams = tsyn.tile_cameras(tsyn.make_camera_ring(), g)
    jcams = jsyn.tile_cameras(jsyn.make_camera_ring(), g)
    hm, centers, scales = _render(poses, tcams, jcams)
    limbs = tpic.limb_lengths_from_pose(torch.from_numpy(poses.mean(0)))
    args = (torch.from_numpy(hm), tcams, torch.from_numpy(centers), torch.from_numpy(scales),
            torch.from_numpy(poses[:, 6].copy()), limbs)
    out = tpic.rpsm(*args, _rpsm_cfg(tdefault_config, 8, 6, 1600.0)).numpy()
    err = np.linalg.norm(out - poses, axis=-1)
    assert err.mean() < 60.0 and err.max() < 150.0, err
    one = tpic.rpsm_one_group(args[0][1], tcams.map(lambda x: x[1]), args[2][1], args[3][1],
                              args[4][1], limbs, IMAGE, HEATMAP, first_nbins=8,
                              recur_depth=6, grid_size=1600.0)
    assert torch.equal(one, torch.from_numpy(out[1]))
