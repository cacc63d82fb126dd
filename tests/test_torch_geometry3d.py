"""The port's 3D geometry against the JAX package on the CPU: the skeleton
tables, camera dicts, the synthetic poses, flat triangulation, the RANSAC
filter and the reprojection. The same numpy inputs go to both packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.data import synthetic as jsyn
from posetpu.geometry import body as jbody
from posetpu.geometry import triangulate as jtri
from posetpu.geometry.cameras import CameraParams as JCams
from posetpu.geometry.cameras import project_points as jproject
from posetpu_torch.data import synthetic as tsyn
from posetpu_torch.geometry import body as tbody
from posetpu_torch.geometry import triangulate as ttri
from posetpu_torch.geometry.cameras import CameraParams as TCams

G = 32


def test_body_tables_equal():
    assert tbody.JOINT_NAMES == jbody.JOINT_NAMES
    assert tbody.CHILDREN == jbody.CHILDREN
    assert tbody.ROOT_IDX == jbody.ROOT_IDX
    assert tbody.edges() == jbody.edges()
    order = tbody.nodes_by_level_desc()
    assert order == jbody.nodes_by_level_desc()
    assert sorted(order) == list(range(16)) and order[-1] == tbody.ROOT_IDX
    hb_t, hb_j = tbody.HumanBody(), jbody.HumanBody()
    assert hb_t.skeleton == hb_j.skeleton and hb_t.root_idx == hb_j.root_idx
    assert hb_t.skeleton_sorted_by_level == hb_j.skeleton_sorted_by_level


def test_synthetic_poses_equal():
    assert np.array_equal(tsyn.CANONICAL_POSE_MM, jsyn.CANONICAL_POSE_MM)
    assert np.array_equal(tsyn.make_skeleton_poses(5, seed=3), jsyn.make_skeleton_poses(5, seed=3))
    assert np.array_equal(tsyn.make_poses3d(4, n_joints=17, seed=2),
                          jsyn.make_poses3d(4, n_joints=17, seed=2))


def _camera_dicts(n, seed=0):
    """Per-view camera dicts in the H36M annotation's float64 layout, values
    off the float32 grid so the one rounding shows."""
    ring = tsyn.make_camera_ring(n_cams=n, seed=seed)
    rs = np.random.RandomState(seed)
    jitter = lambda x, s: np.asarray(x, np.float64) + rs.uniform(-s, s, np.shape(x))
    return [{"R": jitter(ring.R[v], 1e-9), "T": jitter(ring.T[v], 1e-3).reshape(3, 1),
             "fx": jitter(ring.f[v, 0], 1e-4), "fy": jitter(ring.f[v, 1], 1e-4),
             "cx": jitter(ring.c[v, 0], 1e-4), "cy": jitter(ring.c[v, 1], 1e-4),
             "k": jitter(ring.k[v], 1e-9).reshape(3, 1),
             "p": jitter(ring.p[v], 1e-9).reshape(2, 1)} for v in range(n)]


def test_camera_from_dict_and_stack_equal():
    dicts = _camera_dicts(4)
    got = TCams.stack([TCams.from_dict(d) for d in dicts])
    want = JCams.stack([JCams.from_dict(d) for d in dicts])
    for name, a, b in zip(TCams._fields, got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        assert np.array_equal(a.numpy(), np.asarray(b)), name


def _cams(distortion: bool, groups: int = G):
    t = tsyn.tile_cameras(tsyn.make_camera_ring(distortion=distortion), groups)
    j = jsyn.tile_cameras(jsyn.make_camera_ring(distortion=distortion), groups)
    return t, j


def _project(poses, jcams):
    """[G, J, 3] world points -> [G, V, J, 2] pixels, by the JAX package."""
    return np.asarray(jax.vmap(jax.vmap(jproject, in_axes=(None, 0)))(jnp.asarray(poses), jcams))


def _flat(cams, n):
    return type(cams)(*[x.reshape((n,) + tuple(x.shape[2:])) for x in cams])


def _bound(jax_fn, x, tol):
    """Per element: ``tol``, or three times JAX's own move under a one-ulp
    nudge of the input ``x``, where that is larger. Where only two opposite
    views are visible (their baseline runs through the subject) the DLT is
    ill-conditioned, and float32 rounding moves JAX's answer as much as the
    port's."""
    want = jax_fn(x)
    own = np.maximum(np.abs(jax_fn(np.nextafter(x, np.inf)) - want),
                     np.abs(jax_fn(np.nextafter(x, -np.inf)) - want))
    return want, np.maximum(tol, 3 * own)


def test_triangulate_poses_flat_matches_jax():
    """GT pixels of skeletons, some views invisible: within 1e-3 mm (or
    :func:`_bound`'s, on at most 1 % of the coordinates)."""
    tcams, jcams = _cams(True)
    poses = tsyn.make_skeleton_poses(G, seed=1)
    pix = _project(poses, jcams).reshape(G * 4, 16, 2)
    vis = (np.random.RandomState(1).rand(G * 4, 16) > 0.2).astype(np.float32)
    got = ttri.triangulate_poses(torch.from_numpy(pix.copy()), _flat(tcams, G * 4),
                                 torch.from_numpy(vis)).numpy()
    want, bound = _bound(lambda x: np.asarray(jtri.triangulate_poses(
        jnp.asarray(x), _flat(jcams, G * 4), jnp.asarray(vis))), pix, 1e-3)
    err = np.abs(got - want)
    assert (err <= bound).all() and (err > 1e-3).mean() <= 0.01, err.max()
    enough = vis.reshape(G, 4, 16).sum(1) >= 2
    assert (got[~enough] == 0).all() and np.abs(got[enough] - poses[enough]).max() < 1.0


def _ransac_input(jcams, seed=0):
    """Pseudo-label-like observations of skeletons: 1.5 px noise, outliers
    (one view of 15 % of the group-joints moved 40-120 px), 10 % of the
    views invisible, and three planted groups: group 0 invisible in every
    view; group 1 without noise, views 2 and 3 seeing the joint 400 mm away
    from where views 0 and 1 see it (pairs (0, 1) and (2, 3) tie at 2
    inliers); group 2 with every view moved its own way (no pair reaches 3
    inliers)."""
    rs = np.random.RandomState(seed)
    poses = tsyn.make_skeleton_poses(G, seed=seed)
    pix = _project(poses, jcams)
    pred = pix + rs.randn(*pix.shape).astype(np.float32) * 1.5
    g_, j_ = np.nonzero(rs.rand(G, 16) < 0.15)
    ang = rs.uniform(0, 2 * np.pi, len(g_))
    pred[g_, rs.randint(0, 4, len(g_)), j_] += (
        rs.uniform(40, 120, len(g_))[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1))
    vis = (rs.rand(G, 4, 16) > 0.1).astype(np.float32)
    vis[0] = 0.0
    shifted = _project(poses + np.float32([400.0, 0.0, 0.0]), jcams)
    pred[1] = np.concatenate([pix[1, :2], shifted[1, 2:]])
    vis[1] = 1.0
    pred[2] = pix[2] + np.float32([[[60, 0]], [[0, 60]], [[-60, 0]], [[0, -60]]])
    vis[2] = 1.0
    return pred.astype(np.float32), vis


@pytest.mark.parametrize("distortion", [True, False])
@pytest.mark.parametrize("num_inliers", [2, 3, 4])
def test_ransac_filter_equals_jax(distortion, num_inliers):
    """res_vis equal (not close): planted outliers, ties, an invisible group
    and an unmet quota, with and without lens distortion."""
    tcams, jcams = _cams(distortion)
    pred, vis = _ransac_input(jcams)
    args = (10.0, num_inliers, not distortion)
    got = ttri.ransac_filter(torch.from_numpy(pred), tcams, torch.from_numpy(vis), *args).numpy()
    want = np.asarray(jtri.ransac_filter(jnp.asarray(pred), jcams, jnp.asarray(vis), *args))
    assert got.dtype == np.float32 and got.shape == (G, 4, 16)
    assert np.array_equal(got, want), np.argwhere(got != want)[:10]
    assert (got[0] == 0).all()  # no visible view, no hypothesis
    if num_inliers == 2:  # the tie goes to the first pair, (0, 1)
        assert (got[1, :2] == 1).all() and (got[1, 2:] == 0).all()
    else:
        assert (got[2] == 0).all()  # no pair reaches the quota
    assert 0.3 < got.mean() < 0.95


def test_reproject_poses_matches_jax():
    """Within 1e-3 px (or :func:`_bound`'s, on at most 1 % of the
    coordinates) and vis equal."""
    tcams, jcams = _cams(True)
    pred, vis = _ransac_input(jcams, seed=5)
    got, got_vis = ttri.reproject_poses(torch.from_numpy(pred), tcams, torch.from_numpy(vis))
    want, bound = _bound(lambda x: np.asarray(jtri.reproject_poses(
        jnp.asarray(x), jcams, jnp.asarray(vis))[0]), pred, 1e-3)
    err = np.abs(got.numpy() - want)
    assert (err <= bound).all() and (err > 1e-3).mean() <= 0.01, err.max()
    want_vis = np.asarray(jtri.reproject_poses(jnp.asarray(pred), jcams, jnp.asarray(vis))[1])
    assert np.array_equal(got_vis.numpy(), want_vis)
