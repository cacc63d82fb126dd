"""Synthetic multi-camera rigs and poses for tests and benchmarks: a
4-camera H36M-like rig with known intrinsics and distortion, and
ground-truth 3D skeletons, from which the geometry's invariants (GT 2D ->
~0 MPJPE, RANSAC outlier rejection, RPSM refinement) are checkable without
the real data sets. The same seed gives the JAX package's arrays."""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.geometry.cameras import CameraParams


def make_camera_ring(n_cams: int = 4, radius: float = 5000.0,
                     height: float = 1500.0, image_size=(1000, 1000),
                     distortion: bool = True, seed: int = 0,
                     device=None) -> CameraParams:
    """Cameras on a ring looking at the origin, H36M-ish scales (mm), with
    leading dim [n_cams]. The same seed gives the JAX package's rig."""
    rs = np.random.RandomState(seed)
    Rs, Ts, fs, cs, ks, ps = [], [], [], [], [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams + 0.3
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        # look-at rotation: camera z axis toward origin (x_cam = R(x - T))
        z = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs.append(np.stack([x, y, z], axis=0))
        Ts.append(pos)
        fs.append(np.array([1100.0, 1100.0]) + rs.uniform(-30, 30, 2))
        cs.append(np.array(image_size, float) / 2 + rs.uniform(-8, 8, 2))
        if distortion:
            ks.append(np.array([-0.20, 0.24, -0.002]) + rs.uniform(-0.01, 0.01, 3))
            ps.append(np.array([-0.001, -0.0008]) + rs.uniform(-5e-4, 5e-4, 2))
        else:
            ks.append(np.zeros(3))
            ps.append(np.zeros(2))
    t = lambda a: torch.as_tensor(np.stack(a), dtype=torch.float32, device=device)
    return CameraParams(t(Rs), t(Ts), t(fs), t(cs), t(ks), t(ps))


def make_poses3d(n_groups: int, n_joints: int = 16, seed: int = 0) -> np.ndarray:
    """Random human-scale 3D point clouds near the rig centre (mm)."""
    rs = np.random.RandomState(seed)
    root = rs.uniform(-500, 500, size=(n_groups, 1, 3))
    root[..., 2] = rs.uniform(800, 1200, size=(n_groups, 1))
    offsets = rs.uniform(-600, 600, size=(n_groups, n_joints, 3))
    return (root + offsets).astype(np.float32)


# Canonical standing pose in the 16-joint MPII order (geometry/body.py
# JOINT_NAMES), mm, z-up, root over the origin: realistic bone lengths, so
# synthetic MPJPE numbers mean mm and RPSM's limb-length prior holds.
CANONICAL_POSE_MM = np.array(
    [
        [-150, 30, 80],     # rank
        [-140, 20, 550],    # rkne
        [-130, 0, 990],     # rhip
        [130, 0, 990],      # lhip
        [140, 20, 550],     # lkne
        [150, 30, 80],      # lank
        [0, 0, 1000],       # root
        [0, -20, 1450],     # thorax
        [0, -30, 1580],     # upper neck
        [0, -20, 1750],     # head top
        [-270, 80, 900],    # rwri
        [-260, 40, 1150],   # relb
        [-220, 0, 1420],    # rsho
        [220, 0, 1420],     # lsho
        [260, 40, 1150],    # lelb
        [270, 80, 900],     # lwri
    ],
    np.float32,
)


def make_skeleton_poses(n_groups: int, seed: int = 0, jitter: float = 40.0) -> np.ndarray:
    """Human skeletons [n_groups, 16, 3] (mm): the canonical pose, a random
    yaw, a root shift and per-joint jitter (bone lengths stay within RPSM's
    limb tolerance)."""
    rs = np.random.RandomState(seed)
    poses = np.empty((n_groups, 16, 3), np.float32)
    for g in range(n_groups):
        ang = rs.uniform(0, 2 * np.pi)
        cs, sn = np.cos(ang), np.sin(ang)
        rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], np.float32)
        p = CANONICAL_POSE_MM @ rot.T
        p += rs.uniform(-jitter, jitter, (16, 3)).astype(np.float32)
        p[:, :2] += rs.uniform(-400, 400, 2).astype(np.float32)
        poses[g] = p
    return poses


def tile_cameras(cams: CameraParams, n_groups: int) -> CameraParams:
    """Tile a [V]-camera rig to [G, V] groups."""
    return cams.map(lambda x: x[None].expand((n_groups,) + x.shape))


# -------------------------------------------------------- image data sets

# One BGR colour a joint; the two joints of a flip pair share theirs, so a
# mirrored crop (whose labels swap) still shows each label its colour's pair.
_PAIR_COLOURS = [(40, 40, 230), (40, 200, 40), (230, 60, 40), (30, 220, 230),
                 (220, 40, 220), (230, 220, 40)]
_MID_COLOURS = {6: (255, 255, 255), 7: (128, 128, 255), 8: (128, 255, 128), 9: (255, 160, 90)}
_PAIRS16 = [(0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)]
JOINT_COLOURS = [None] * 16
for _c, (_a, _b) in zip(_PAIR_COLOURS, _PAIRS16):
    JOINT_COLOURS[_a] = JOINT_COLOURS[_b] = _c
for _j, _c in _MID_COLOURS.items():
    JOINT_COLOURS[_j] = _c
# the 17 H36M joints (data/h36m.H36M_JOINTS) from the 16 of CANONICAL_POSE_MM;
# "belly" (7) is taken half way from the root to the thorax below
H36M_FROM_16 = [6, 2, 1, 0, 3, 4, 5, -1, 7, 8, 9, 13, 14, 15, 12, 11, 10]


def _background(rs, w: int, h: int) -> np.ndarray:
    """A textured uint8 BGR frame: smooth grey fields with a faint tint plus
    pixel noise, so that a JPEG of it costs about what a photograph costs to
    decode, and the joints' colours stand out."""
    import cv2

    low = rs.randint(30, 200, (max(h // 40, 2), max(w // 40, 2), 1)).astype(np.uint8)
    grey = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    img = np.repeat(grey[..., None], 3, axis=2) + rs.randint(-20, 21, 3).astype(np.int16)
    img += rs.randint(-14, 15, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _draw_blobs(img, joints16, vis16, radius: int) -> None:
    import cv2

    for j in range(16):
        if vis16[j] > 0:
            cv2.circle(img, (int(round(joints16[j, 0])), int(round(joints16[j, 1]))), radius,
                       JOINT_COLOURS[j], -1, lineType=cv2.LINE_AA)


def _encode(img, quality: int = 90) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def _write_images(root: str, source: str, images: dict, data_format: str) -> None:
    """{name: jpeg bytes} as <root>/<source>/images.zip (members images/<name>)
    or as files under <root>/<source>/images/."""
    import os
    import zipfile

    if data_format == "zip":
        os.makedirs(os.path.join(root, source), exist_ok=True)
        with zipfile.ZipFile(os.path.join(root, source, "images.zip"), "w",
                             zipfile.ZIP_STORED) as zf:
            for name, data in images.items():
                zf.writestr(f"images/{name}", data)
    else:
        os.makedirs(os.path.join(root, source, "images"), exist_ok=True)
        for name, data in images.items():
            with open(os.path.join(root, source, "images", name), "wb") as f:
                f.write(data)


def _cam_dict(cams: CameraParams, v: int) -> dict:
    """The reference's per-view camera dict of view ``v``."""
    a = lambda x: x[v].detach().cpu().double().numpy()
    return {"R": a(cams.R), "T": a(cams.T).reshape(3, 1), "fx": float(cams.f[v, 0]),
            "fy": float(cams.f[v, 1]), "cx": float(cams.c[v, 0]), "cy": float(cams.c[v, 1]),
            "k": a(cams.k).reshape(3, 1), "p": a(cams.p).reshape(2, 1)}


def write_image_fixture(root: str, n_images: int = 64, mpii_size=(1280, 720),
                        h36m_size=(1000, 1000), mpii_train: int = 1024, mpii_valid: int = 96,
                        h36m_train_groups: int = 64, h36m_valid_groups: int = 24,
                        data_format: str = "zip", seed: int = 0) -> dict:
    """Write MPII and H36M in the reference's layout under ``root`` (the
    data sets' DATASET.ROOT), with learnable images: a coloured disc at
    each visible joint (one colour a flip pair) on a textured background.

    - ``mpii/annot/{train,valid}.json`` (``mpii_train``, ``mpii_valid``
      records), ``mpii/annot/gt_valid.mat`` (head boxes) and ``n_images``
      JPEGs of ``mpii_size`` (W, H), one skeleton each seen from its side;
      the records take the images in turn, each with its own jitter of the
      center and scale;
    - ``h36m/annot/h36m_{train,validation}.pkl``: ``h36m_train_groups``
      four-view groups after the train split's ::5 and
      ``h36m_valid_groups`` after validation's ::64, seen by
      :func:`make_camera_ring` (``h36m_size``, distortion; the focal
      lengths scaled from its 1000 pixels), two subjects;
      ``n_images`` JPEGs (``n_images // 4`` skeletons by 4 cameras) back
      them in turn;
    - the images in ``<source>/images.zip`` (``data_format="zip"``) or
      under ``<source>/images/``.

    Returns the counts written."""
    import json
    import os
    import pickle

    from scipy.io import savemat

    from posetpu_torch.geometry.cameras import project_points, world_to_camera_frame

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "mpii", "annot"), exist_ok=True)
    os.makedirs(os.path.join(root, "h36m", "annot"), exist_ok=True)

    # ---- MPII: one skeleton a frame, seen from its side (x right, z up)
    w, h = mpii_size
    poses = make_skeleton_poses(n_images, seed=seed + 1, jitter=25.0)
    people, images = [], {}
    for i in range(n_images):
        p = poses[i] - poses[i].mean(0)
        height = rs.uniform(0.45, 0.8) * h
        px = p[:, 0].astype(np.float64) * height / 1750.0
        py = -p[:, 2].astype(np.float64) * height / 1750.0
        cx = rs.uniform(0.3, 0.7) * w
        cy = h * 0.5 + rs.uniform(-0.05, 0.05) * h
        j2d = np.stack([px + cx, py + cy], 1)
        vis = (rs.rand(16) > 0.08).astype(np.float64)
        img = _background(rs, w, h)
        _draw_blobs(img, j2d, vis, max(int(height / 45), 2))
        name = f"{i:05d}.jpg"
        images[name] = _encode(img)
        lo, hi = j2d.min(0), j2d.max(0)
        people.append((name, j2d, vis, (lo + hi) / 2.0, (hi[1] - lo[1]) / 200.0,
                       np.linalg.norm(j2d[9] - j2d[8])))
    _write_images(root, "mpii", images, data_format)

    def mpii_annot(n):
        out, heads = [], []
        for r in range(n):
            name, j2d, vis, center, scale, head = people[r % n_images]
            s = scale * rs.uniform(0.9, 1.1)
            c = center + rs.uniform(-0.05, 0.05, 2) * scale * 200.0
            # the loader adds 15 s to y, then takes one off each (matlab)
            out.append({"image": name, "center": [float(c[0] + 1), float(c[1] + 1 - 15 * s)],
                        "scale": float(s),
                        "joints": (j2d + 1).tolist(), "joints_vis": vis.tolist()})
            heads.append(head)
        return out, np.asarray(heads)

    train, _ = mpii_annot(mpii_train)
    valid, heads = mpii_annot(mpii_valid)
    for subset, annot in (("train", train), ("valid", valid)):
        with open(os.path.join(root, "mpii", "annot", f"{subset}.json"), "w") as f:
            json.dump(annot, f)
    # head boxes whose diagonal times 0.6 is the head segment times 1.5
    side = heads * 1.5 / 0.6 / np.sqrt(2.0)
    headboxes = np.zeros((2, 2, mpii_valid))
    headboxes[1] = side[None]
    savemat(os.path.join(root, "mpii", "annot", "gt_valid.mat"), {"headboxes_src": headboxes})

    # ---- H36M: n_images // 4 skeletons by the four cameras of the ring
    ring = make_camera_ring(image_size=h36m_size)  # focal lengths scaled to the frame
    cams = CameraParams(ring.R, ring.T, ring.f * (h36m_size[0] / 1000.0), ring.c, ring.k, ring.p)
    n_poses = max(n_images // 4, 1)
    poses = torch.from_numpy(make_skeleton_poses(n_poses, seed=seed + 2))
    images, views = {}, []
    for p in range(n_poses):
        p17 = poses[p][[max(k, 0) for k in H36M_FROM_16]].clone()
        p17[7] = 0.5 * (poses[p][6] + poses[p][7])
        per_cam = []
        for v in range(4):
            cam_v = cams.map(lambda x, v=v: x[v])
            pix16 = project_points(poses[p], cam_v).numpy().astype(np.float64)
            pix17 = project_points(p17, cam_v).numpy().astype(np.float64)
            img = _background(rs, *h36m_size)
            height = pix16[:, 1].max() - pix16[:, 1].min()
            _draw_blobs(img, pix16, np.ones(16), max(int(height / 45), 2))
            name = f"p{p:03d}_c{v}.jpg"
            images[name] = _encode(img)
            j3d = world_to_camera_frame(p17, cam_v.R, cam_v.T).numpy().astype(np.float64)
            per_cam.append((name, pix17, j3d))
        views.append(per_cam)
    _write_images(root, "h36m", images, data_format)

    def h36m_db(n_groups, split):
        db = []
        for g in range(n_groups):
            for v in range(4):
                name, pix, j3d = views[g % n_poses][v]
                lo, hi = pix.min(0), pix.max(0)
                scale = (hi - lo).max() * 1.25 / 200.0 * rs.uniform(0.95, 1.05)
                db.append({
                    "image": name, "center": (lo + hi) / 2.0 + rs.uniform(-5, 5, 2),
                    "scale": np.full(2, scale), "joints_2d": pix,
                    "joints_vis": np.ones((17, 3)), "joints_3d": j3d,
                    "camera": _cam_dict(cams, v), "source": "h36m",
                    "subject": 1 if g % 2 == 0 else 5, "action": 2 + (g // 1000) % 15,
                    "subaction": 1, "image_id": g, "camera_id": v})
        return db

    for subset, n_groups in (("train", 5 * h36m_train_groups),
                             ("validation", 64 * (h36m_valid_groups - 1) + 1)):
        with open(os.path.join(root, "h36m", "annot", f"h36m_{subset}.pkl"), "wb") as f:
            pickle.dump(h36m_db(n_groups, subset), f)
    return {"mpii_train": mpii_train, "mpii_valid": mpii_valid,
            "h36m_train_groups": h36m_train_groups, "h36m_valid_groups": h36m_valid_groups,
            "images": 2 * n_images}
