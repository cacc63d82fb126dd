"""Fundamental matrices for the epipolar loss, from calibration.

The reference mints per-(subject, view-pair) F matrices offline with
``cv2.findFundamentalMat`` on ground-truth joints
(run/test/generate_fundamental_matirx.py:33-103). Here the exact F comes from
the cameras (F = K2^-T [t]x R K1^-1), on the host in float64 numpy: the
residual x2^T F x1 cancels ~1e6-sized products, so f32 here would leave
O(0.05 px) noise floors.

Convention: x1 in view a and x2 in view b (homogeneous pixels) satisfy
``x2^T F x1 = 0`` with F = bank[(subject, a, b)], FundamentalLoss's
``(h2 @ F) . h1`` residual (lib/core/loss.py:128).
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from posetpu_torch.core.losses import VIEW_PERMS
from posetpu_torch.geometry.cameras import CameraParams


def _f64(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                      np.float64)


def fundamental_from_cameras(cam1: CameraParams, cam2: CameraParams):
    """Exact F for the pinhole parts of two cameras (distortion ignored, as
    in the reference's fitted F): a [3, 3] float64 numpy array scaled so its
    largest |entry| is 1."""
    R1, R2, T1, T2 = _f64(cam1.R), _f64(cam2.R), _f64(cam1.T), _f64(cam2.T)

    def kmat(cam):
        f, c = _f64(cam.f), _f64(cam.c)
        return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1]])

    r_rel = R2 @ R1.T
    t_rel = R2 @ (T1 - T2)
    tx = np.array([[0, -t_rel[2], t_rel[1]],
                   [t_rel[2], 0, -t_rel[0]],
                   [-t_rel[1], t_rel[0], 0]])
    f = np.linalg.inv(kmat(cam2)).T @ (tx @ r_rel) @ np.linalg.inv(kmat(cam1))
    return f / np.maximum(np.abs(f).max(), 1e-12)


def eight_point(pts1, pts2):
    """Hartley-normalised 8-point estimate of F from pts1 / pts2 [N, 2]
    corresponding pixels (N >= 8): rank 2 enforced, scaled so its largest
    |entry| is 1, in the points' dtype. The 9x9 normal matrix and its
    eigenvectors are taken in float64: in float32 its smallest eigenvector
    moves F's entries by up to 2e-4 on real joints."""

    def normalise(p):
        mean = p.mean(dim=0)
        d = torch.sqrt(((p - mean) ** 2).sum(dim=1)).mean()
        s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
        z = torch.zeros((), dtype=p.dtype, device=p.device)
        one = torch.ones((), dtype=p.dtype, device=p.device)
        t = torch.stack([torch.stack([s, z, -s * mean[0]]),
                         torch.stack([z, s, -s * mean[1]]),
                         torch.stack([z, z, one])])
        ph = torch.cat([p, torch.ones_like(p[:, :1])], dim=1)
        return ph @ t.T, t

    p1, t1 = normalise(pts1)
    p2, t2 = normalise(pts2)
    # x2^T F x1 = 0: each row of A is kron(x2_i, x1_i)
    a = torch.einsum("ni,nj->nij", p2, p1).reshape(-1, 9).double()
    _, vecs = torch.linalg.eigh(a.T @ a)
    u, s, vt = torch.linalg.svd(vecs[:, 0].reshape(3, 3))
    f = (u * torch.cat([s[:2], torch.zeros_like(s[2:])])[None, :]) @ vt
    f = t2.T.double() @ f @ t1.double()
    return (f / torch.clamp(f.abs().max(), min=1e-12)).to(pts1.dtype)


def load_reference_bank(path: str) -> dict:
    """The reference's fundamental_matrix.pkl ({(subject, a, b): 3x3}) as
    {key: [3, 3] float32 numpy array}. A pickle runs code when it is read:
    load only a file of the reference's that you trust."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return {k: np.asarray(v, np.float32) for k, v in raw.items()}


def build_fundamental_bank(cams_by_subject: dict) -> dict:
    """{subject: CameraParams with leading [V]} -> {(subject, a, b): [3, 3]
    float32 F} over the 12 ordered pairs, the dict FundamentalLoss reads
    (loss.py:92-99)."""
    bank = {}
    for subj, cams in cams_by_subject.items():
        for a, b in VIEW_PERMS:
            bank[(subj, a, b)] = fundamental_from_cameras(
                cams.map(lambda x, a=a: x[a]), cams.map(lambda x, b=b: x[b])
            ).astype(np.float32)
    return bank


def bank_to_batch(bank: dict, subjects, device=None) -> torch.Tensor:
    """Per-sample [N, 12, 3, 3] F stacks gathered from ``bank`` by subject
    id (the reference looks each one up per sample, loss.py:125-128), as a
    tensor on ``device`` (the CPU unless given)."""
    out = np.empty((len(subjects), len(VIEW_PERMS), 3, 3), np.float32)
    for i, s in enumerate(np.asarray(subjects)):
        for p, (a, b) in enumerate(VIEW_PERMS):
            out[i, p] = bank[(int(s), a, b)]
    return torch.as_tensor(out, device=device)
