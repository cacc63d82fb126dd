"""Debug drawings.

Equivalent of lib/utils/vis.py: grids of GT and predicted joints over the
denormalised input crops, heatmap mosaics, and per-image prediction sheets;
cv2 and numpy on the host, written every PRINT_FREQ as the reference does
(function.py:521-526). The files are the JAX package's. cv2 is imported
where a sheet is drawn.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _denormalize(images, mean, std):
    """[N, H, W, 3] normalised floats -> uint8 BGR."""
    img = images * np.asarray(std) + np.asarray(mean)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def save_batch_image_with_joints(images, joints, joints_vis, path,
                                 nrow: int = 8, padding: int = 2):
    """A grid of images with a dot at each visible joint (vis.py:23-66).
    images [N, H, W, 3] uint8; joints [N, J, 2] in crop pixels."""
    import cv2

    n, h, w = images.shape[:3]
    nrow = min(nrow, n)
    ncol = int(np.ceil(n / nrow))
    canvas = np.zeros((ncol * (h + padding), nrow * (w + padding), 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, nrow)
        y0, x0 = r * (h + padding), c * (w + padding)
        img = images[i].copy()
        for (x, y), v in zip(joints[i], joints_vis[i]):
            if v > 0:
                cv2.circle(img, (int(x), int(y)), 2, (0, 255, 0), 2)
        canvas[y0:y0 + h, x0:x0 + w] = img
    cv2.imwrite(path, canvas)


def save_batch_heatmaps(images, heatmaps, path):
    """Each image beside its joints' heatmaps over it (vis.py:69-121).
    images [N, H, W, 3] uint8; heatmaps [N, h, w, J]."""
    import cv2

    n, hh, hw, j = heatmaps.shape
    # the colour map as a table, looked up by numpy: cv2.applyColorMap's
    # pixels, without the table built again each call (12 ms a call with cv2
    # 4.13 on an H100 host's CPU: 3 s a batch, PERF.md)
    jet = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    rows = []
    for i in range(n):
        img_small = cv2.resize(images[i], (hw, hh))
        cells = [img_small]
        for jj in range(j):
            hm = np.clip(heatmaps[i, :, :, jj] * 255, 0, 255).astype(np.uint8)
            cells.append((0.7 * jet[hm] + 0.3 * img_small).astype(np.uint8))
        rows.append(np.concatenate(cells, axis=1))
    cv2.imwrite(path, np.concatenate(rows, axis=0))


def save_debug_images(cfg, images_norm, joints_gt, joints_vis, joints_pred,
                      target, output, prefix: str):
    """GT joints, predicted joints, GT and predicted heatmaps
    (vis.py:124-150), each behind its DEBUG flag. Arrays or tensors."""
    if not cfg.DEBUG.DEBUG:
        return
    as_np = lambda x: x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    images = _denormalize(as_np(images_norm), np.asarray(cfg.DATASET.MEAN),
                          np.asarray(cfg.DATASET.STD))
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    if cfg.DEBUG.SAVE_BATCH_IMAGES_GT:
        save_batch_image_with_joints(images, as_np(joints_gt), as_np(joints_vis),
                                     f"{prefix}_gt.jpg")
    if cfg.DEBUG.SAVE_BATCH_IMAGES_PRED:
        pred = as_np(joints_pred)
        save_batch_image_with_joints(images, pred, np.ones(pred.shape[:2]),
                                     f"{prefix}_pred.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_GT:
        save_batch_heatmaps(images, as_np(target), f"{prefix}_hm_gt.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_PRED:
        save_batch_heatmaps(images, as_np(output), f"{prefix}_hm_pred.jpg")


def save_all_preds(gt, pred, detected, image_names, source, output_dir,
                   image_root: str = "", max_images: int = 200):
    """Per-sample predictions (vis.py:253-296): a JSON-lines summary
    ``all_preds_<source>.jsonl`` and, where ``image_root`` locates the
    source images, the reference's overlay sheets in ``<output_dir>/debug``
    (GT joints red circles, detected predictions green crosses, misses blue
    crosses; at most ``max_images``). Returns the summary's path."""
    import cv2

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"all_preds_{source}.jsonl")
    with open(path, "w") as f:
        for i, name in enumerate(image_names):
            f.write(json.dumps({
                "image": str(name),
                "gt": np.asarray(gt[i]).tolist(),
                "pred": np.asarray(pred[i]).tolist(),
                "detected": np.asarray(detected[i]).astype(int).tolist(),
            }) + "\n")

    if image_root:
        from posetpu_torch.data import zipreader

        debug_dir = os.path.join(output_dir, "debug")
        os.makedirs(debug_dir, exist_ok=True)
        red, green, blue = (0, 0, 255), (0, 255, 0), (255, 0, 0)
        for i, name in enumerate(image_names[:max_images]):
            img = zipreader.imread(os.path.join(image_root, str(name)),
                                   cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
            for j in range(len(gt[i])):
                cv2.circle(img, (int(gt[i][j][0]), int(gt[i][j][1])), 5, red, -1)
                cv2.drawMarker(img, (int(pred[i][j][0]), int(pred[i][j][1])),
                               green if detected[i][j] else blue, cv2.MARKER_CROSS, 10)
            cv2.imwrite(os.path.join(debug_dir, f"{i:05d}.jpg"), img)
    return path
