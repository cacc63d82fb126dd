"""The serving driver: closed-loop requests through the program's int8
serving pipeline, one in flight.

A request is ``groups`` four-view groups of uint8 crops with their crop
geometry and cameras, cycled from a seeded pool in pinned host memory. It
runs ``ServingPipeline.prepare`` -> ``infer`` ->
``geometry.triangulate.triangulate_points`` and ends when its 2D joints,
their maxima and its 3D points are on the host. Its latency runs from the
start of ``prepare`` to then.

``correct``: once the window has closed and the program is freed, a
seeded sample of the finished requests, the slowest among them, is held
against the plain reference (f32, TF32 off) on the same images and
weights: for each served joint, the gap by which the reference's routed
heatmap at the served pixel lies below that map's maximum (a map whose
served maximum is <= 0 counts its reference maximum above 0), and the
served maximum's distance from the reference's value there, both as a
share of that reference map's range; and each served 3D point's distance
from the reference's triangulation of the served joints (float64).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from portbench import faults, harness, traffic, weights
from portbench.trace import span, traced


def run(ctx: harness.Context) -> harness.Record:
    import torch

    from posetpu_torch.geometry.cameras import CameraParams
    from posetpu_torch.geometry.triangulate import triangulate_points
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.ops import aggregation, phase_tail
    from posetpu_torch.serving import build_serving_pipeline

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    rec = harness.Record(kind="serve", cfg=cfg, cell=cell)
    parts = rec.setup_parts
    t = time.perf_counter()
    pcfg = harness.program_config(cfg)
    pool = traffic.serve_pool(cell, cfg, ctx.seed, dev)
    p_count, g, v = cell["pool"], cell["groups"], cell["views"]
    h, w = cfg["image_size"][1], cfg["image_size"][0]
    images = pool["images"]  # [P, G, V, H, W, 3] uint8, pinned
    flat0 = images[0].reshape(g * v, h, w, 3)
    parts["traffic_s"] = time.perf_counter() - t

    t = time.perf_counter()
    wts, head_scale = weights.make(cfg, ctx.seed, dev, traffic.normalise(flat0[:1].to(dev)))
    with torch.device(dev):
        model = get_multiview_pose_net(pcfg)
    harness.load_weights(model, wts)
    model.eval()
    del wts
    harness.sync(dev)
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    n_cal = cell["calib_images"]
    calib = [traffic.normalise(flat0[i * n_cal:(i + 1) * n_cal].to(dev))
             for i in range(cell["calib_batches"])]
    pipe = build_serving_pipeline(pcfg, model, calib, device=dev, **_precision(ctx))
    del model, calib
    harness.free(dev)
    harness.sync(dev)
    parts["calibrate_quantize_s"] = time.perf_counter() - t

    cams = [CameraParams(*(torch.from_numpy(pool["cams"][k][i]).to(dev)
                           for k in ("R", "T", "f", "c", "k", "p"))) for i in range(p_count)]
    images_np = [images[i].numpy() for i in range(p_count)]
    map_w = cfg["heatmap_size"][0]
    shift = [pool["scale"][i][..., 0] * 200.0 / map_w for i in range(p_count)]
    launch = {"B2": phase_tail.fused_subpixel_deconv_batched, "B1": phase_tail.fused_phase_tail2,
              "B3": aggregation.aggregation_grouped, "quantize": aggregation.quantize_heatmaps}

    def request(k, spans=None):
        """One request of pool entry k % P -> float32 numpy [preds,
        maxvals, points] flat; with ``spans`` the host span of prepare
        (ending in a synchronize) is appended to it."""
        i = k % p_count
        with span("request"):
            with span("prepare"):
                t0 = time.perf_counter()
                x = pipe.prepare(images_np[i])
                if spans is not None:
                    harness.sync(dev)
                    spans.append((time.perf_counter() - t0) * 1e3)
            with span("infer"):
                preds, maxvals = pipe.infer(pipe.params, x, pool["center"][i],
                                            pool["scale"][i], pool["is_h36m"][i])
            with span("triangulate"):
                pts = triangulate_points(preds, cams[i], (maxvals > 0).float())
            if ctx.fault:
                preds, maxvals, pts = faults.serve_outputs(ctx.fault, preds, maxvals, pts,
                                                           shift[i][0, 0])
            with span("fetch"):
                out = torch.cat([preds.reshape(-1), maxvals.reshape(-1),
                                 pts.reshape(-1)]).cpu().numpy()
        return out

    t = time.perf_counter()
    for k in range(cell["warmup_requests"]):
        request(k)
    harness.sync(dev)
    parts["warmup_s"] = time.perf_counter() - t
    for fn in launch.values():
        fn.launches = 0

    # ------------------------------------------------------------ the window
    harness.reset_peak(dev)
    rec.setup_s = time.perf_counter() - ctx.t_start
    outputs = []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    k = 0
    while time.perf_counter() < deadline:
        ts = time.perf_counter()
        try:
            out = request(k)
            lat = time.perf_counter() - ts
            ok = bool(np.isfinite(out).all())
        except RuntimeError as e:
            print(f"portbench: request {k} raised {e}", file=sys.stderr, flush=True)
            lat, ok = math.inf, False
        rec.latencies_s.append(lat if ok else math.inf)
        if ok:
            outputs.append((k, lat, out))
        k += 1
    rec.window_s = time.perf_counter() - t0
    rec.attempted = rec.iterations = k
    rec.failed = k - len(outputs)
    rec.groups = g * len(outputs)
    rec.counters = {f"{name} launches a request": fn.launches / max(k, 1)
                    for name, fn in launch.items()}

    if ctx.trace:
        prepare_ms = []
        with traced(cell["trace_requests"], dev) as t:
            for j in range(cell["trace_requests"] + 1):
                request(k + j, prepare_ms if j else [])
                t.tick()
        rec.trace = t.trace
        rec.spans_ms["prepare"] = prepare_ms
    rec.memory_peak_bytes = harness.peak(dev)
    del pipe
    harness.free(dev)

    _compare(ctx, rec, pool, head_scale, outputs)
    return rec


def _precision(ctx) -> dict:
    """The pipeline's precision options: its defaults, or for the variant
    ``program_int4`` (readings only) the program's own 4-bit path switched
    on as wide as it goes: every block's output but the last at 4 bits
    and the 4-bit bank."""
    if ctx.variant != "program_int4":
        return {}
    from portbench.reference.model import blocks

    names = [f"{b[0]}.out" for b in blocks(ctx.cfg["num_layers"])][:-1]
    return {"act4": tuple(names), "agg_w4": bool(ctx.cfg["aggre"])}


def control(ctx: harness.Context) -> harness.Record:
    """The cell's control: the plain reference put in the program's place
    and computed in the precisions below the configuration's (``control``:
    the model in int4, every tensor the reference's ``cast`` reaches at 4
    bits with one scale a tensor; the triangulation in bfloat16),
    one request of each pool entry, held against the reference as the
    program's requests are. No window."""
    import torch

    from portbench.reference import model as M
    from portbench.reference import serve as R

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    if cell["control"] != {"model": "int4", "triangulation": "bfloat16"}:
        raise ValueError(f"unknown control {cell['control']!r}")
    rec = harness.Record(kind="serve", cfg=cfg, cell=cell)
    pool = traffic.serve_pool(cell, cfg, ctx.seed, dev)
    images = pool["images"]
    h, w = cfg["image_size"][1], cfg["image_size"][0]
    probe = traffic.normalise(images[0].reshape(-1, h, w, 3)[:1].to(dev))
    wts, head_scale = weights.make(cfg, ctx.seed, dev, probe)
    map_w = cfg["heatmap_size"][0]
    outputs = []
    with M.full_f32(), torch.no_grad():
        for i in range(cell["pool"]):
            x = traffic.normalise(images[i].to(dev))
            raw, fused, _ = M.forward(wts, x, cfg, train=False, cast=M.int4_cast)
            maps = M.route(raw, fused, pool["is_h36m"][i]).permute(0, 1, 4, 2, 3)
            coords, maxvals = R.decode(maps)
            preds = R.map_to_image(coords, pool["center"][i], pool["scale"][i], map_w)
            cams = {k: torch.from_numpy(pool["cams"][k][i]).to(dev)
                    for k in ("R", "T", "f", "c", "k", "p")}
            pts = R.triangulate(preds, cams, maxvals > 0, dtype=torch.bfloat16).float()
            out = torch.cat([preds.reshape(-1), maxvals.reshape(-1), pts.reshape(-1)])
            outputs.append((i, 0.0, out.cpu().numpy()))
    del wts
    harness.free(dev)
    rec.attempted = len(outputs)
    _compare(ctx, rec, pool, head_scale, outputs)
    return rec


def _compare(ctx, rec, pool, head_scale, outputs) -> None:
    """Hold a seeded sample of the finished requests against the plain
    reference; sets ``rec.compared`` and ``rec.correct``."""
    import torch

    from portbench.reference import model as M
    from portbench.reference import serve as R

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    g, v, j = cell["groups"], cell["views"], cfg["num_joints"]
    map_h, map_w = cfg["heatmap_size"][1], cfg["heatmap_size"][0]
    limits = cell["limits"]
    widest = {"joint_gap": 0.0, "maxval_rel": 0.0, "point_gap_mm": 0.0}
    joints, same = [], []
    if outputs:
        rng = np.random.default_rng([int(ctx.seed), 7])
        slowest = max(range(len(outputs)), key=lambda i: outputs[i][1])
        rest = [i for i in range(len(outputs)) if i != slowest]
        n = min(cell["sample_requests"], len(outputs)) - 1
        chosen = [slowest] + (sorted(rng.choice(rest, size=n, replace=False).tolist())
                              if n > 0 else [])
        wts, _ = weights.make(cfg, ctx.seed, dev, head_scale=head_scale)
        ref_maps = {}
        with M.full_f32():
            for c in chosen:
                k, _, out = outputs[c]
                i = k % cell["pool"]
                if i not in ref_maps:
                    with torch.no_grad():
                        x = traffic.normalise(pool["images"][i].to(dev))
                        raw, fused, _ = M.forward(wts, x, cfg, train=False)
                        routed = M.route(raw, fused, pool["is_h36m"][i])
                    ref_maps[i] = routed.permute(0, 1, 4, 2, 3).contiguous()  # [G, V, J, h, w]
                o = torch.from_numpy(out).to(dev)
                got = _gaps(R, ref_maps[i], o[:g * v * j * 2].reshape(g, v, j, 2),
                            o[g * v * j * 2:g * v * j * 3].reshape(g, v, j),
                            o[g * v * j * 3:].reshape(g, j, 3), pool, i, map_w, map_h)
                for name in widest:
                    widest[name] = max(widest[name], float(got[name].max()))
                joints.append(got["joint_gap"].flatten())
                same.append(got["same_pixel"].flatten())
        rec.counters.update(sampled=len(chosen),
                            same_pixel_share=float(torch.cat(same).float().mean()))
    got = {**widest, "joint_gap_mean": float(torch.cat(joints).mean()) if joints else 0.0}
    rec.compared = {name: (got[name], limits[name]) for name in limits}
    rec.correct = (bool(outputs) and rec.failed == 0
                   and all(val <= lim for val, lim in rec.compared.values()))


def _gaps(R, maps, preds, maxvals, pts, pool, i, map_w, map_h) -> dict:
    """One request's gaps against the reference's routed maps [G, V, J, h,
    w], a value for each joint (each point): ``joint_gap`` the reference's
    maximum less its value at the served pixel (a served maximum <= 0: the
    reference maximum above 0), over the map's range; ``maxval_rel`` the
    served maximum's distance from the reference's value there, over the
    larger of the map's |maximum| and range; ``point_gap_mm`` the served
    point's distance from the reference's triangulation of the served
    joints; ``same_pixel`` whether the served joint is the reference's."""
    import torch

    flat = maps.reshape(maps.shape[:3] + (-1,))
    top = flat.amax(dim=-1)
    span_ = (top - flat.amin(dim=-1)).clamp(min=1e-12)
    xy = R.image_to_map(preds, pool["center"][i], pool["scale"][i], map_w).round().long()
    px, py = xy[..., 0].clamp(0, map_w - 1), xy[..., 1].clamp(0, map_h - 1)
    at = torch.gather(flat, -1, (py * map_w + px)[..., None])[..., 0]
    seen = maxvals > 0
    served = torch.where(seen, at, top)
    cams = {k: torch.from_numpy(pool["cams"][k][i]).to(maps.device)
            for k in ("R", "T", "f", "c", "k", "p")}
    ref_pts = R.triangulate(preds, cams, seen)
    return {"joint_gap": torch.where(seen, top - at, top.clamp(min=0.0)) / span_,
            "maxval_rel": (maxvals - served).abs() / torch.maximum(top.abs(), span_),
            "point_gap_mm": (pts.double() - ref_pts).norm(dim=-1),
            "same_pixel": (flat.argmax(dim=-1) == py * map_w + px) & seen}
