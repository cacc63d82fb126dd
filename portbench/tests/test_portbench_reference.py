"""The plain reference against ``posetpu_torch`` at a tiny size on the CPU:
the forward and fusion, three training steps in float64, the decode with
its inverse affine, and the triangulation."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, traffic, weights
from portbench.reference import model as M
from portbench.reference import serve as R
from portbench.reference import train as T

from portbench_tiny import CPU, tiny_cfg


def program_model(cfg, wts, dtype=torch.float32):
    from posetpu_torch.models.multiview import get_multiview_pose_net

    model = get_multiview_pose_net(harness.program_config(cfg), dtype=dtype)
    harness.load_weights(model, wts)
    return model


@pytest.mark.parametrize("name, layers", [("r50_256_fusion", 18), ("r50_256_fusion", 50),
                                          ("r152_320_nofusion", 18)])
def test_forward_and_fusion_equal_the_program(name, layers):
    from posetpu_torch.core.inference import fuse_routing

    cfg = tiny_cfg(name, layers)
    x = torch.randn(2, 4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    wts, _ = weights.make(cfg, 5, CPU, x[0, :1])
    model = program_model(cfg, wts).eval()
    with torch.no_grad():
        raw_p, fused_p, _, _ = model(x)
        raw_r, fused_r, _ = M.forward(wts, x, cfg, train=False)
    torch.testing.assert_close(raw_r, raw_p, rtol=1e-5, atol=1e-5)
    if cfg["aggre"]:
        torch.testing.assert_close(fused_r, fused_p, rtol=1e-5, atol=1e-4)
        mask = torch.tensor([1.0, 0.0])
        routed_p = fuse_routing(raw_p.movedim(-1, 2), fused_p.movedim(-1, 2), mask)
        torch.testing.assert_close(M.route(raw_r, fused_r, mask).movedim(-1, 2), routed_p,
                                   rtol=1e-5, atol=1e-4)
    else:
        assert fused_r is None and fused_p is None


@pytest.mark.parametrize("name", ["r50_256_fusion", "r152_320_nofusion"])
def test_three_steps_in_float64_equal_the_program(name):
    """The program's step (its losses, Adam, BatchNorm's statistics) in
    float64 against the reference's. The program's heatmaps leave the model
    in float32, so the losses agree to 1e-6 and the first gradient (as
    Adam's first moment holds it) to 1e-6 of each leaf's norm; Adam turns a
    gradient element near 0 into a step of either sign, so each leaf's
    parameters after three steps agree to 1e-2 of the leaf's change, and the
    statistics, which steps 2 and 3 take from those parameters, to 1e-4."""
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_train_step

    cfg = tiny_cfg(name)
    cell = harness.load_json(harness.HERE / "workloads" / f"train.{name}.json")
    cell.update(groups=2, pool=3)
    batches = traffic.train_pool(cell, cfg, 9, CPU)
    batches = [{k: v.double() for k, v in b.items()} for b in batches]
    wts, _ = weights.make(cfg, 9, CPU, batches[0]["images"][0, :1].float())
    wts = {k: v.double() for k, v in wts.items()}
    pcfg = harness.program_config(cfg)
    model = program_model(cfg, wts, torch.float64).double()
    tx = make_optimizer(pcfg, steps_per_epoch=cell["steps_per_epoch"])
    state = init_train_state(model, tx, device=CPU)
    step = make_train_step(model, pcfg, tx, device=CPU)
    losses, maps = [], []
    hook = model.register_forward_hook(
        lambda mod, args, out: maps.extend(t for t in out[:2] if t is not None))
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            hook.remove()
            g1 = {n: state.opt_state["mu"][n] / 0.1 for n in state.opt_state["mu"]}
    ref = T.follow(wts, batches, cfg, cfg["lr"])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    assert len(maps) == len(ref["maps1"])
    for p, r in zip(maps, ref["maps1"]):
        assert float((p.detach() - r).norm()) <= 1e-6 * float(r.norm())
    for n, p in model.named_parameters():
        assert float((g1[n] - ref["grad1"][n]).norm()) <= 1e-6 * float(ref["grad1"][n].norm()), n
        moved = float((ref["params"][n] - wts[n]).norm())
        assert float((p.detach() - ref["params"][n]).norm()) <= 1e-2 * moved, n
    for n, b in model.named_buffers():
        if n in ref["stats"]:
            assert float((b - ref["stats"][n]).abs().max()) <= 1e-4 * float(
                ref["stats"][n].abs().max()), n


def test_decode_and_affine_equal_the_program():
    from posetpu_torch.core.inference import final_preds

    gen = torch.Generator().manual_seed(3)
    maps = torch.randn(2, 4, 16, 16, 16, generator=gen)
    maps[0, 0, 0] = -1.0  # a map with no joint
    maps[1, 2, 3, 5, 6] = maps[1, 2, 3].max() + 1.0  # a peak by the edge
    center = 500 + 100 * torch.rand(2, 4, 2, generator=gen)
    scale = (2 + torch.rand(2, 4, 1, generator=gen)).expand(2, 4, 2)
    preds_p, max_p = final_preds(maps, center, scale)
    coords, max_r = R.decode(maps)
    torch.testing.assert_close(R.map_to_image(coords, center, scale, 16), preds_p,
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(max_r, max_p)
    back = R.image_to_map(preds_p, center, scale, 16)
    torch.testing.assert_close(back, coords, rtol=0, atol=1e-3)


def test_triangulation_equals_the_program_in_float64():
    from posetpu_torch.geometry.cameras import CameraParams
    from posetpu_torch.geometry.triangulate import triangulate_points

    cell = harness.load_json(harness.HERE / "workloads" / "serve.r50_256_fusion.json")
    rings = traffic.camera_rings(cell["camera"], 3, 2**40 + 3, 2)
    gen = torch.Generator().manual_seed(4)
    pix = 300 + 400 * torch.rand(3, 4, 16, 2, generator=gen, dtype=torch.float64)
    seen = torch.rand(3, 4, 16, generator=gen) > 0.3
    cams = {k: torch.from_numpy(v) for k, v in rings.items()}
    got = triangulate_points(pix, CameraParams(*(cams[k].double() for k in
                                                  ("R", "T", "f", "c", "k", "p"))),
                             seen.double())
    want = R.triangulate(pix, cams, seen)
    torch.testing.assert_close(got, want, rtol=1e-7, atol=1e-6)
    assert bool((want[seen.sum(1) < 2] == 0).all())
