"""posetpu_torch.ops.resblock (B8a, B8b) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, the kernel arguments
carried across by models/convert.from_jax_params.

On the CPU each wrapper runs its kernel's plain version, so these tests pin
the arithmetic the CUDA kernels must reproduce (the kernels themselves are
held against the plain versions on the card: tests/test_torch_cuda.py and
chip_smoke.py).

Tolerance: the int8 outputs are equal. XLA on the CPU may contract an
epilogue's ``acc * scale + bias`` into one FMA where the port rounds the
multiply and the add separately; an element may then differ by one int8
step, on at most 1e-3 of a block's elements, and every such element must be
the value the once-rounded epilogues give (:func:`fma_block`)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.ops.pallas import resblock as jrb  # noqa: E402
from posetpu_torch.models.convert import from_jax_params  # noqa: E402
from posetpu_torch.ops import resblock as trb  # noqa: E402
from tests.test_pallas_resblock import _mk_qparams  # noqa: E402


def _case(seed, n, h, w, cin, cm, cout, with_ds):
    rng = np.random.default_rng(seed)
    name = "layer1_0" if with_ds else "layer1_1"
    qp = _mk_qparams(rng, name, cin, cm, cout, with_ds)
    x = rng.integers(-127, 128, size=(n, h * w, cin)).astype(np.int8)
    jargs = jrb.build_bottleneck_args(qp, name, 0.025)
    args = from_jax_params({"fused": {name: jax.tree.map(np.asarray, jargs)}},
                           "cpu")["fused"][name]
    return qp, name, x, jargs, args


def fma_block(x, args, h, w):
    """The block with every ``acc * scale + bias`` rounded once (exact in
    f64 at these magnitudes, then one f32 rounding), the residual add as
    written."""
    n, hw, cin = x.shape
    cm = args["w1"].shape[0]
    mm = lambda a, b: (a.long() @ b.long().t()).double()
    fma = lambda acc, v: (acc * v[0].double() + v[1].double()).float()
    rq = lambda acc, v, lo=0.0: torch.clamp(torch.round(fma(acc, v)), lo, 127.0).to(torch.int8)
    x2 = x.reshape(n * hw, cin)
    h1 = rq(mm(x2, args["w1"]), args["v1"])
    patches = torch.cat(trb._taps(h1.reshape(n, h, w, cm)), dim=1)
    h2 = rq(mm(patches, args["w2"]), args["v2"])
    y = fma(mm(h2, args["w3"]), args["v3"])
    res = rq(mm(x2, args["wd"]), args["vd"], -127.0) if "wd" in args else x2
    r = fma(res.double(), args["vr"])
    return torch.clamp(torch.round(y + r), 0.0, 127.0).to(torch.int8).reshape(n, hw, -1)


def assert_block_equal(got, ref, x, args, h, w):
    got, ref = got.numpy().astype(np.int32), np.asarray(ref).astype(np.int32)
    assert got.shape == ref.shape and got.std() > 1.0
    differ = got != ref
    if differ.any():
        assert np.abs(got - ref).max() <= 1 and differ.mean() < 1e-3
        once = fma_block(torch.from_numpy(x), args, h, w).numpy().astype(np.int32)
        np.testing.assert_array_equal(ref[differ], once[differ])


@pytest.mark.parametrize("with_ds,h,w", [(False, 8, 8), (True, 8, 8),
                                         (False, 6, 10), (True, 5, 7)])
def test_fused_bottleneck_matches_jax_kernel(with_ds, h, w):
    """B8a, identity and projection residual, square and non-square."""
    _, _, x, jargs, args = _case(0, 2, h, w, 64, 32, 64, with_ds)
    ref = jrb.fused_bottleneck(jnp.asarray(x), jargs, h=h, w=w, interpret=True)
    got = trb.fused_bottleneck(torch.from_numpy(x), args, h=h, w=w)
    assert got.dtype == torch.int8
    assert_block_equal(got, ref, x, args, h, w)


@pytest.mark.parametrize("h,w", [(8, 8), (6, 10)])
def test_fused_bottleneck_v2_matches_jax_kernel(h, w):
    """B8b at imgs=2 against its JAX kernel, and equal to B8a's plain version."""
    _, _, x, jargs, args = _case(1, 4, h, w, 64, 32, 64, False)
    ref = jrb.fused_bottleneck_v2(jnp.asarray(x), jargs, h=h, w=w, imgs=2,
                                  interpret=True)
    xt = torch.from_numpy(x)
    got = trb.fused_bottleneck_v2(xt, args, h=h, w=w, imgs=2)
    assert_block_equal(got, ref, x, args, h, w)
    assert torch.equal(got, trb.fused_bottleneck(xt, args, h=h, w=w))


def test_v2_refuses_projection_and_ragged_batches():
    _, _, x, _, args = _case(2, 3, 4, 4, 64, 32, 64, False)
    with pytest.raises(ValueError):
        trb.fused_bottleneck_v2(torch.from_numpy(x), args, h=4, w=4, imgs=2)
    _, _, x, _, args = _case(2, 2, 4, 4, 64, 32, 64, True)
    with pytest.raises(ValueError):
        trb.fused_bottleneck_v2(torch.from_numpy(x), args, h=4, w=4, imgs=2)


@pytest.mark.parametrize("with_ds", [False, True])
def test_build_bottleneck_args_match_jax(with_ds):
    """``build_bottleneck_args`` fed the same qparams gives the JAX function's
    arrays bit for bit; the kernels' layout is their K-minor transpose."""
    qp, name, _, jargs, dev = _case(3, 1, 4, 4, 64, 32, 96, with_ds)
    got = trb.build_bottleneck_args(jax.tree.map(np.asarray, qp), name, 0.025)
    assert set(got) == set(jargs)
    tiled = {"w1t", "w2t", "w3t"} | ({"wdt"} if with_ds else set())
    assert set(dev) == set(jargs) | tiled  # B8a's stage images beside the K-minor weights
    for k in tiled:
        n, kk = dev[k[:-1]].shape
        assert torch.equal(trb.untile_weight(dev[k], n, kk), dev[k[:-1]]), k
    for k, ref in jargs.items():
        ref = np.asarray(ref)
        assert got[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
        d = dev[k].numpy()
        if k == "w2":
            d = d.T.reshape(9, 32, 32)
        elif k.startswith("w"):
            d = d.T
        np.testing.assert_array_equal(d, ref, err_msg=k)


# ------------------------------------------------------------ B8a's block shapes

# ResNet-50's 13 stride-1 bottlenecks at 256x256 input: h, w, Cin, Cm, Cout, projection
R50_BLOCKS = ([("layer1_0", 64, 64, 64, 64, 256, True)]
              + [(f"layer1_{i}", 64, 64, 256, 64, 256, False) for i in (1, 2)]
              + [(f"layer2_{i}", 32, 32, 512, 128, 512, False) for i in (1, 2, 3)]
              + [(f"layer3_{i}", 16, 16, 1024, 256, 1024, False) for i in (1, 2, 3, 4, 5)]
              + [(f"layer4_{i}", 8, 8, 2048, 512, 2048, False) for i in (1, 2)])
SMALL_BLOCKS = [("8x8", 8, 8, 64, 32, 64, False), ("8x8 ds", 8, 8, 64, 32, 64, True),
                ("5x7", 5, 7, 96, 32, 96, False), ("7x5 ds", 7, 5, 32, 64, 72, True),
                ("10x32", 10, 32, 64, 32, 64, False), ("4x4", 4, 4, 64, 32, 96, True)]


def _check_plan(plan, h, w, cin, cm, has_wd):
    """The regions the kernel lays out (csrc/resblock.cu) fit the plan's
    offsets, in order, inside a block's shared memory."""
    ld = cm + 16
    h1, h2 = (plan.th + 2) * (w + 2) * ld, plan.th * w * ld
    assert 1 <= plan.th <= h and plan.ns in (2, 3)
    assert plan.smem <= 232448  # B8a's kernel has no static shared memory
    assert plan.off_h2 >= max(h1, plan.ns * trb._S_BYTES)
    ring = trb.RING_STAGES * 128 * trb.RING_K
    if has_wd:   # the A ring is its own region behind h2
        assert plan.off_ring_a >= plan.off_h2 + h2
        assert plan.off_ring_b >= plan.off_ring_a + ring
    else:        # the A ring lies over h2
        assert plan.off_ring_a == plan.off_h2
        assert plan.off_ring_b >= plan.off_h2 + max(h2, ring)
    assert plan.off_ring_b % 1024 == 0 and plan.off_ring_a % 1024 == 0
    assert plan.off_pv >= plan.off_ring_b + ring and plan.off_pv % 16 == 0
    assert plan.off_bar >= plan.off_pv + 16 * cm and plan.off_bar % 8 == 0
    assert plan.smem >= plan.off_bar + 8 * trb.RING_STAGES
    assert plan.blocks_per_sm == 233472 // (plan.smem + 1024)


@pytest.mark.parametrize("name,h,w,cin,cm,cout,has_wd", R50_BLOCKS + SMALL_BLOCKS,
                         ids=[b[0] for b in R50_BLOCKS + SMALL_BLOCKS])
def test_plan_rows_fits_a_block(name, h, w, cin, cm, cout, has_wd):
    """The planner is a pure function of the layer's shapes: a shape within a
    block's 232,448 bytes, th >= 1, regions in the kernel's order."""
    plan = trb.plan_rows(h, w, cin, cm, cout, has_wd)
    _check_plan(plan, h, w, cin, cm, has_wd)
    assert plan == trb.plan_rows(h, w, cin, cm, cout, has_wd)
    for th in range(1, h + 1):  # every height asked for by hand: fits or raises
        try:
            forced = trb.plan_rows(h, w, cin, cm, cout, has_wd, th)
        except ValueError:
            continue
        assert forced.th == th
        _check_plan(forced, h, w, cin, cm, has_wd)


def test_plan_rows_measured_heights():
    """The heights the H100 sweep chose at ResNet-50's shapes (PERF.md): full
    128-row tiles and two blocks to an SM where both can be had."""
    got = {name: trb.plan_rows(h, w, cin, cm, cout, wd)
           for name, h, w, cin, cm, cout, wd in R50_BLOCKS}
    assert [got[n].th for n in ("layer1_0", "layer1_1", "layer2_1", "layer3_1", "layer4_1")] \
        == [4, 4, 8, 8, 8]
    assert all(got[n].blocks_per_sm >= 2 for n in got if not n.startswith("layer4"))
    assert got["layer1_1"].ns == 3 and got["layer3_1"].ns == 2  # one-step conv3 tiles run two ahead


@pytest.mark.parametrize("h,w,cm", [(8, 4000, 64), (4, 1500, 512), (2, 700, 2048)])
def test_plan_rows_raises_where_a_row_does_not_fit(h, w, cm):
    with pytest.raises(ValueError, match="shared memory"):
        trb.plan_rows(h, w, cm, cm, cm, False)
    with pytest.raises(ValueError):
        trb.plan_rows(h, w, cm, cm, cm, False, 1)


def test_plan_rows_refuses_heights_outside_the_image():
    for th in (0, 9):
        with pytest.raises(ValueError):
            trb.plan_rows(8, 8, 64, 32, 64, False, th)


@pytest.mark.parametrize("h,w,cm,imgs", [(64, 64, 64, 2), (32, 32, 128, 2), (16, 16, 256, 2),
                                         (8, 8, 512, 2), (5, 7, 32, 3)])
def test_plan_im2col_fits_beside_the_static_share(h, w, cm, imgs):
    """B8b's planner: within 232,448 bytes less the kernel's static share,
    the chunk a divisor of 9 Cm."""
    static = 36864
    plan = trb.plan_im2col(h, w, cm, imgs, static)
    assert plan.th >= 1 and (9 * cm) % plan.kch == 0 and plan.kch % 32 == 0
    assert plan.smem == trb._im2col_bytes(plan.th, imgs, w, cm, plan.kch) <= 232448 - static
    with pytest.raises(ValueError):
        trb.plan_im2col(h, 40 * w, 8 * cm, imgs, static)


@pytest.mark.parametrize("n,k,bn", [(64, 64, 64), (64, 576, 64), (96, 160, 128), (32, 288, 64),
                                    (256, 64, 128), (40, 96, 128)])
def test_tile_weight_layout_and_round_trip(n, k, bn):
    """A stage image holds rows nt*bn.. at depth ks*64.., row r's 16-byte
    chunk c at place c ^ ((r >> 1) & 3), zeros beyond the matrix."""
    gen = torch.Generator().manual_seed(n + k)
    wk = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    img = trb.tile_weight(wk, bn)
    assert img.shape == (-(-n // bn), -(-k // 64), bn, 64) and img.is_contiguous()
    assert torch.equal(trb.untile_weight(img, n, k), wk)
    pad = torch.zeros(img.shape[0] * bn, img.shape[1] * 64, dtype=torch.int8)
    pad[:n, :k] = wk
    for r, c, ks in [(0, 0, 0), (2, 1, 0), (5, 3, img.shape[1] - 1), (bn - 1, 2, 0), (n - 1, 0, 0)]:
        nt, rr = divmod(r, bn)
        place = c ^ ((rr >> 1) & 3)
        assert torch.equal(img[nt, ks, rr, 16 * place:16 * place + 16],
                           pad[r, 64 * ks + 16 * c:64 * ks + 16 * c + 16])


def rows_kernel_emulation(x, args, h, w, th):
    """B8a's tile geometry in PyTorch (csrc/resblock.cu): per image and row
    tile, conv1 on the halo rows into an h1 with one zero column left and
    right of every row (rows outside the image stay zero), conv2 as nine taps
    that are constant offsets in that padded h1, conv3 + residual on the
    tile's rows; the weights read back from the stage images."""
    n, hw, cin = x.shape
    cm, cout = args["w1"].shape[0], args["w3"].shape[0]
    w1 = trb.untile_weight(args["w1t"], cm, cin)
    w2 = trb.untile_weight(args["w2t"], cm, 9 * cm).reshape(cm, 9, cm)
    tail = dict(args, w3=trb.untile_weight(args["w3t"], cout, cm))
    if "wd" in args:
        tail["wd"] = trb.untile_weight(args["wdt"], cout, cin)
    wp = w + 2
    out = torch.empty(n, hw, cout, dtype=torch.int8)
    for img in range(n):
        for r0 in range(0, h, th):
            rows = min(th, h - r0)
            h1 = torch.zeros((rows + 2) * wp, cm, dtype=torch.int8)
            for lr in range(rows + 2):
                r = r0 - 1 + lr
                if 0 <= r < h:
                    xr = x[img, r * w:(r + 1) * w]
                    h1[lr * wp + 1:lr * wp + 1 + w] = trb._requant(
                        trb.int_mm(xr, w1.t()), args["v1"])
            m = torch.arange(rows * w)
            centre = (m // w + 1) * wp + m % w + 1
            acc = torch.zeros(rows * w, cm, dtype=torch.int32)
            for t, (dy, dx) in enumerate(trb._TAPS):
                acc += trb.int_mm(h1[centre + dy * wp + dx], w2[:, t].t())
            h2 = trb._requant(acc, args["v2"])
            xo = x[img, r0 * w:(r0 + rows) * w]
            out[img, r0 * w:(r0 + rows) * w] = trb._block_tail(xo, h2, tail)
    return out


@pytest.mark.parametrize("h,w,th,with_ds", [(7, 6, 3, False), (7, 6, 3, True), (5, 7, 2, False),
                                            (9, 8, 4, True), (6, 9, 4, False), (10, 10, 3, True),
                                            (4, 10, 4, False), (8, 7, 5, True), (3, 6, 1, False)])
def test_row_tiles_with_padded_halo_equal_plain(h, w, th, with_ds):
    """The tile geometry (row tiles, recomputed halo rows, padded columns,
    tiled weights) gives the plain version's block, also where h is no
    multiple of th."""
    cin, cm, cout = (64, 32, 96) if with_ds else (64, 32, 64)
    _, _, x, _, args = _case(h * w + th, 2, h, w, cin, cm, cout, with_ds)
    xt = torch.from_numpy(x)
    ref = trb.bottleneck_plain(xt, args, h=h, w=w)
    assert torch.equal(rows_kernel_emulation(xt, args, h, w, th), ref)
    assert ref.float().std() > 1.0
