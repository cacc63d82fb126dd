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


# ------------------------------------------------------------ B8b's block

# the identity bottlenecks of ResNet-50 and ResNet-152 (the same four shapes,
# more of them) at 256^2, 320^2 and 384^2 input: h (= w), Cin (= Cout), Cm
V2_SHAPES = [(size // stride, 4 * cm, cm) for size in (256, 320, 384)
             for stride, cm in ((4, 64), (8, 128), (16, 256), (32, 512))]
V2_ODD = [("5x7 Cm 32 imgs 3", 5, 7, 32, 32), ("10x16", 10, 16, 64, 32)]


def _v2_regions(plan, cm):
    """(name, start, end, used while) of each region csrc/resblock.cu lays out
    for ``plan``; ``used while``: the phases of a job that touch it (1-3:
    the convs, 0: all of them)."""
    stg = 2 * trb._V2_STAGING
    a_stage = plan.ips * plan.a_img
    regions = [("h1", 0, plan.h1, {1, 2}),
               ("staging", 0, stg, {3}),
               ("ring B", plan.off_ring_b, plan.off_ring_b + plan.stages * plan.ips * 128 * 64,
                {0}),
               ("ring A", plan.off_ring_a,
                plan.off_ring_a + plan.stages * a_stage + trb._V2_OVERREAD, {0}),
               ("h2", plan.off_h2, plan.off_h2 + plan.h2, {2, 3}),
               ("v1 v2", plan.off_pv, plan.off_pv + 16 * cm, {0}),
               ("mbarriers", plan.off_bar, plan.off_bar + 16 * plan.stages, {0})]
    if plan.ips == 2:
        regions.append(("zero image", plan.off_zero, plan.off_zero + 128 * 64, {0}))
    return regions


def _check_v2_plan(plan, h, w, cm):
    tile_h = trb.V2_FORMS[plan.form]
    assert plan.tile_h == tile_h
    assert plan.tiles_x * 8 >= w and plan.tiles_y * tile_h >= h
    assert plan.smem <= 232448 and plan.ips in (1, 2) and plan.stages >= 2
    assert plan.a_img % 1024 == 0 and plan.a_img >= 64 * (tile_h + 2) * 10
    assert plan.off_ring_b % 1024 == 0 and plan.off_ring_a % 1024 == 0  # 64-byte swizzle atoms
    assert plan.off_bar % 8 == 0 and plan.smem >= plan.off_bar + 16 * plan.stages
    regions = _v2_regions(plan, cm)
    for i, (na, a0, a1, ua) in enumerate(regions):
        assert 0 <= a0 <= a1 <= plan.smem, na
        for nb, b0, b1, ub in regions[i + 1:]:
            if (ua & ub) or 0 in ua or 0 in ub:  # in use at the same time: apart
                assert a1 <= b0 or b1 <= a0, (na, nb)


@pytest.mark.parametrize("h,c,cm", V2_SHAPES, ids=[f"{h}x{h} Cm {cm}" for h, _, cm in V2_SHAPES])
def test_plan_v2_fits_a_block(h, c, cm):
    """B8b's planner at every identity bottleneck of ResNet-50 and -152 at
    256^2, 320^2 and 384^2 input: the planned block and every form and ring
    it accepts fit 232,448 bytes with the regions in use at one time apart;
    a shape that fits nothing raises and names itself."""
    plan = trb.plan_v2(h, h, c, cm, c)
    assert plan.form == ("split" if h <= 8 else "tile")
    _check_v2_plan(plan, h, h, cm)
    assert plan == trb.plan_v2(h, h, c, cm, c)
    fitted = 0
    for form in trb.V2_FORMS:
        for ips in (1, 2):
            for stages in range(2, 9):
                try:
                    forced = trb.plan_v2(h, h, c, cm, c, form=form, stages=stages, ips=ips)
                except ValueError as e:
                    assert "shared memory" in str(e)
                    continue
                assert (forced.form, forced.stages, forced.ips) == (form, stages, ips)
                _check_v2_plan(forced, h, h, cm)
                fitted += 1
    assert fitted >= 3
    with pytest.raises(ValueError, match=f"{h}x{h} images at Cin {c}, Cm {cm}"):
        trb.plan_v2(h, h, c, cm, c, stages=40)


@pytest.mark.parametrize("name,h,w,c,cm", V2_ODD, ids=[o[0] for o in V2_ODD])
def test_plan_v2_odd_shapes(name, h, w, c, cm):
    """The card tests' odd shapes: a 5 x 7 image at Cm 32 (the batch in
    groups of three, which the plan does not depend on), a 10 x 16 image in
    16 x 8 tiles that overhang it; a form the kernel lacks and a channel
    count that fits no block raise."""
    plan = trb.plan_v2(h, w, c, cm, c)
    _check_v2_plan(plan, h, w, cm)
    assert (plan.ips, plan.stages) == trb.V2_RINGS[0]  # the deepest ring fits these
    with pytest.raises(ValueError, match="no form 'square'"):
        trb.plan_v2(h, w, c, cm, c, form="square")
    with pytest.raises(ValueError, match="shared memory"):
        trb.plan_v2(h, w, 16 * c, 64 * cm, 16 * c)


def v2_kernel_emulation(x, args, h, w, plan, pad="zero"):
    """One launch of csrc/resblock.cu's bottleneck_v2_kernel on the CPU, job by
    job as the kernel walks them: x's halo zero-filled outside the tensor
    (TMA's fill) as [halo pixel][channel] with rows of garbage past it (the
    last slice's overread); per warpgroup conv1 on two 64-row slices from its
    halo's first pixel, keeping its own pixels, h1 0 outside the image
    (``pad="bias"``: the requantised bias there instead, the trap); conv2's
    k32 instructions, each 32 channels of one tap read at the tap's constant
    offset in h1, into two accumulators (even and odd instructions), the
    steps of ``plan.ips`` images past an n-tile's last reading a zero image;
    conv3 on h2 plus the residual, stored where the tile lies inside the
    image. Split form: each warpgroup half the columns of every conv.
    Weights are read back from the stage images."""
    n, hw, cin = x.shape
    cm, cout = args["w1"].shape[0], args["w3"].shape[0]
    bn12 = 64 if cm <= 64 else 128
    k2 = -(-9 * cm // 64)
    w1 = trb.untile_weight(args["w1t"], cm, cin).long()
    w2img = trb.untile_weight(args["w2t"], cm, 64 * k2)  # K padded to whole images
    assert not w2img[:, 9 * cm:].any()  # a k32 past 9 Cm multiplies zeros
    w2 = w2img.long()
    w3 = trb.untile_weight(args["w3t"], cout, cm).long()
    tile_h = plan.tile_h
    hp = (tile_h + 2) * 10
    split = plan.form == "split"
    gen = torch.Generator().manual_seed(0)
    x4 = x.reshape(n, h, w, cin)
    out = torch.zeros(n, h, w, cout, dtype=torch.int8)
    for job in range(plan.tiles_x * plan.tiles_y * n):
        tile = job % (plan.tiles_x * plan.tiles_y)
        y0, x0 = tile // plan.tiles_x * tile_h, tile % plan.tiles_x * 8
        img = job // (plan.tiles_x * plan.tiles_y)
        rows = torch.randint(-127, 128, (hp + 128, cin), generator=gen, dtype=torch.int8).long()
        inside = torch.zeros(hp, dtype=torch.bool)
        for hr in range(tile_h + 2):
            for hc in range(10):
                y, xx = y0 - 1 + hr, x0 - 1 + hc
                inside[hr * 10 + hc] = 0 <= y < h and 0 <= xx < w
                rows[hr * 10 + hc] = x4[img, y, xx].long() if inside[hr * 10 + hc] else 0
        h1 = torch.full((hp, cm), -1, dtype=torch.int8)  # every pixel is written
        for wg in range(2):
            region0 = 0 if split else wg * 80  # in h1 and in the x rows
            own0 = 0 if split else wg * 100
            cols = (slice(wg * bn12 // 2, (wg + 1) * bn12 // 2) if split else slice(0, bn12))
            for nt in range(-(-cm // bn12)):
                o = torch.arange(nt * bn12, (nt + 1) * bn12)[cols]
                o = o[o < cm]
                acc = rows[region0:region0 + 128] @ w1[o].t()  # two 64-row slices
                for lp in range(100):
                    hpx = region0 + lp
                    if hpx < own0:
                        continue
                    if inside[hpx] or pad == "bias":
                        h1[hpx, o] = trb._requant(acc[lp], args["v1"][:, o])
                    else:
                        h1[hpx, o] = 0
        assert (h1 != -1).all()  # each halo pixel kept by exactly one warpgroup (ReLU: >= 0)
        h1l = h1.long()
        r = torch.arange(64)
        for wg in range(2 if not split else 1):
            centre = (0 if split else wg * 80) + 11
            px = centre + (r // 8) * 10 + r % 8
            acc2 = [torch.zeros(64, cm, dtype=torch.long) for _ in range(2)]
            for kk in range(0, 64 * k2, 32):
                kq = kk if kk < 9 * cm else 0
                tap, c = kq // cm, kq % cm
                off = (tap // 3 - 1) * 10 + tap % 3 - 1
                acc2[(kk // 32) % 2] += h1l[px + off, c:c + 32] @ w2[:, kk:kk + 32].t()
            h2 = trb._requant(acc2[0] + acc2[1], args["v2"])
            acc3 = h2.long() @ w3.t()
            for i in range(64):
                y = y0 + (i // 8 if split else 8 * wg + i // 8)
                xx = x0 + i % 8
                if y < h and xx < w:
                    res = x4[img, y, xx]
                    yv = acc3[i].float() * args["v3"][0] + args["v3"][1]
                    rv = res.float() * args["vr"][0] + args["vr"][1]
                    out[img, y, xx] = torch.clamp(torch.round(yv + rv), 0.0, 127.0).to(torch.int8)
    return out.reshape(n, hw, cout)


V2_EMULATED = [("8x8 split Cm 32", 2, 8, 8, 64, 32, "split"),
               ("8x8 split", 2, 8, 8, 64, 64, "split"), ("8x8 tile", 1, 8, 8, 64, 64, "tile"),
               ("5x7 Cm 32 split", 3, 5, 7, 32, 32, "split"),
               ("5x7 Cm 32 tile", 2, 5, 7, 32, 32, "tile"),
               ("12x12 tile", 1, 12, 12, 64, 96, "tile"), ("10x16 tile", 1, 10, 16, 64, 32, "tile"),
               ("6x5 Cm 96 split", 2, 6, 5, 96, 96, "split")]


@pytest.mark.parametrize("name,n,h,w,c,cm,form", V2_EMULATED, ids=[e[0] for e in V2_EMULATED])
def test_v2_kernel_emulation_equals_plain(name, n, h, w, c, cm, form):
    """B8b's tiling (the halo with h1 zeroed outside the image, the taps as
    offsets into h1's planes, the warpgroups splitting N at 8x8 or a 16 x 8
    tile, ragged 5x7 and 12x12 tiles, Cm = 32 and 96 where a 64-byte step
    spans two taps) gives the plain version's block, bit for bit."""
    _, _, x, _, args = _case(h * w + cm, n, h, w, c, cm, c, False)
    xt = torch.from_numpy(x)
    plan = trb.plan_v2(h, w, c, cm, c, form=form)
    ref = trb.bottleneck_v2_plain(xt, args, h=h, w=w, imgs=n)
    assert torch.equal(v2_kernel_emulation(xt, args, h, w, plan), ref)
    assert ref.float().std() > 1.0


@pytest.mark.parametrize("form", ["tile", "split"])
def test_v2_padding_is_zero_on_h1_not_requantised_bias(form):
    """The trap: conv2's zero padding is on h1. Writing the requantised bias
    (what conv1 gives a zero x pixel) at the halo pixels outside the image
    changes the block."""
    _, _, x, _, args = _case(7, 2, 8, 8, 64, 64, 64, False)
    xt = torch.from_numpy(x)
    plan = trb.plan_v2(8, 8, 64, 64, 64, form=form)
    ref = trb.bottleneck_v2_plain(xt, args, h=8, w=8, imgs=2)
    bias = trb._requant(torch.zeros(64, dtype=torch.int32), args["v1"])
    assert bias.any()  # the bias does not requantise to 0 everywhere
    assert not torch.equal(v2_kernel_emulation(xt, args, 8, 8, plan, pad="bias"), ref)


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
