"""posetpu_torch.ops.phase_tail (B1, B2, B5) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs.

On the CPU each wrapper runs its kernel's plain version, so these tests pin
the arithmetic the CUDA kernels must reproduce (the kernels themselves are
held against the plain versions on the card: tests/test_torch_cuda.py and
chip_smoke.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.ops.pallas import phase_tail as jpt  # noqa: E402
from posetpu_torch.ops import phase_tail as tpt  # noqa: E402
from posetpu_torch.ops import resblock as trb  # noqa: E402


def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _scales(rng, *shape, lo=5e-4, hi=2e-3):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _subpix_args(rng, cin, cout):
    return {"w": _i8(rng, 4, 4, cin, cout), "sv": _scales(rng, 4, cout),
            "bv": rng.uniform(-20, 20, (4, cout)).astype(np.float32),
            "so": np.asarray([[0.37]], np.float32)}


def _tail2_args(rng, c, joints):
    return {"w1": _i8(rng, 4, 4, c, c), "w2": _i8(rng, 4, 4, c, c),
            "s1": np.stack([_scales(rng, c, lo=2e-3, hi=8e-3),
                            rng.uniform(-20, 20, c).astype(np.float32)]),
            "s2": np.stack([_scales(rng, c, lo=2e-3, hi=8e-3),
                            rng.uniform(-20, 20, c).astype(np.float32)]),
            "so1": np.asarray([[0.91]], np.float32),
            "so2": np.asarray([[1.13]], np.float32),
            "wh": _i8(rng, c, joints),
            "vh": np.stack([_scales(rng, joints, lo=1e-4, hi=1e-3),
                            rng.uniform(-1, 1, joints).astype(np.float32)])}


def test_subpixel_deconv_matches_jax_kernel(rng):
    """B2 at Cin 64, Cout 32, 4x4, a ragged batch of 3: int8-equal."""
    h = w = 4
    x = _i8(rng, 3, h * w, 64)
    args = _subpix_args(rng, 64, 32)
    ref = jpt.fused_subpixel_deconv_batched(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in args.items()},
        h=h, w=w, interpret=True)
    got = tpt.fused_subpixel_deconv_batched(
        torch.from_numpy(x), tpt.subpixel_device_args(args, "cpu"), h=h, w=w)
    assert got.dtype == torch.int8 and tuple(got.shape) == (4, 3, h, w, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) > 50  # the requant range is exercised


def test_phase_tail2_matches_jax_kernel(rng):
    """B1 at a 4x4 input, C 32, J 4: f32 heatmaps in the levels=2 packed
    order, equal except where XLA on the CPU contracted the head's f32
    epilogue ``acc * scale + bias`` into one FMA. The port rounds the
    multiply and the add separately (the kernel's epilogue as written); at
    every element that differs, the JAX value is exactly the FMA-rounded
    one, and the two differ by at most one rounding of the product (1 ulp
    of ``acc * scale``) plus one of the result."""
    h = w = 4
    x = _i8(rng, 2, h * w, 32)
    args = _tail2_args(rng, 32, 4)
    ref = np.asarray(jpt.fused_phase_tail2(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in args.items()},
        h=h, w=w, interpret=True))
    dev = tpt.tail2_device_args(args, "cpu")
    got = tpt.fused_phase_tail2(torch.from_numpy(x), dev, h=h, w=w).numpy()
    assert got.shape == (4, 2, 16 * h * w) and np.std(got) > 0

    # the head's exact int32 sums, from the port's own deconv2 phase maps
    xt = torch.from_numpy(x).reshape(2, h, w, 32)
    z1 = tpt._phase_conv_plain(xt, dev["w1"], dev["s1"][0], dev["s1"][1],
                               dev["so1"], interleave=True)
    z2 = tpt._phase_conv_plain(z1, dev["w2"], dev["s2"][0], dev["s2"][1],
                               dev["so2"], interleave=False)
    zp = z2.reshape(4, 2, 2 * h // 2, 2, 2 * w // 2, 2, 32).permute(1, 0, 3, 5, 2, 4, 6)
    acc = (zp.reshape(-1, 32).long() @ dev["wh"].t().long()).numpy()
    vh = args["vh"].astype(np.float64)
    fma = (acc * vh[0] + vh[1]).astype(np.float32)  # one rounding
    fma = fma.reshape(2, 16 * h * w, 4).transpose(2, 0, 1)
    prod = (acc.astype(np.float32) * args["vh"][0]).reshape(2, 16 * h * w, 4)
    bound = np.spacing(np.abs(prod.transpose(2, 0, 1))) + np.spacing(np.abs(ref))

    differ = got != ref
    np.testing.assert_array_equal(ref[differ], fma[differ])
    assert (np.abs(got - ref)[differ] <= bound[differ]).all()


def _qparams(rng, cin=64, c=32, joints=4):
    return {
        "weights": {"deconv0": _i8(rng, 2, 2, cin, 4 * c),
                    "deconv1": _i8(rng, 4, 4, c, c),
                    "deconv2": _i8(rng, 4, 4, c, c),
                    "final": _i8(rng, 1, 1, c, joints)},
        "w_scales": {"deconv0": _scales(rng, 4 * c), "deconv1": _scales(rng, c),
                     "deconv2": _scales(rng, c), "final": _scales(rng, joints)},
        "biases": {k: rng.randn(n).astype(np.float32)
                   for k, n in (("deconv0", c), ("deconv1", c),
                                ("deconv2", c), ("final", joints))},
        "act_scales": {f"deconv{i}.out": np.float32(rng.uniform(0.01, 0.1))
                       for i in range(3)},
    }


@pytest.mark.parametrize("which", ["subpixel", "tail2"])
def test_args_builders_match_jax(rng, which):
    """The argument builders fed the same qparams give the JAX builders'
    arrays exactly; the kernels' device layout is their K-minor transpose."""
    q = _qparams(rng)
    if which == "subpixel":
        ref = jpt.build_subpixel_deconv_args(q, "deconv0", 0.0123)
        got = tpt.build_subpixel_deconv_args(q, "deconv0", 0.0123)
        dev = tpt.subpixel_device_args(got, "cpu")
        k_minor = ("w",)
    else:
        ref = jpt.build_phase_tail2_args(q, "deconv1", "deconv2", 0.0123)
        got = tpt.build_phase_tail2_args(q, "deconv1", "deconv2", 0.0123)
        dev = tpt.tail2_device_args(got, "cpu")
        k_minor = ("w1", "w2", "wh")
    # the device args also carry B1's stage images and padded head, B2's
    # stage images and per-phase vectors
    assert set(got) == set(ref) == set(dev) - {"w1t", "w2t", "wht", "wt", "svb"}
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        d = dev[k].numpy()
        np.testing.assert_array_equal(np.swapaxes(d, -1, -2) if k in k_minor else d,
                                      np.asarray(ref[k]), err_msg=k)


# ------------------------------------------------------------ B1's kernel design


@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 136), (256, 256)])
def test_tail2_stage_images_untile_to_the_weights(rng, cin, cout):
    """tail2_device_args' stage images hold w1 and w2 exactly: phase g's
    [Cout, 4 Cin] matrix, zero past Cout, and the padded head holds wh."""
    args = {"w1": _i8(rng, 4, 4, cin, cin), "w2": _i8(rng, 4, 4, cin, cout),
            "s1": np.zeros((2, cin), np.float32), "s2": np.zeros((2, cout), np.float32),
            "so1": np.ones((1, 1), np.float32), "so2": np.ones((1, 1), np.float32),
            "wh": _i8(rng, cout, 17), "vh": np.zeros((2, 17), np.float32)}
    dev = tpt.tail2_device_args(args, "cpu")
    for key, n_out in (("w1", cin), ("w2", cout)):
        img = dev[f"{key}t"]
        nh = -(-n_out // 128)
        assert tuple(img.shape) == (4, nh, 4 * cin // 64, 128, 64) and img.dtype == torch.int8
        for g in range(4):
            full = trb.untile_weight(img[g], nh * 128, 4 * cin)
            assert not full[n_out:].any()
            np.testing.assert_array_equal(
                full[:n_out].reshape(n_out, 4, cin).permute(1, 0, 2).numpy(),
                dev[key][g].numpy())
    assert tuple(dev["wht"].shape) == (32, -(-cout // 128) * 128)
    np.testing.assert_array_equal(dev["wht"][:17, :cout].numpy(), dev["wh"].numpy())
    assert not dev["wht"][17:].any() and not dev["wht"][:, cout:].any()


@pytest.mark.parametrize("h,w,cin,jt", [(16, 16, 256, 0), (32, 32, 256, 2), (4, 4, 32, 0),
                                        (8, 8, 32, 2), (6, 10, 64, 2), (12, 20, 64, 4),
                                        (2, 26, 32, 0)])
def test_plan_tail2_covers_every_pixel_once(h, w, cin, jt):
    """The planner's 16 x 8 tiles cover the h x w grid, every pixel exactly
    once and no tile wholly outside it, and the regions fit a block without
    overlapping."""
    plan = tpt.plan_tail2(h, w, cin, 256, jt)
    th, tw = tpt.TAIL2_TILE
    assert plan.smem <= 232448
    assert 0 < plan.off_ring < plan.off_z < plan.off_wh <= plan.off_sc < plan.off_bar < plan.smem
    count = np.zeros((plan.tiles_y * th, plan.tiles_x * tw), np.int32)
    for y0, x0 in tpt.tail2_tiles(plan):
        count[y0:y0 + th, x0:x0 + tw] += 1
    assert (count == 1).all()
    assert plan.tiles_y * th - th < h and plan.tiles_x * tw - tw < w


def test_plan_tail2_serving_shapes():
    """At the serving shapes both launches take the measured ring (two
    stages of 128 bytes of K) and leave room for two blocks on an SM;
    deconv2 is 8 blocks an image (1 GB of weight reads over 128 images)."""
    for h, jt, blocks in ((16, 0, 2), (32, 2, 8)):
        plan = tpt.plan_tail2(h, h, 256, 256, jt)
        assert plan.stages == 2
        assert plan.tiles_x * plan.tiles_y == blocks and plan.smem <= 113 * 1024
    with pytest.raises(ValueError):
        tpt.plan_tail2(16, 16, 2048, 256, 2)   # the halo does not fit
    with pytest.raises(ValueError):
        tpt.plan_tail2(16, 16, 256, 256, 2, stages=1)


@pytest.mark.parametrize("n,sets", [(128, 4), (256, 8), (64, 2), (300, 8), (3, 1)])
def test_plan_tail2_b2_instance_fits_one_block(n, sets):
    """B2's instance at deconv0's (8, 8, 2048, 256): the streamed halo's
    8 x 8 tile covers the grid in one tile, its ring of STREAM_STAGES and the
    per-phase vectors fit a block's shared memory, one block an SM; the
    pairs a block are the fewest that leave one wave on the H100's 132 SMs
    (4 at path 1's 128 images, 8 at path 2's 256), all eight where no
    choice does."""
    assert tpt.stream_sets(n, 8, 8, 256, 132) == sets
    plan = tpt.plan_tail2(8, 8, 2048, 256, 0, tpt.STREAM_STAGES, design=tpt.STREAM_DESIGN,
                          folded=True, sets=sets)
    assert (plan.tiles_x, plan.tiles_y, plan.sets, plan.stages) == (1, 1, sets, 7)
    assert 232448 // 2 < plan.smem <= 232448
    blocks = -(-n // 2) * (8 // sets)
    assert blocks <= 132 or sets == 8
    with pytest.raises(ValueError):  # no head after the streamed halo
        tpt.plan_tail2(8, 8, 2048, 256, 2, design=tpt.STREAM_DESIGN, folded=True)


def _requant(acc, s, b, inv_so):
    return torch.clamp(torch.round(torch.relu(acc.float() * s + b) * inv_so), -127, 127
                       ).to(torch.int8)


def tail2_kernel_emulation(x4, wt, sc, so, wh=None, vh=None, store="head_packed2"):
    """One launch of csrc/tail2.cu on the CPU, block by block as the kernel
    walks it: the planned tile and its zero-padded halo, the flat k-steps
    (phase, n-half, 64-byte stage) with each 32-byte step's A rows at the
    tap's constant offset into the halo and its B rows read through the
    stage images' swizzle, the half requantised (zeros past Cout), then
    z1 stored interleaved, or the head summed half by half and stored in
    the levels=2 packed order (B1), or with ``store="head_packed1"`` in the
    levels=1 order, column g h w + y w + x (B5)."""
    n, h, w, cin = x4.shape
    nh, cout = wt.shape[1], sc.shape[-1]
    joints = 0 if wh is None else vh.shape[-1]
    jt = 0 if wh is None else (2 if joints <= 16 else 4)
    plan = tpt.plan_tail2(h, w, cin, cout, jt)
    th, tw = tpt.TAIL2_TILE
    rows = th * tw
    ty, tx = np.arange(rows) // tw, np.arange(rows) % tw
    inv_so = 1.0 / so.reshape(())
    sv = torch.zeros(2, nh * 128)
    sv[:, :cout] = sc
    # stage image row r keeps its logical 16-byte chunk c at c ^ ((r >> 1) & 3)
    swz = np.arange(4)[None, :] ^ ((np.arange(128)[:, None] >> 1) & 3)
    phys = torch.from_numpy((swz[:, :, None] * 16 + np.arange(16)).reshape(128, 64))
    if wh is None:
        out = torch.zeros(n, 2 * h, 2 * w, cout, dtype=torch.int8)
    else:
        out = torch.full((joints, n, 4 * h * w), float("nan"))
    for img in range(n):
        for y0, x0 in tpt.tail2_tiles(plan):
            halo = torch.zeros(th + 2, tw + 2, cin, dtype=torch.int8)
            ys, xs = slice(max(y0 - 1, 0), min(y0 + th + 1, h)), \
                slice(max(x0 - 1, 0), min(x0 + tw + 1, w))
            halo[ys.start - y0 + 1:ys.stop - y0 + 1, xs.start - x0 + 1:xs.stop - x0 + 1] = \
                x4[img, ys, xs]
            y, x = y0 + ty, x0 + tx
            inside = (y < h) & (x < w)
            q = 0
            for g in range(4):
                a, b = g >> 1, g & 1
                hacc = torch.zeros(rows, 8 * jt, dtype=torch.float64)
                for half in range(nh):
                    acc = torch.zeros(rows, 128, dtype=torch.float64)
                    tap, c = 0, 0
                    for _ in range(4 * cin // 64):
                        img_b = wt.reshape(-1, 128, 64)[q]
                        for s in range(2):
                            sr, sc_ = (tap >> 1) - 1 + a, (tap & 1) - 1 + b
                            arows = halo[ty + 1 + sr, tx + 1 + sc_, c:c + 32]
                            brows = torch.gather(img_b, 1, phys[:, 32 * s:32 * s + 32].long())
                            acc += arows.double() @ brows.double().t()
                            c += 32
                            if c == cin:
                                c, tap = 0, tap + 1
                        q += 1
                    cols = slice(half * 128, half * 128 + 128)
                    z = _requant(acc.round().to(torch.int32), sv[0, cols], sv[1, cols], inv_so)
                    z[:, max(0, min(128, cout - half * 128)):] = 0
                    if wh is None:
                        keep = inside.nonzero()[0]
                        o = slice(half * 128, min(cout, half * 128 + 128))
                        out[img, 2 * y[keep] + a, 2 * x[keep] + b, o] = \
                            z[keep, :o.stop - o.start]
                    else:
                        hacc += z.double() @ wh[:, cols].double().t()
                if wh is not None:
                    keep = inside.nonzero()[0]
                    yk, xk = y[keep], x[keep]
                    if store == "head_packed1":
                        pk = (g * h + yk) * w + xk
                    else:
                        pk = ((4 * g + 2 * (yk & 1) + (xk & 1)) * (h // 2) * (w // 2)
                              + (yk >> 1) * (w // 2) + (xk >> 1))
                    acc_h = hacc[keep, :joints].round().to(torch.int32)
                    out[:, img, pk] = (acc_h.float() * vh[0] + vh[1]).t()
    return out


@pytest.mark.parametrize("n,h,w,cin,c1,c2,joints", [(2, 4, 4, 32, 32, 32, 4),
                                                     (1, 6, 10, 32, 64, 136, 17)])
def test_tail2_tile_emulation_equals_plain(rng, n, h, w, cin, c1, c2, joints):
    """B1's decomposition (halo tiles overhanging the image, the 16 (phase,
    tap) offsets, the swizzled stage images, two n-halves with the head
    split over them, the packed store) gives phase_tail2_plain's heatmaps
    exactly: the only check of the kernel's index arithmetic on the CPU."""
    args = {"w1": _i8(rng, 4, 4, cin, c1), "w2": _i8(rng, 4, 4, c1, c2),
            "s1": np.stack([_scales(rng, c1, lo=2e-3, hi=8e-3),
                            rng.uniform(-20, 20, c1).astype(np.float32)]),
            "s2": np.stack([_scales(rng, c2, lo=2e-3, hi=8e-3),
                            rng.uniform(-20, 20, c2).astype(np.float32)]),
            "so1": np.asarray([[0.91 * cin / 32]], np.float32),
            "so2": np.asarray([[1.13 * c1 / 32]], np.float32),
            "wh": _i8(rng, c2, joints),
            "vh": np.stack([_scales(rng, joints, lo=1e-4, hi=1e-3),
                            rng.uniform(-1, 1, joints).astype(np.float32)])}
    dev = tpt.tail2_device_args(args, "cpu")
    x = torch.from_numpy(_i8(rng, n, h * w, cin))
    ref = tpt.phase_tail2_plain(x, dev, h=h, w=w)
    z1 = tail2_kernel_emulation(x.reshape(n, h, w, cin), dev["w1t"], dev["s1"], dev["so1"])
    z1_ref = tpt._phase_conv_plain(x.reshape(n, h, w, cin), dev["w1"], dev["s1"][0],
                                   dev["s1"][1], dev["so1"], interleave=True)
    assert torch.equal(z1, z1_ref) and len(torch.unique(z1)) > 20
    got = tail2_kernel_emulation(z1, dev["w2t"], dev["s2"], dev["so2"], dev["wht"], dev["vh"])
    assert got.shape == ref.shape and torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("n,h,w,cin,cout,joints", [(2, 4, 4, 32, 32, 4), (3, 3, 5, 96, 96, 7),
                                                   (1, 6, 10, 64, 136, 17)])
def test_b5_kernel_emulation_equals_plain(rng, n, h, w, cin, cout, joints):
    """B5's decomposition, B1's deconv2 + head instance with the levels=1
    store (odd h and w with tiles overhanging them, odd J, a Cout that is no
    multiple of 128 and a partial second n-half): equal to phase_tail_plain's
    heatmaps exactly, every element stored once."""
    args = {"w": _i8(rng, 4, 4, cin, cout),
            "sv": np.stack([_scales(rng, cout, lo=2e-3, hi=8e-3) * 32 / cin,
                            rng.uniform(-20, 20, cout).astype(np.float32)]),
            "so": np.asarray([[0.91]], np.float32),
            "wh": _i8(rng, cout, joints),
            "vh": np.stack([_scales(rng, joints, lo=1e-4, hi=1e-3),
                            rng.uniform(-1, 1, joints).astype(np.float32)])}
    dev = tpt.tail_device_args(args, "cpu")
    x = torch.from_numpy(_i8(rng, n, h * w, cin))
    ref = tpt.phase_tail_plain(x, dev, h=h, w=w)
    z = tpt._phase_conv_plain(x.reshape(n, h, w, cin), dev["w"], dev["sv"][0], dev["sv"][1],
                              dev["so"], interleave=False)
    assert len(torch.unique(z)) > 20
    got = tail2_kernel_emulation(x.reshape(n, h, w, cin), dev["wt"], dev["sv"], dev["so"],
                                 dev["wht"], dev["vh"], store="head_packed1")
    assert got.shape == ref.shape == (joints, n, 4 * h * w)
    assert not got.isnan().any() and torch.equal(got, ref) and float(ref.std()) > 0


def test_tail_device_args_stage_images_untile_to_the_weights(rng):
    """tail_device_args gives B5 its stage images and padded head beside the
    K-minor w and wh: untiled, they hold them exactly, zeros elsewhere."""
    cin, cout, joints = 64, 136, 7
    args = {"w": _i8(rng, 4, 4, cin, cout), "sv": np.zeros((2, cout), np.float32),
            "so": np.ones((1, 1), np.float32), "wh": _i8(rng, cout, joints),
            "vh": np.zeros((2, joints), np.float32)}
    dev = tpt.tail_device_args(args, "cpu")
    assert tuple(dev["wt"].shape) == (4, 2, 4 * cin // 64, 128, 64)
    for g in range(4):
        full = trb.untile_weight(dev["wt"][g], 256, 4 * cin)
        assert not full[cout:].any()
        np.testing.assert_array_equal(
            full[:cout].reshape(cout, 4, cin).permute(1, 0, 2).numpy(), dev["w"][g].numpy())
    assert tuple(dev["wht"].shape) == (16, 256)
    np.testing.assert_array_equal(dev["wht"][:joints, :cout].numpy(), dev["wh"].numpy())
    assert not dev["wht"][joints:].any() and not dev["wht"][:, cout:].any()


def test_plan_tail2_path3_shapes():
    """Path 3's two launches at its 32 images: B5 (32x32, 256 -> 256 -> 16)
    takes B1's deconv2 + head plan, 8 tiles an image (256 blocks), two blocks
    an SM; B6 (deconv0, 8x8, 2048 -> 256) takes one (phase, n-half) pair a
    block on the streamed halo, 16 image pairs x 8 pairs = 128 blocks, one
    wave on the H100's 132 SMs (4 pairs at 128 images, as B2)."""
    plan = tpt.plan_tail2(32, 32, 256, 256, 2)
    assert plan.tiles_x * plan.tiles_y * 32 == 256 and plan.sets == 8
    assert 228 * 1024 // (plan.smem + 1024) == 2
    assert tpt.stream_sets(32, 8, 8, 256, 132) == 1
    assert tpt.stream_sets(128, 8, 8, 256, 132) == 4
    p6 = tpt.plan_tail2(8, 8, 2048, 256, 0, tpt.STREAM_STAGES, design=tpt.STREAM_DESIGN,
                        folded=True, sets=1)
    assert (p6.tiles_x, p6.tiles_y, p6.sets) == (1, 1, 1) and 16 * 8 // p6.sets <= 132


def test_launch_tail2_store_contract(rng):
    """launch_tail2's ``store``: by default the one each epilogue's wrapper
    always took; a head store exactly when a head is given, the levels=2
    order only on an even grid; every refusal (and the CUDA check, which a
    CPU tensor fails) names the caller given as ``what``."""
    assert [tpt.default_store(e, head) for e in tpt.EPILOGUES for head in (False, True)] == [
        "interleaved", "head_packed2", "interleaved", "head_row_major", "phase_major",
        "head_packed2"]
    args = tpt.tail_device_args({
        "w": _i8(rng, 4, 4, 32, 32), "sv": np.ones((2, 32), np.float32),
        "so": np.ones((1, 1), np.float32), "wh": _i8(rng, 32, 5),
        "vh": np.ones((2, 5), np.float32)}, "cpu")
    x4 = torch.zeros(2, 3, 5, 32, dtype=torch.int8)
    head = (args["wht"], args["vh"])
    for store, extra in (("head_packed1", ()), ("n_minor", head), ("levels1", head),
                         ("head_packed2", head)):  # the last: a 3 x 5 grid
        with pytest.raises(ValueError, match=f"caller: unsupported .*store '{store}'"):
            tpt.launch_tail2(x4, args["wt"], args["sv"], args["so"], *extra, store=store,
                             what="caller")
    for store, extra in (("head_packed1", head), ("interleaved", ())):
        with pytest.raises(ValueError, match="caller: x must be a contiguous CUDA tensor"):
            tpt.launch_tail2(x4, args["wt"], args["sv"], args["so"], *extra, store=store,
                             what="caller")
