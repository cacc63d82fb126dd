"""posetpu_torch.ops.deconv (B9a, B9b) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, the kernel arguments
carried across by models/convert.from_jax_params. (The JAX package has no
test of these two kernels; the int8 runner's subpixel deconv is their
reference there, and is checked here too.)

On the CPU each wrapper runs its kernel's plain version, so these tests pin
the arithmetic the CUDA kernels must reproduce (the kernels themselves are
held against the plain versions on the card: tests/test_torch_cuda.py and
chip_smoke.py).

Tolerance: B9a's int8 output is equal, B9b's f32 heatmaps are equal, except
where XLA on the CPU contracted an epilogue's ``acc * scale + bias`` into one
FMA: an int8 element may then differ by one step (on at most 1e-3 of the
elements), a heatmap value by one rounding of the product plus one of the
result, and every differing element must be the once-rounded value."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.models import quant as jq  # noqa: E402
from posetpu.ops.pallas import deconv as jdc  # noqa: E402
from posetpu_torch.models.convert import from_jax_params  # noqa: E402
from posetpu_torch.ops import deconv as tdc  # noqa: E402
from posetpu_torch.ops import phase_tail as tpt  # noqa: E402
from posetpu_torch.ops.phase_tail import phase_sums  # noqa: E402
from posetpu_torch.ops.resblock import untile_weight  # noqa: E402

H, W, CIN, COUT, J = 6, 8, 32, 16, 16
S_IN = 0.031


def _qparams(seed, form):
    """One deconv + the head, the deconv's weights stored un-decomposed
    ([4, 4, I, O]) or in the subpixel form ([2, 2, I, 4*O])."""
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-127, 128, size=s).astype(np.int8)
    wshape = (4, 4, CIN, COUT) if form == 4 else (2, 2, CIN, 4 * COUT)
    return {
        "weights": {"deconv0": i8(*wshape), "final": i8(1, 1, COUT, J)},
        "w_scales": {"deconv0": rng.uniform(1e-3, 4e-3, wshape[-1]).astype(np.float32),
                     "final": rng.uniform(1e-4, 1e-3, J).astype(np.float32)},
        "biases": {"deconv0": rng.normal(0, 0.5, COUT).astype(np.float32),
                   "final": rng.normal(0, 0.5, J).astype(np.float32)},
        "act_scales": {"deconv0.out": np.float32(0.043)},
    }


def _args(q, head):
    jargs = jdc.build_deconv_args(q, "deconv0", S_IN)
    if head:
        jargs.update(jdc.build_head_args(q, float(q["act_scales"]["deconv0.out"])))
    dev = from_jax_params({"deconv": [jax.tree.map(np.asarray, jargs)]}, "cpu")["deconv"][0]
    return jargs, dev


def _x(seed, n=3):
    return np.random.default_rng(seed).integers(-127, 128, size=(n, H * W, CIN)).astype(np.int8)


def _once_rounded_deconv(x, dev):
    """B9a with ``acc * v0 + v1`` rounded once (exact in f64, one f32 rounding)."""
    n = x.shape[0]
    v = dev["v"].reshape(2, 4, COUT).double()
    z = [torch.clamp(torch.round((acc.double() * v[0, g] + v[1, g]).float()), 0, 127)
         .to(torch.int8).reshape(n, H, W, COUT)
         for g, acc in enumerate(phase_sums(torch.from_numpy(x).reshape(n, H, W, CIN),
                                            dev["w"]))]
    return tdc.subpixel_interleave_packed_nmajor(torch.stack(z)).reshape(n, 4 * H * W, COUT)


def assert_int8_equal_up_to_fma(got, ref, once):
    got, ref = got.numpy().astype(np.int32), np.asarray(ref).astype(np.int32)
    assert got.shape == ref.shape and len(np.unique(got)) > 50
    differ = got != ref
    if differ.any():
        assert np.abs(got - ref).max() <= 1 and differ.mean() < 1e-3
        np.testing.assert_array_equal(ref[differ], once.numpy().astype(np.int32)[differ])


@pytest.mark.parametrize("form", [4, 2])
def test_subpixel_deconv_matches_jax_kernel(form):
    """B9a at H, W = 6, 8, Cin 32, Cout 16, from either weight form."""
    q, x = _qparams(0, form), _x(1)
    jargs, dev = _args(q, head=False)
    ref = jdc.fused_subpixel_deconv(jnp.asarray(x), jargs, h=H, w=W, interpret=True)
    got = tdc.fused_subpixel_deconv(torch.from_numpy(x), dev, h=H, w=W)
    assert got.dtype == torch.int8 and tuple(got.shape) == (3, 4 * H * W, COUT)
    assert_int8_equal_up_to_fma(got, ref, _once_rounded_deconv(x, dev))


def test_subpixel_deconv_head_matches_jax_kernel():
    """B9b: f32 heatmaps [N, 4*H*W, J], row-major."""
    q, x = _qparams(2, 4), _x(3)
    jargs, dev = _args(q, head=True)
    ref = np.asarray(jdc.fused_subpixel_deconv_head(jnp.asarray(x), jargs, h=H, w=W,
                                                    interpret=True))
    got = tdc.fused_subpixel_deconv_head(torch.from_numpy(x), dev, h=H, w=W).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (3, 4 * H * W, J)
    assert np.std(got) > 0

    # the head's exact sums over the JAX kernel's own deconv output
    yq = np.asarray(jdc.fused_subpixel_deconv(jnp.asarray(x), jargs, h=H, w=W,
                                              interpret=True))
    acc = yq.astype(np.int64) @ np.asarray(jargs["wh"]).astype(np.int64)
    vh = np.asarray(jargs["vh"])
    fma = (acc * vh[0].astype(np.float64) + vh[1].astype(np.float64)).astype(np.float32)
    twice = acc.astype(np.float32) * vh[0] + vh[1]
    same_deconv = (tdc.fused_subpixel_deconv(torch.from_numpy(x), dev, h=H, w=W).numpy()
                   == yq).all(axis=-1)
    assert same_deconv.mean() > 1 - 1e-3
    differ = (got != ref) & same_deconv[..., None]
    np.testing.assert_array_equal(got[same_deconv], twice[same_deconv])
    np.testing.assert_array_equal(ref[differ], fma[differ])
    bound = np.spacing(np.abs(acc.astype(np.float32) * vh[0])) + np.spacing(np.abs(ref))
    assert (np.abs(got - ref)[differ] <= bound[differ]).all()


def test_subpixel_deconv_matches_int8_runner():
    """B9a against the JAX int8 runner's ``qchain(subpixel=True)``: the
    folded, once-rounded epilogue may differ from the runner's two-step one
    by one int8 step on rare elements."""
    q, x = _qparams(4, 2), _x(5)
    runner = jq._Int8Runner(jax.tree.map(jnp.asarray, q))
    ref, _ = runner.qchain(jnp.asarray(x).reshape(3, H, W, CIN), jnp.float32(S_IN),
                           "deconv0", subpixel=True)
    _, dev = _args(q, head=False)
    got = tdc.fused_subpixel_deconv(torch.from_numpy(x), dev, h=H, w=W)
    diff = np.abs(got.numpy().reshape(3, 2 * H, 2 * W, COUT).astype(np.int32)
                  - np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-2


@pytest.mark.parametrize("form", [4, 2])
def test_build_deconv_and_head_args_match_jax(form):
    """``build_deconv_args`` and ``build_head_args`` fed the same qparams give
    the JAX functions' arrays bit for bit; the kernels' layout is a transpose
    of them."""
    q = _qparams(6, form)
    s_out = float(q["act_scales"]["deconv0.out"])
    ref = {**jdc.build_deconv_args(q, "deconv0", S_IN), **jdc.build_head_args(q, s_out)}
    got = {**tdc.build_deconv_args(q, "deconv0", S_IN), **tdc.build_head_args(q, s_out)}
    dev = tdc.deconv_device_args(got, "cpu")
    assert set(got) == set(ref) and set(dev) == set(ref) | {"wt", "wht"}
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].dtype == r.dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)
    np.testing.assert_array_equal(dev["v"].numpy(), np.asarray(ref["v"]))
    np.testing.assert_array_equal(dev["vh"].numpy(), np.asarray(ref["vh"]))
    np.testing.assert_array_equal(dev["wh"].numpy().T, np.asarray(ref["wh"]))
    w = np.asarray(ref["w"]).reshape(4, CIN, 4, COUT)  # [tap, I, phase, O]
    np.testing.assert_array_equal(dev["w"].numpy(), w.transpose(2, 0, 3, 1))
    # the kernel's weights: deconv0's stage images in the taps' K order (the
    # halo fits at Cin 32), the head padded to 16 joints and 128 channels
    assert tdc.deconv_design(CIN, COUT, J) == "halo"
    for g in range(4):
        full = untile_weight(dev["wt"][g], 128, 4 * CIN)
        np.testing.assert_array_equal(full[:COUT].reshape(COUT, 4, CIN).permute(1, 0, 2).numpy(),
                                      dev["w"][g].numpy())
        assert not full[COUT:].any()
    np.testing.assert_array_equal(dev["wht"][:J, :COUT].numpy(), dev["wh"].numpy())
    assert not dev["wht"][J:].any() and not dev["wht"][:, COUT:].any()


def _kernel_args(rng, cin, cout, joints=0, chunked=False):
    """Random B9 arguments in the kernels' layout: K-minor w, per-phase v
    [2, 4 Cout] that keep the folded requant off its clip, and the stage
    images (``chunked``: the streamed halo's K order)."""
    w = torch.from_numpy(rng.integers(-127, 128, (4, 4, cout, cin)).astype(np.int8))
    v = np.stack([rng.uniform(0.5, 1.5, 4 * cout) * 0.3 / cin ** 0.5 / 127,
                  rng.uniform(-4, 4, 4 * cout)]).astype(np.float32)
    args = {"w": w, "v": torch.from_numpy(v), "wt": tpt.tile_phase_weight(w, chunked=chunked)}
    if joints:
        args["wh"] = torch.from_numpy(rng.integers(-127, 128, (joints, cout)).astype(np.int8))
        args["vh"] = torch.from_numpy(np.stack([rng.uniform(1e-4, 1e-3, joints),
                                                rng.uniform(-0.5, 0.5, joints)]).astype(np.float32))
        args["wht"] = tpt.pad_head(args["wh"])
    return args


def b9_kernel_emulation(x4, args, *, design="halo", sets=None, stages=None,
                        epilogue="folded", store="phase_major"):
    """One launch of csrc/tail2.cu with B9's folded, per-phase epilogue on the
    CPU, block by block as the kernel walks it: the planned grid (tiles x
    images x groups of ``sets`` (phase, n-half) pairs), each block's flat
    k-steps from its first pair's stage images on, each step's four 32-deep
    products with A as the design brings it (the resident halo at the tap's
    offset; the streamed halo's 32-channel chunk under tap s) and B read
    through the stage images' swizzle, the half requantised with its phase's vectors (zeros past
    Cout), then the deconv stored interleaved, or the head summed half by
    half and its phase stored row-major at pixel (2y + a, 2x + b).
    ``epilogue="relu_phase"``: B2's instance instead, B1's relu requant with 1 / so on the
    per-phase rows of ``args["svb"]`` [8, Cout] and the phase-major store,
    pixel (y, x) of phase g at [g, img, y, x]; with ``store="n_minor"``
    B6's instance, the same at [g, y, x, img]."""
    n, h, w, cin = x4.shape
    phases = epilogue == "relu_phase"
    wt = args["wt"]
    v = args["svb"].reshape(2, -1) if phases else args["v"]
    nh, cout = wt.shape[1], v.shape[-1] // 4
    head = "wht" in args
    joints = args["vh"].shape[-1] if head else 0
    jt = 0 if not head else (2 if joints <= 16 else 4)
    plan = tpt.plan_tail2(h, w, cin, cout, jt, stages, design=design, folded=True, sets=sets)
    stream = design != "halo"
    ks_count = 4 * cin // 128
    images = wt.reshape(-1, 128, 64)
    swz = np.arange(4)[None, :] ^ ((np.arange(128)[:, None] >> 1) & 3)
    phys = torch.from_numpy((swz[:, :, None] * 16 + np.arange(16)).reshape(128, 64)).long()
    sv = torch.zeros(8, nh * 128)
    sv[:, :cout] = v.reshape(8, cout)  # row 4 (scale, bias) + phase
    # the input as TMA or the halo copy sees it: zeros outside the images
    xp = torch.zeros(n + 2, h + 18, w + 18, cin, dtype=torch.int8)
    xp[:n, 1:h + 1, 1:w + 1] = x4
    r = np.arange(128)
    if head:
        out = torch.full((n, 2 * h, 2 * w, joints), float("nan"))
    elif phases:
        shape = (4, h, w, n, cout) if store == "n_minor" else (4, n, h, w, cout)
        out = torch.full(shape, -128, dtype=torch.int8)  # -128: never stored
        inv_so = 1.0 / args["so"].reshape(())
    else:
        out = torch.zeros(n, 2 * h, 2 * w, cout, dtype=torch.int8)
    for by in range(-(-n // 2) if stream else n):
        for y0, x0 in tpt.tail2_tiles(plan):
            img = 2 * by + (r >> 6) if stream else np.full(128, by)
            y = y0 + ((r >> 3) & 7 if stream else r >> 3)
            x = x0 + (r & 7)
            inside = (img < n) & (y < h) & (x < w)

            def a_rows(sr, sc_, c0):  # rows' pixels shifted by (sr, sc_), 32 channels
                return xp[img, 1 + y + sr, 1 + x + sc_, c0:c0 + 32]

            for bz in range(4 * nh // plan.sets):
                set0 = bz * plan.sets
                q = set0 * ks_count
                hacc = torch.zeros(128, 8 * jt, dtype=torch.float64)
                for st in range(set0, set0 + plan.sets):
                    g, half = divmod(st, nh)
                    a, b = g >> 1, g & 1
                    acc = torch.zeros(128, 128, dtype=torch.float64)
                    tap, c = 0, 0
                    for ks in range(ks_count):
                        for s in range(4):
                            brows = torch.gather(images[2 * q + (s >> 1)], 1,
                                                 phys[:, 32 * (s & 1):32 * (s & 1) + 32])
                            if design == "halo":
                                arows = a_rows((tap >> 1) - 1 + a, (tap & 1) - 1 + b, c)
                                c += 32
                                if c == cin:
                                    c, tap = 0, tap + 1
                            else:
                                arows = a_rows((s >> 1) - 1 + a, (s & 1) - 1 + b, 32 * ks)
                            acc += arows.double() @ brows.double().t()
                        q += 1
                    cols = slice(half * 128, half * 128 + 128)
                    accf = acc.round().to(torch.int32).float()
                    if phases:  # relu(acc * s + b) * (1 / so), rounded once
                        z = torch.clamp(torch.round(torch.relu(accf * sv[g, cols] + sv[4 + g, cols])
                                                    * inv_so), -127, 127).to(torch.int8)
                    else:
                        z = torch.clamp(torch.round(accf * sv[g, cols] + sv[4 + g, cols]), 0, 127
                                        ).to(torch.int8)
                    z[:, max(0, min(128, cout - half * 128)):] = 0
                    keep = inside.nonzero()[0]
                    if phases:
                        o = slice(half * 128, min(cout, half * 128 + 128))
                        if store == "n_minor":
                            out[g, y[keep], x[keep], img[keep], o] = z[keep, :o.stop - o.start]
                        else:
                            out[g, img[keep], y[keep], x[keep], o] = z[keep, :o.stop - o.start]
                        continue
                    if not head:
                        o = slice(half * 128, min(cout, half * 128 + 128))
                        out[img[keep], 2 * y[keep] + a, 2 * x[keep] + b, o] = \
                            z[keep, :o.stop - o.start]
                        continue
                    hacc += z.double() @ args["wht"][:, cols].double().t()
                    if half == nh - 1:
                        acc_h = hacc[keep, :joints].round().to(torch.int32)
                        out[img[keep], 2 * y[keep] + a, 2 * x[keep] + b] = \
                            acc_h.float() * args["vh"][0] + args["vh"][1]
                        hacc.zero_()
    return out if phases else out.reshape(n, 4 * h * w, -1)


@pytest.mark.parametrize("n,h,w,cin,cout,design,sets", [
    (3, 6, 8, 32, 16, "halo", None),     # the small card shape
    (5, 3, 7, 96, 24, "halo", 4),        # odd: overhanging tiles, partial n-half, sets
    (2, 4, 4, 32, 136, "halo", None),    # two n-halves, the second partial
    (3, 8, 8, 64, 16, "stream", 1),      # deconv0's streamed K order at small Cin
    (3, 3, 7, 96, 136, "stream", 2),     # odd: an image past N, tiles past the grid
    (2, 9, 10, 128, 24, "stream", 4),    # two 8 x 8 tiles a row and a column
])
def test_b9a_kernel_emulation_equals_plain(n, h, w, cin, cout, design, sets):
    """B9a's decomposition in both designs (the grid, the sets a block takes,
    the stage images' K order, the A operand the design brings, the folded
    per-phase epilogue, the interleaved store) gives the plain version's
    int8 image exactly: the CPU's check of the kernel's index arithmetic."""
    rng = np.random.default_rng(20 + cin + cout)
    args = _kernel_args(rng, cin, cout, chunked=design == "stream")
    x = torch.from_numpy(rng.integers(0, 128, (n, h * w, cin)).astype(np.int8))
    ref = tdc.subpixel_deconv_plain(x, args, h=h, w=w)
    got = b9_kernel_emulation(x.reshape(n, h, w, cin), args, design=design, sets=sets)
    assert got.shape == ref.shape and len(torch.unique(ref)) > 50
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout,sets,stages", [
    (3, 8, 8, 64, 16, None, None),       # the wrapper's sets and ring, one n-half
    (5, 3, 7, 96, 136, None, None),      # an image past N, tiles past the grid, 2 n-halves
    (3, 9, 12, 128, 24, 2, 3),           # two 8 x 8 tiles a row and a column, other sets
    (2, 8, 8, 256, 256, 8, 2),           # deconv0's Cout, all eight pairs in one block
])
def test_b2_kernel_emulation_equals_plain(n, h, w, cin, cout, sets, stages):
    """B2's decomposition, tail2_kernel's phase-major instance on the
    streamed halo (the grid of 8 x 8 tiles of image pairs, the chunked K
    order of the stage images, B1's relu requant with 1 / so on the per-phase
    rows of ``svb``, the phase-major store): equal to phase_tail's plain
    version exactly, every element stored once."""
    rng = np.random.default_rng(40 + cin + cout)
    w8 = torch.from_numpy(rng.integers(-127, 128, (4, 4, cout, cin)).astype(np.int8))
    sv = rng.uniform(0.5, 1.5, (4, cout)) * 0.6 / cin ** 0.5 / 127
    args = tpt.with_subpixel_weights({
        "w": w8, "sv": torch.from_numpy(sv.astype(np.float32)),
        "bv": torch.from_numpy(rng.uniform(-20, 20, (4, cout)).astype(np.float32)),
        "so": torch.tensor([[0.37]])})
    assert tuple(args["svb"].shape) == (8, cout)
    x = torch.from_numpy(rng.integers(0, 128, (n, h * w, cin)).astype(np.int8))
    ref = tpt.subpixel_deconv_plain(x, args, h=h, w=w)
    got = b9_kernel_emulation(x.reshape(n, h, w, cin), args, design=tpt.STREAM_DESIGN,
                              sets=tpt.stream_sets(n, h, w, cout, 132) if sets is None else sets,
                              stages=tpt.STREAM_STAGES if stages is None else stages,
                              epilogue="relu_phase")
    assert got.shape == ref.shape == (4, n, h, w, cout)
    assert len(torch.unique(ref)) > 50 and bool((ref < 0).any() or (ref == 0).any())
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout,sets,stages", [
    (3, 8, 8, 64, 24, None, None),       # the wrapper's sets and ring, one partial n-half
    (5, 3, 7, 96, 136, None, None),      # an image past N, tiles past the grid, 2 n-halves
    (3, 9, 12, 128, 24, 2, 3),           # two 8 x 8 tiles a row and a column, other sets
    (2, 8, 8, 64, 136, 8, 2),            # all eight pairs in one block
    (4, 8, 8, 32, 136, 1, 4),            # one pair a block, as at path 3's 32 images
])
def test_b6_kernel_emulation_equals_plain(n, h, w, cin, cout, sets, stages):
    """B6's decomposition, tail2_kernel's N-minor instance on the streamed
    halo (B2's grid, K order and relu requant on the rows of ``svb``, the
    store at [g, y, x, img]): equal to subpixel_deconv_pairs_plain exactly,
    every element stored once."""
    rng = np.random.default_rng(60 + cin + cout)
    w8 = torch.from_numpy(rng.integers(-127, 128, (4, 4, cout, cin)).astype(np.int8))
    sv = rng.uniform(0.5, 1.5, (4, cout)) * 0.6 / cin ** 0.5 / 127
    args = tpt.with_subpixel_weights({
        "w": w8, "sv": torch.from_numpy(sv.astype(np.float32)),
        "bv": torch.from_numpy(rng.uniform(-20, 20, (4, cout)).astype(np.float32)),
        "so": torch.tensor([[0.37]])})
    x = torch.from_numpy(rng.integers(0, 128, (n, h * w, cin)).astype(np.int8))
    ref = tpt.subpixel_deconv_pairs_plain(x, args, h=h, w=w)
    got = b9_kernel_emulation(x.reshape(n, h, w, cin), args, design=tpt.STREAM_DESIGN,
                              sets=tpt.stream_sets(n, h, w, cout, 132) if sets is None else sets,
                              stages=tpt.STREAM_STAGES if stages is None else stages,
                              epilogue="relu_phase", store="n_minor")
    assert got.shape == ref.shape == (4, h, w, n, cout)
    assert len(torch.unique(ref)) > 50 and bool((ref < 0).any() or (ref == 0).any())
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout,joints", [(3, 6, 8, 32, 16, 16), (5, 3, 7, 96, 24, 7),
                                                   (2, 4, 6, 64, 136, 17)])
def test_b9b_kernel_emulation_equals_plain(n, h, w, cin, cout, joints):
    """B9b's decomposition: the folded per-phase requant of each n-half into
    the head's sums, the head's epilogue per phase and its row-major store
    (J floats at pixel (2y + a, 2x + b)), odd joint counts and a partial
    n-half: equal to the plain version's heatmaps."""
    rng = np.random.default_rng(30 + joints)
    args = _kernel_args(rng, cin, cout, joints)
    x = torch.from_numpy(rng.integers(0, 128, (n, h * w, cin)).astype(np.int8))
    ref = tdc.subpixel_deconv_head_plain(x, args, h=h, w=w)
    got = b9_kernel_emulation(x.reshape(n, h, w, cin), args)
    assert got.shape == ref.shape == (n, 4 * h * w, joints)
    assert torch.equal(got, ref) and float(ref.std()) > 0


@pytest.mark.parametrize("cin,cout,joints", [(2048, 256, 0), (256, 256, 0), (256, 256, 16),
                                             (96, 24, 7)])
def test_deconv_device_args_stage_images_round_trip(cin, cout, joints):
    """``deconv_device_args`` tiles ``w`` into the stage images of the design
    the shape takes (deconv0 at Cin 2048: the streamed halo's chunked K
    order; the rest: the taps') and pads the head; untiled, they hold ``w``
    and ``wh`` exactly, zeros elsewhere."""
    rng = np.random.default_rng(cin + joints)
    jargs = {"w": rng.integers(-127, 128, (4, cin, 4 * cout)).astype(np.int8),
             "v": rng.uniform(-1, 1, (2, 4 * cout)).astype(np.float32)}
    if joints:
        jargs["wh"] = rng.integers(-127, 128, (cout, joints)).astype(np.int8)
        jargs["vh"] = rng.uniform(-1, 1, (2, joints)).astype(np.float32)
    dev = tdc.deconv_device_args(jargs, "cpu")
    design = tdc.deconv_design(cin, cout, joints)
    assert design == ("halo" if cin <= 256 else tdc.STREAM_DESIGN)
    nh = -(-cout // 128)
    assert tuple(dev["wt"].shape) == (4, nh, 4 * cin // 64, 128, 64)
    for g in range(4):
        full = untile_weight(dev["wt"][g], nh * 128, 4 * cin)
        assert not full[cout:].any()
        k = full[:cout].reshape(cout, cin // 32, 4, 32).permute(0, 2, 1, 3) \
            if design == "stream" else full[:cout].reshape(cout, 4, cin)
        np.testing.assert_array_equal(k.reshape(cout, 4, cin).permute(1, 0, 2).numpy(),
                                      dev["w"][g].numpy())
    if joints:
        assert tuple(dev["wht"].shape) == (16, nh * 128)
        np.testing.assert_array_equal(dev["wht"][:joints, :cout].numpy(), dev["wh"].numpy())
        assert not dev["wht"][joints:].any() and not dev["wht"][:, cout:].any()


def test_plan_serving_shapes():
    """The three B9 launches of a forward at their serving shapes (128
    images): deconv0 (8x8, 2048 -> 256) does not fit the resident halo and
    streams, its 4 (phase, n-half) pairs a block giving 64 x 2 = 128 blocks,
    one wave on the 132 SMs at one block an SM; deconv1 (16x16, 256 -> 256)
    and deconv2 + head (32x32, 256 -> 256 -> 16) take the resident halo with
    the per-phase vectors, two blocks an SM (228 KB, 1 KB reserved a block);
    too deep a ring, a head after a streamed deconv and sets that split a
    phase under a head are refused."""
    blocks_an_sm = lambda plan: 228 * 1024 // (plan.smem + 1024)
    assert not tpt.halo_fits(2048, 256, 0, folded=True)
    assert tdc.deconv_design(2048, 256) == tdc.STREAM_DESIGN == "stream"
    p0 = tpt.plan_tail2(8, 8, 2048, 256, 0, tdc.STREAM_STAGES, design=tdc.STREAM_DESIGN,
                        folded=True, sets=tdc.stream_sets(128, 8, 8, 256, 132))
    assert (p0.tiles_x, p0.tiles_y, p0.off_ring) == (1, 1, 0)
    assert 64 * (8 // p0.sets) <= 132 and blocks_an_sm(p0) == 1
    for h, jt, tiles in ((16, 0, 2), (32, 2, 8)):
        assert tdc.deconv_design(256, 256, 16 if jt else 0) == "halo"
        plan = tpt.plan_tail2(h, h, 256, 256, jt, folded=True)
        assert plan.tiles_x * plan.tiles_y == tiles and plan.sets == 8
        assert blocks_an_sm(plan) == 2
        # the per-phase vectors cost 6 KB over B1's shared ones
        assert plan.smem - tpt.plan_tail2(h, h, 256, 256, jt).smem == 6 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        tpt.plan_tail2(8, 8, 2048, 256, 0, folded=True)
    with pytest.raises(ValueError, match="shared memory"):
        tpt.plan_tail2(8, 8, 2048, 256, 0, 10, design="stream", folded=True)
    with pytest.raises(ValueError, match="head"):
        tpt.plan_tail2(32, 32, 256, 256, 2, design="stream", folded=True)
    with pytest.raises(ValueError, match="whole phases"):
        tpt.plan_tail2(32, 32, 256, 256, 2, folded=True, sets=1)
    with pytest.raises(ValueError, match="design"):
        tpt.plan_tail2(8, 8, 96, 256, 0, design="boxes", folded=True)
