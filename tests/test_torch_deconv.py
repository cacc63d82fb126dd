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
from posetpu_torch.ops.phase_tail import phase_sums  # noqa: E402

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
    assert set(got) == set(ref) == set(dev)
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].dtype == r.dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)
    np.testing.assert_array_equal(dev["v"].numpy(), np.asarray(ref["v"]))
    np.testing.assert_array_equal(dev["vh"].numpy(), np.asarray(ref["vh"]))
    np.testing.assert_array_equal(dev["wh"].numpy().T, np.asarray(ref["wh"]))
    w = np.asarray(ref["w"]).reshape(4, CIN, 4, COUT)  # [tap, I, phase, O]
    np.testing.assert_array_equal(dev["w"].numpy(), w.transpose(2, 0, 3, 1))
