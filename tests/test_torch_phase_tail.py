"""posetpu_torch.ops.phase_tail (B1, B2) against the JAX package's Pallas
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
    assert set(got) == set(ref) == set(dev)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        d = dev[k].numpy()
        np.testing.assert_array_equal(np.swapaxes(d, -1, -2) if k in k_minor else d,
                                      np.asarray(ref[k]), err_msg=k)
