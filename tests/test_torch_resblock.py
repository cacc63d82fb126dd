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
    assert set(got) == set(jargs) == set(dev)
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
