"""The port's int8 forward in every head, stem and 4-bit-carrier option
against the JAX package's, on the same weights (convert.from_jax_variables),
the JAX side's own qparams (convert.from_jax_params) and the same float
input, at ResNet-18 with 64x64 input.

- ``jns_head`` False / True / "bf16" x ``stem_s2d`` False / True / "pre":
  the heatmaps equal JAX's, except where XLA on the CPU contracted the head's
  f32 epilogue ``acc * scale + bias`` into one FMA: then within one rounding
  of the product plus one of the result (every int8 stage before the head is
  exact, or the bound would not hold). A bf16 head rounds those f32 values
  to nearest even: equal, or one bf16 step apart where the f32 values
  straddle a rounding boundary, on a share of the values that is stated;
- the three stems give the same heatmaps bit for bit;
- ``subpixel_deconvs=True`` with a row-major head, as the JAX package's
  tests use it;
- ``pack_nibbles`` / ``unpack_nibbles`` equal JAX's byte for byte, and
  ``act4_mode="packed"`` == ``"s4"`` == JAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.models import quant as jq
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_params
from tests.test_quant import _trained_like_variables
from tests.test_torch_quant import _np_tree, _port_model, assert_head_rounding_only

ACT4 = ("layer1_0.out", "layer1_1.out", "layer2_0.out", "layer2_1.out")


def _setup(rng):
    jmodel, variables = _trained_like_variables(rng)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    x = rng.randn(3, 64, 64, 3).astype(np.float32)
    return jmodel, variables, calib, x


def _both(jmodel, variables, calib, x, stem_s2d=False, **kw):
    """(JAX heatmaps, the port's on the carried qparams, those qparams)."""
    qparams, jfwd = jq.quantize_pose_resnet(jmodel, variables, calib,
                                            stem_s2d=stem_s2d, **kw)
    ref = jfwd(qparams, jq._s2d(jnp.asarray(x)) if stem_s2d == "pre" else jnp.asarray(x))
    model = _port_model(variables, 18)
    kw.setdefault("subpixel_deconvs", False)
    _, fwd = tq.quantize_pose_resnet(model, calib, stem_s2d=stem_s2d,
                                     phase_kernel=False, device="cpu", **kw)
    carried = from_jax_params({"q": _np_tree(qparams)}, "cpu")["q"]
    xt = torch.from_numpy(x)
    got = fwd(carried, tq._s2d(xt) if stem_s2d == "pre" else xt)
    return ref, got, carried


def _head_vh(carried):
    """[scale, bias] of the head's epilogue, as assert_head_rounding_only takes it."""
    s_z = carried["act_scales"]["deconv2.out"]
    return torch.stack([s_z * carried["w_scales"]["final"], carried["biases"]["final"]])


@pytest.mark.parametrize("stem_s2d", [False, True, "pre"])
@pytest.mark.parametrize("jns_head", [False, True, "bf16"])
def test_heads_and_stems_match_jax(rng, jns_head, stem_s2d):
    ref, got, carried = _both(*_setup(rng), stem_s2d=stem_s2d, jns_head=jns_head)
    assert tuple(got.shape) == tuple(ref.shape) == (
        (16, 3, 256) if jns_head else (3, 16, 16, 16))
    if jns_head == "bf16":
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        g, r = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        differ = g != r
        # one bf16 step (2^-8 relative) where the f32 values straddle a boundary
        assert differ.mean() < 2e-2
        assert (np.abs(g - r)[differ] <= np.abs(r)[differ] * 2.0 ** -7).all()
        return
    assert got.dtype == torch.float32 and float(got.std()) > 0
    g, r = got.numpy(), np.asarray(ref)
    if not jns_head:  # [N, h, w, J] -> the J-major layout the bound's bias takes
        g, r = g.transpose(3, 0, 1, 2), r.transpose(3, 0, 1, 2)
    assert_head_rounding_only(g, r, _head_vh(carried))


def test_stems_are_bit_identical(rng):
    jmodel, variables, calib, x = _setup(rng)
    model = _port_model(variables, 18)
    outs = []
    for stem in (False, True, "pre"):
        q, fwd = tq.quantize_pose_resnet(model, calib, stem_s2d=stem, jns_head=True,
                                         subpixel_deconvs=False, phase_kernel=False,
                                         device="cpu")
        xt = torch.from_numpy(x)
        outs.append(fwd(q, tq._s2d(xt) if stem == "pre" else xt))
        # a pre-quantised int8 input gives the same as the float one
        xq = tq._Int8Runner(q).input(xt)[0]
        assert xq.dtype == torch.int8
        assert torch.equal(fwd(q, tq._s2d(xq) if stem == "pre" else xq), outs[-1])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        fwd(q, torch.zeros(1, 32, 32, 12, dtype=torch.uint8))


def test_subpixel_deconvs_all_matches_jax(rng):
    """``subpixel_deconvs=True`` with the row-major head: every deconv, the
    last one too, runs the plain subpixel conv."""
    ref, got, carried = _both(*_setup(rng), jns_head=False, subpixel_deconvs=True)
    assert carried["weights"]["deconv2"].shape[:2] == (2, 2)
    assert_head_rounding_only(got.numpy().transpose(3, 0, 1, 2),
                              np.asarray(ref).transpose(3, 0, 1, 2), _head_vh(carried))


def test_nibble_packing_matches_jax(rng):
    q = rng.randint(-8, 8, (2, 3, 5, 8)).astype(np.int8)
    packed = tq.pack_nibbles(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (2, 3, 5, 4)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_nibbles(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_nibbles(packed).numpy(), q)
    p = rng.randint(0, 256, (4, 7, 6)).astype(np.uint8)
    np.testing.assert_array_equal(tq.unpack_nibbles(torch.from_numpy(p)).numpy(),
                                  np.asarray(jq.unpack_nibbles(jnp.asarray(p))))


@pytest.mark.parametrize("act4_mode", ["packed", "s4"])
def test_act4_carriers_match_jax(rng, act4_mode):
    """The nibble-packed and the int8-valued 4-bit boundaries against JAX's
    forward in the same mode, and against each other: bit-equal."""
    setup = _setup(rng)
    ref, got, carried = _both(*setup, jns_head=False, act4=ACT4, act4_mode=act4_mode)
    assert_head_rounding_only(got.numpy().transpose(3, 0, 1, 2),
                              np.asarray(ref).transpose(3, 0, 1, 2), _head_vh(carried))
    other = "s4" if act4_mode == "packed" else "packed"
    _, fwd = tq.quantize_pose_resnet(_port_model(setup[1], 18), setup[2], jns_head=False,
                                     stem_s2d=False, subpixel_deconvs=False,
                                     phase_kernel=False, act4=ACT4, act4_mode=other,
                                     device="cpu")
    assert torch.equal(fwd(carried, torch.from_numpy(setup[3])), got)
    # the carrier really is packed: a uint8 boundary of half the channels
    runner = tq._Int8Runner(carried, act4=ACT4, act4_mode="packed")
    x8 = torch.randint(-127, 128, (1, 4, 4, 64), dtype=torch.int8)
    s = carried["act_scales"]["layer1_0.conv1.out"]
    h_q, _ = runner.block_out(x8, s, "layer1_0.conv2", x8, s, "layer1_0.out")
    assert h_q.dtype == torch.uint8 and h_q.shape[-1] == 32
    assert runner.unwrap(h_q, None)[0].shape[-1] == 64
