"""The int8 trunk's requantize (ops/requant.py) on the CPU.

- the plain version of each form (the conv epilogue with and without ReLU,
  at an 8-bit and a 4-bit boundary; a block's tail over an 8-bit and a
  4-bit residual) equals the JAX package's ``_Int8Runner`` epilogue on the
  same int32 sums, bit for bit, edge values included (sums past 2^24 and
  near +-2^31, halves that round to even, the clamp limits);
- the int8 runner sends every requantize site of a forward through the
  wrapper, one call a site: ResNet-18 20 (12 conv epilogues, 8 block tails),
  ResNet-50 53 (37, 16), with every deconv and the head in the kernels;
- the wrapper raises on what the kernel does not take.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.models import quant as jq
from posetpu_torch.models import quant as tq
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.ops import requant as trq

M, C = 96, 24


def _sums(rng):
    """int32 sums [M, C]: a wide random spread, with edge rows appended
    (+-2^31 ends, values past 2^24 that round on their way to f32)."""
    acc = rng.randint(-60_000, 60_000, (M, C)).astype(np.int32)
    acc[0] = np.iinfo(np.int32).max - np.arange(C)
    acc[1] = np.iinfo(np.int32).min + np.arange(C)
    acc[2] = 2 ** 24 + 1 + 2 * np.arange(C)
    acc[3] = -(2 ** 24) - 3 - 2 * np.arange(C)
    return acc


def _site(rng):
    """Per-channel weight scales and biases, an input and an output scale,
    scaled so most values land inside the int8 range and some beyond."""
    ws = rng.uniform(0.5, 2.0, C).astype(np.float32)
    b = rng.uniform(-40, 40, C).astype(np.float32)
    return ws, b, np.float32(1e-3), np.float32(0.5)


def _jax_runner(s_out, name, act4, acc):
    """The JAX package's runner whose conv returns ``acc``: its qchain and
    conv_f32 then run exactly its epilogue."""
    runner = jq._Int8Runner({"act_scales": {name: jnp.float32(s_out)}},
                            act4=(name,) if act4 else (), act4_mode="s4")
    runner._conv_q = lambda h_q, site, **kw: jnp.asarray(acc)
    return runner


def _qp(ws, b):
    return {"weights": {"c": None}, "w_scales": {"c": jnp.asarray(ws)},
            "biases": {"c": jnp.asarray(b)}}


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("act4", [False, True])
def test_conv_epilogue_plain_equals_jax(rng, relu, act4):
    acc = _sums(rng)
    ws, b, s_h, s_out = _site(rng)
    runner = _jax_runner(s_out, "c.out", act4, acc)
    runner.q.update(_qp(ws, b))
    ref, s_ref = runner.qchain(None, jnp.float32(s_h), "c", relu=relu)
    ref = np.asarray(ref.astype(jnp.int8))

    t = torch.from_numpy
    s_t = t(np.asarray(s_out))
    scale, hi = (s_t * (127.0 / 7.0), 7) if act4 else (s_t, 127)
    got = trq.requant_plain(t(acc), t(np.asarray(s_h)) * t(ws), t(b), 1.0 / scale, hi, relu)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(scale) == float(s_ref)
    assert {int(got.min()), int(got.max())} == {0 if relu else -hi, hi}


@pytest.mark.parametrize("act4_out", [False, True])
@pytest.mark.parametrize("act4_in", [False, True])
def test_block_tail_plain_equals_jax(rng, act4_out, act4_in):
    """The tail over an 8-bit or a 4-bit residual (the block input at 4 bits
    is int8 values in [-7, 7] at 127/7 times the scale), to an 8-bit or a
    4-bit boundary."""
    acc = _sums(rng)
    ws, b, s_m, s_out = _site(rng)
    hi_in = 7 if act4_in else 127
    r = rng.randint(-hi_in, hi_in + 1, (M, C)).astype(np.int8)
    r_s = np.float32(0.37 * (127.0 / 7.0) if act4_in else 0.37)
    runner = _jax_runner(s_out, "blk.out", act4_out, acc)
    runner.q.update(_qp(ws, b))
    y = runner.conv_f32(None, jnp.float32(s_m), "c")
    r_j = jnp.asarray(r).astype(jnp.int4) if act4_in else jnp.asarray(r)
    ref, _ = runner.requant(jax.nn.relu(y + runner.dequant(r_j, jnp.float32(r_s))), "blk.out")
    ref = np.asarray(ref.astype(jnp.int8))

    t = torch.from_numpy
    s_t = t(np.asarray(s_out))
    scale, hi = (s_t * (127.0 / 7.0), 7) if act4_out else (s_t, 127)
    got = trq.requant_plain(t(acc), t(np.asarray(s_m)) * t(ws), t(b), 1.0 / scale, hi,
                            residual=t(r), r_scale=t(np.asarray(r_s)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.max()) == hi


def test_ties_round_half_to_even():
    """Sums that land on x.5 round to the even integer, and the clamp
    limits hold at +-127.5 and +-7.5, as torch.round and jnp.round do."""
    acc = torch.arange(-130, 130, dtype=torch.int32).reshape(-1, 2)
    sv, bias, inv = torch.ones(2), torch.full((2,), 0.5), torch.tensor(1.0)
    for hi in (127, 7):
        got = trq.requant_plain(acc, sv, bias, inv, hi, relu=False)
        want = np.clip(np.round(acc.numpy() + 0.5), -hi, hi)
        np.testing.assert_array_equal(got.numpy(), want)
        ref = jnp.clip(jnp.round(jnp.asarray(acc.numpy(), jnp.float32) + 0.5), -hi, hi)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("num_layers,sites,tails", [(18, 20, 8), (50, 53, 16)])
def test_runner_sends_every_site_through_the_wrapper(monkeypatch, num_layers, sites, tails):
    """The serving forward (deconv0 through B2, deconv1 + deconv2 + head
    through B1, act4 at layer1 and layer2): one wrapper call a trunk site,
    a residual at each block's tail, and the heatmaps those calls give."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    model = PoseResNet(num_layers=num_layers).eval()
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    act4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
        f"layer2_{i}.out" for i in range(4))
    q, fwd = tq.quantize_pose_resnet(model, calib, jns_head="phase", phase_kernel=2,
                                     stem_s2d="pre", subpixel_deconvs={"deconv0"},
                                     act4=act4, act4_mode="s4", device="cpu")
    x = torch.from_numpy(rng.randint(-127, 128, (2, 32, 32, 12)).astype(np.int8))
    ref = fwd(q, x)
    calls = []
    real = trq.requant

    def counted(acc, *a, **kw):
        calls.append((tuple(acc.shape), kw.get("residual") is not None))
        return real(acc, *a, **kw)

    monkeypatch.setattr(trq, "requant", counted)
    assert torch.equal(fwd(q, x), ref)
    assert len(calls) == sites
    assert sum(res for _, res in calls) == tails


def test_wrapper_checks_before_the_card():
    """On the CPU a tail without ReLU is refused; the rest runs plain."""
    acc = torch.zeros(4, 8, dtype=torch.int32)
    one = torch.tensor(1.0)
    with pytest.raises(ValueError, match="ReLU"):
        trq.requant(acc, torch.ones(8), torch.zeros(8), one, relu=False,
                    residual=torch.zeros(4, 8, dtype=torch.int8), r_scale=one)
    before = trq.requant.launches
    assert torch.equal(trq.requant(acc, torch.ones(8), torch.zeros(8), one),
                       torch.zeros(4, 8, dtype=torch.int8))
    assert trq.requant.launches == before
