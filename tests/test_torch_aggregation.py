"""posetpu_torch.ops.aggregation (B3) against the JAX package's Pallas kernel
in interpret mode and its XLA grouped dot, on the same numpy inputs. The
bank is a plain U(0, 0.1) draw, the reference's ChannelWiseFC init (not an
identity-dominated one)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.models import quant as jq  # noqa: E402
from posetpu.ops.heatmap import phase_index_tables  # noqa: E402
from posetpu.ops.pallas.aggregation import aggregation_grouped_pallas  # noqa: E402
from posetpu_torch.models import quant as tq  # noqa: E402
from posetpu_torch.ops import aggregation as tagg  # noqa: E402

S, J, N = 256, 4, 2


@pytest.fixture
def bank():
    return np.random.RandomState(7).uniform(0.0, 0.1, (12, S, S)).astype(np.float32)


def test_quantize_and_permute_match_jax(bank):
    tables = phase_index_tables((16, 16), levels=2)
    ref = jq.permute_aggregation_packed(
        jq.quantize_aggregation_grouped(jnp.asarray(bank)), tables)
    got = tq.permute_aggregation_packed(tq.quantize_aggregation_grouped(bank), tables)
    for k in ("wq", "w_scale", "x_scale"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    dev = tagg.aggregation_device_params(got, "cpu")
    np.testing.assert_array_equal(dev["wq"].transpose(-1, -2).numpy(), np.asarray(ref["wq"]))


def test_aggregation_matches_jax_kernel_and_xla(bank):
    qagg = jq.quantize_aggregation_grouped(jnp.asarray(bank))
    hm = np.random.RandomState(8).rand(J, N, 4, S).astype(np.float32)
    ref_kernel = np.asarray(aggregation_grouped_pallas(qagg, jnp.asarray(hm),
                                                       interpret=True))
    ref_xla = np.asarray(jq.aggregation_int8_apply_jns_grouped(qagg, jnp.asarray(hm)))
    np.testing.assert_array_equal(ref_kernel, ref_xla)

    qt = tagg.aggregation_device_params(tq.quantize_aggregation_grouped(bank), "cpu")
    got = tagg.aggregation_grouped(qt, torch.from_numpy(hm))
    assert tuple(got.shape) == (J, N, 4, S) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref_kernel)
    assert np.std(got.numpy()) > 0


def quantize_kernel_emulation(hm, x_scale):
    """csrc/aggregation.cu:quantize_kernel on the CPU, thread by thread: thread
    e takes 16 values of output row r of view v (e = (v * JN + r) * S/16 +
    chunk) from hm row (r, v), clip(rint(f32(hm * f32(1 / x_scale))), -127,
    127)."""
    j, n, v, s = hm.shape
    jn, chunks = j * n, s // 16
    inv = np.float32(1.0) / np.float32(x_scale)
    flat = hm.reshape(jn * 4 * s)
    xq = np.zeros(4 * jn * s, np.int8)
    e = np.arange(4 * jn * chunks)
    ch, vr = e % chunks, e // chunks
    r, view = vr % jn, vr // jn
    src = ((r * 4 + view) * s + ch * 16)[:, None] + np.arange(16)
    q = np.clip(np.rint((flat[src] * inv).astype(np.float32)), -127, 127)
    xq[(vr * s + ch * 16)[:, None] + np.arange(16)] = q.astype(np.int8)
    return xq.reshape(4, jn, s)


def test_quantize_pass_equals_plain_and_xla_fusion(bank):
    """The one-pass quantize (its index arithmetic emulated), its plain
    version and the JAX wrapper's XLA fusion give the same int8 planes bit
    for bit, ties at .5 and values past the clip included."""
    rs = np.random.RandomState(9)
    qagg = tq.quantize_aggregation_grouped(bank)
    xs = np.float32(np.asarray(qagg["x_scale"]))
    hm = (rs.randn(J, N, 4, S) * 0.6).astype(np.float32)
    hm.reshape(-1)[:64] = (np.arange(64) - 32 + 0.5) * xs  # near-ties
    hm.reshape(-1)[64:72] = [2.0, -2.0, 1e3, -1e3, 0.0, -0.0, 127.5 * xs, -127.5 * xs]
    ref = jnp.moveaxis(jnp.clip(jnp.round(jnp.asarray(hm) * (1.0 / jnp.asarray(xs))),
                                -127, 127).astype(jnp.int8), 2, 0).reshape(4, J * N, S)
    qt = tagg.aggregation_device_params(qagg, "cpu")
    plain = tagg.quantize_heatmaps(qt, torch.from_numpy(hm))
    assert plain.dtype == torch.int8 and tuple(plain.shape) == (4, J * N, S)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(quantize_kernel_emulation(hm, xs), np.asarray(ref))
    assert len(np.unique(plain.numpy())) > 100


def test_sv_folded_once_equals_the_per_request_fold(bank):
    """aggregation_device_params folds sv = (x_scale / 3) * w_scale once; it
    equals the fold the JAX wrapper and the s4 bank's wrapper make per
    request."""
    qagg = jq.quantize_aggregation_grouped(jnp.asarray(bank))
    qt = tagg.aggregation_device_params(tq.quantize_aggregation_grouped(bank), "cpu")
    ref = ((qagg["x_scale"] / 3.0) * qagg["w_scale"]).reshape(4, S)
    assert qt["sv"].dtype == torch.float32 and tuple(qt["sv"].shape) == (4, S)
    np.testing.assert_array_equal(qt["sv"].numpy(), np.asarray(ref))
    assert torch.equal(tagg.fold_sv({k: v for k, v in qt.items() if k != "sv"}), qt["sv"])
