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
