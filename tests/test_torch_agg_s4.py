"""posetpu_torch's diag-split 4-bit aggregation (B4) against the JAX package:
quantization, the packed-order permute and the nibble packing exactly; the
plain version against ``aggregation_int4_apply_jns_grouped`` and the Pallas
kernel in interpret mode within 1 ulp (XLA may fuse ``res + x * dv`` chains
into FMAs; the port rounds every multiply and add on its own, which the CUDA
kernel reproduces). The bank is a plain U(0, 0.1) draw, the reference's
ChannelWiseFC init, not an identity-dominated one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.models import quant as jq  # noqa: E402
from posetpu.ops.heatmap import phase_index_tables  # noqa: E402
from posetpu.ops.pallas.aggregation import aggregation_grouped_pallas_s4  # noqa: E402
from posetpu_torch.models import quant as tq  # noqa: E402
from posetpu_torch.models.convert import from_jax_params  # noqa: E402
from posetpu_torch.ops import aggregation as tagg  # noqa: E402

S, J, N = 256, 4, 2


@pytest.fixture
def bank():
    return np.random.RandomState(7).uniform(0.0, 0.1, (12, S, S)).astype(np.float32)


def test_quantize_and_permute_s4_match_jax(bank):
    tables = phase_index_tables((16, 16), levels=2)
    ref0 = jq.quantize_aggregation_grouped_s4(jnp.asarray(bank))
    got0 = tq.quantize_aggregation_grouped_s4(bank)
    ref = jq.permute_aggregation_packed_s4(ref0, tables)
    got = tq.permute_aggregation_packed_s4(got0, tables)
    for r, g in ((ref0, got0), (ref, got)):
        assert set(g) == {"wq4", "w_scale", "dv", "x_scale"}
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)
    assert got["wq4"].dtype == np.int8 and np.abs(got["wq4"]).max() == 7


@pytest.mark.parametrize("shape", [(32,), (3, 5, 64), (4, 3, 8, 256)])
def test_nibble_pack_roundtrip_and_order(rng, shape):
    w = torch.from_numpy(rng.randint(-8, 8, shape).astype(np.int8))
    p = tagg.pack_nibbles_k(w)
    assert p.dtype == torch.uint8 and p.shape == shape[:-1] + (shape[-1] // 2,)
    assert torch.equal(tagg.unpack_nibbles_k(p), w)
    # byte b of a 32-deep k-block: k = b in the low nibble, k = 16 + b high
    row = w.reshape(-1, shape[-1])[0].numpy().astype(np.int32)
    byte = p.reshape(-1, shape[-1] // 2)[0].numpy().astype(np.int32)
    for b in (0, 5, 15):
        assert byte[b] == (row[b] & 0xF) | ((row[16 + b] & 0xF) << 4)
    if shape[-1] >= 64:
        assert byte[16 + 3] == (row[32 + 3] & 0xF) | ((row[48 + 3] & 0xF) << 4)
    with pytest.raises(ValueError):
        tagg.pack_nibbles_k(torch.zeros(3, 48, dtype=torch.int8))


def test_device_params_s4_are_nibble_packed(bank):
    q = tq.quantize_aggregation_grouped_s4(bank)
    dev = tagg.aggregation_device_params_s4(q, "cpu")
    assert dev["wq4"].dtype == torch.uint8 and tuple(dev["wq4"].shape) == (4, 3, S, S // 2)
    assert dev["wq4"].numel() * dev["wq4"].element_size() == 4 * 3 * S * S // 2
    np.testing.assert_array_equal(
        tagg.unpack_nibbles_k(dev["wq4"]).transpose(-1, -2).numpy(), q["wq4"])
    bad = dict(q, wq4=(q["wq4"].astype(np.int16) * 2).astype(np.int8))
    with pytest.raises(ValueError):
        tagg.aggregation_device_params_s4(bad, "cpu")


def test_aggregation_s4_matches_jax_kernel_and_xla(bank):
    qagg = jq.quantize_aggregation_grouped_s4(jnp.asarray(bank))
    hm = np.random.RandomState(8).rand(J, N, 4, S).astype(np.float32)
    ref_kernel = np.asarray(aggregation_grouped_pallas_s4(qagg, jnp.asarray(hm),
                                                          interpret=True))
    ref_xla = np.asarray(jq.aggregation_int4_apply_jns_grouped(qagg, jnp.asarray(hm)))

    # the JAX side's own bank, carried across (wq4, w_scale, dv, x_scale)
    carried = from_jax_params(
        {"q": {"weights": {}, "w_scales": {}, "biases": {}, "act_scales": {}},
         "qagg": jax.tree.map(np.asarray, qagg)}, "cpu")["qagg"]
    own = tagg.aggregation_device_params_s4(tq.quantize_aggregation_grouped_s4(bank), "cpu")
    for k in own:
        assert torch.equal(own[k], carried[k]), k

    got = tagg.aggregation_grouped_s4(carried, torch.from_numpy(hm))
    assert tuple(got.shape) == (J, N, 4, S) and got.dtype == torch.float32
    assert np.std(got.numpy()) > 0
    np.testing.assert_array_max_ulp(got.numpy(), ref_xla, maxulp=1)
    np.testing.assert_array_max_ulp(got.numpy(), ref_kernel, maxulp=1)


def test_aggregation_s4_close_to_the_float_bank(bank):
    """The 4-bit residual + exact diagonal stays near the float fusion
    (the 3-source mean of hm @ bank): within the quantization steps'
    worst-case sum, far inside the heatmap's range."""
    hm = np.random.RandomState(9).rand(J, N, 4, S).astype(np.float32)
    q = tagg.aggregation_device_params_s4(tq.quantize_aggregation_grouped_s4(bank), "cpu")
    got = tagg.aggregation_grouped_s4(q, torch.from_numpy(hm)).numpy()
    w = bank.reshape(4, 3, S, S)
    ref = np.zeros_like(got)
    for t in range(4):
        for p, src in enumerate([v for v in range(4) if v != t]):
            ref[:, :, t] += hm[:, :, src] @ w[t, p] / 3.0
    assert np.abs(got - ref).max() < 0.05 * np.abs(ref).max()
