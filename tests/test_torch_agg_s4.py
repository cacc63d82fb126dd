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


def _sext_nibbles(x):
    """csrc/int8_mma.cuh: sext_nibbles on uint32 words (low nibbles only)."""
    return (x | (((x & np.uint32(0x08080808)) * np.uint32(0x1E)) & np.uint32(0xFFFFFFFF))
            ).astype(np.uint32)


def _bytes(words):
    """uint32 words [...] -> their four int8 bytes [..., 4], little-endian."""
    return words.astype("<u4").view(np.int8).reshape(words.shape + (4,))


def b4_kernel_emulation(qagg, hm):
    """One launch of csrc/aggregation.cu's aggregation_w4_kernel on the CPU,
    block by block as the kernel walks it: the grid (J*N blocks of 256, bank
    blocks of 128, targets), each k-step's source plane and depth, the two
    TMA boxes (xq's rows and columns past J*N or S as zeros; the packed
    bank's 64-byte rows laid out in the 64-byte swizzle), each consumer
    thread's fragment words widened (sext_nibbles) and stored into its
    warpgroup's 128-byte-swizzled A tile, read back as the descriptor does,
    exact int32 sums, then res = acc * sv staged transposed and res + dia
    four outputs a thread."""
    xq = tagg._quantize(qagg, hm).numpy()  # [4, JN, S]
    _, jn, s = xq.shape
    wq4 = qagg["wq4"].numpy().reshape(12 * s, s // 2)
    sv, dv = qagg["sv"].numpy(), qagg["dv"].numpy()
    kpp = -(-s // 128)
    # the consumer threads: warpgroup, warp in it, gid, tig
    wg, wq, gid, tig = np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(4),
                                   indexing="ij")
    wg, wq, gid, tig = (a.reshape(-1) for a in (wg, wq, gid, tig))
    r0 = 64 * wg + 16 * wq + gid
    psw = (r0 >> 1) & 3
    out = np.full((4, jn, s), np.nan, np.float32)
    for nb in range(-(-jn // 256)):
        for ob in range(-(-s // 128)):
            n0, o0 = nb * 256, ob * 128
            for t in range(4):
                acc = np.zeros((128, 256), np.int64)
                for ks in range(3 * kpp):
                    p, kk = ks // kpp, (ks % kpp) * 128
                    src = p if p < t else p + 1
                    xbox = np.zeros((256, 128), np.int8)
                    rows, cols = min(256, jn - n0), min(128, s - kk)
                    xbox[:rows, :cols] = xq[src, n0:n0 + rows, kk:kk + cols]
                    pbox = np.zeros((128, 64), np.uint8)
                    r_lo = (t * 3 + p) * s + o0
                    prow = min(128, 12 * s - r_lo)
                    pcol = min(64, s // 2 - kk // 2)
                    pbox[:prow, :pcol] = wq4[r_lo:r_lo + prow, kk // 2:kk // 2 + pcol]
                    smem_p = np.zeros(128 * 64, np.uint8)  # 64-byte swizzle
                    for c in range(4):
                        phys = np.arange(128)[:, None] * 64 + 16 * (c ^ ((np.arange(128) >> 1) & 3)
                                                                 )[:, None] + np.arange(16)
                        smem_p[phys] = pbox[:, 16 * c:16 * c + 16]
                    a_tile = np.zeros((128, 128), np.int8)
                    slots = np.zeros((2, 64 * 128), np.int8)
                    for k32 in range(4):
                        off = r0 * 64 + 16 * (k32 ^ psw) + 4 * tig
                        word = lambda o: smem_p[o[:, None] + np.arange(4)].copy().view("<u4")[:, 0]
                        w0, w1 = word(off), word(off + 8 * 64)
                        frag = [_sext_nibbles(w0 & np.uint32(0x0F0F0F0F)),
                                _sext_nibbles(w1 & np.uint32(0x0F0F0F0F)),
                                _sext_nibbles((w0 >> 4) & np.uint32(0x0F0F0F0F)),
                                _sext_nibbles((w1 >> 4) & np.uint32(0x0F0F0F0F))]
                        # the warpgroup's slot, byte k of row r in chunk (k >> 4) ^ (r & 7)
                        rr = 16 * wq + gid
                        for h in range(2):
                            for dr, reg in ((0, 2 * h), (8, 2 * h + 1)):
                                at = ((rr + dr) * 128 + 16 * ((2 * k32 + h) ^ gid)
                                      + 4 * tig)[:, None] + np.arange(4)
                                slots[wg[:, None], at] = _bytes(frag[reg])
                    # the descriptor's reads
                    r, k = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
                    for g in range(2):
                        a_tile[64 * g:64 * g + 64] = slots[g][r * 128 + 16 * ((k >> 4) ^ (r & 7))
                                                               + (k & 15)]
                    acc += a_tile.astype(np.int64) @ xbox.astype(np.int64).T
                # the epilogue: res staged [m][o], then four outputs a thread
                acc32 = acc.astype(np.int32)
                o_idx = o0 + np.arange(128)
                svs = np.where(o_idx < s, sv[t, np.minimum(o_idx, s - 1)], 0).astype(np.float32)
                staged = (acc32.astype(np.float32) * svs[:, None]).T  # [m, o]
                for ml in range(256):
                    m = n0 + ml
                    if m >= jn:
                        continue
                    oc = slice(o0, min(o0 + 128, s))
                    dia = None
                    for p in range(3):
                        src = p if p < t else p + 1
                        d = xq[src, m, oc].astype(np.float32) * dv[t, p, oc]
                        dia = d if dia is None else dia + d
                    out[t, m, oc] = staged[ml, :oc.stop - o0] + dia
    j, n, v, _ = hm.shape
    return torch.from_numpy(out).reshape(v, j, n, s).permute(1, 2, 0, 3)


@pytest.mark.parametrize("j,n,s", [(5, 7, 96), (16, 32, 128), (3, 3, 160), (9, 33, 256)])
def test_b4_kernel_emulation_equals_plain(j, n, s):
    """B4's decomposition (the k-step -> (source plane, depth) map, the tile
    order, the boxes' zero fill past J*N and S, the packed tile's swizzle,
    the nibbles widened into wgmma's A tile in shared memory, the transposed
    staging and the dia epilogue) gives the plain version's output exactly:
    the CPU's check of the kernel's index arithmetic. J*N 35 with S 96
    (ragged tiles both ways, a k-step past S), J*N 512 with S 128, J*N 9 with
    S 160 (S no multiple of the 128-deep k-step), J*N 297 with S 256 (two
    J*N blocks, the second ragged, and two bank blocks)."""
    rs = np.random.RandomState(10 + s)
    bank = rs.uniform(0.0, 0.1, (12, s, s)).astype(np.float32)
    qagg = tagg.aggregation_device_params_s4(tq.quantize_aggregation_grouped_s4(bank), "cpu")
    hm = torch.from_numpy((rs.randn(j, n, 4, s) * 0.5).astype(np.float32))
    ref = tagg.aggregation_grouped_s4_plain(qagg, hm)
    got = b4_kernel_emulation(qagg, hm)
    assert got.shape == ref.shape and float(ref.std()) > 0
    assert torch.equal(got, ref)


def test_device_params_s4_fold_sv_once(bank):
    """aggregation_device_params_s4 folds sv = (x_scale / 3) * w_scale once,
    bit-equal to fold_sv (what the plain version folds per call)."""
    q = tagg.aggregation_device_params_s4(tq.quantize_aggregation_grouped_s4(bank), "cpu")
    assert q["sv"].dtype == torch.float32 and tuple(q["sv"].shape) == (4, S)
    assert q["sv"].is_contiguous()
    assert torch.equal(q["sv"], tagg.fold_sv({k: v for k, v in q.items() if k != "sv"}))
