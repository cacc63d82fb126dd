"""posetpu_torch.train.serve against posetpu.train.serve on the CPU:
ResNet-18 MultiViewPose variables (tests/test_torch_serving_jns.np_variables,
the bank at S = 256), 64x64 crops and 16x16 maps of the synthetic H36M
image fixture (data/synthetic.write_image_fixture), one batch of two
groups prepared once and handed to both; the JAX side of the bit-for-bit
comparisons under ``jax.disable_jit()``.

- ``make_quant_eval_step`` on JAX's qparams carried across
  (convert.from_jax_params), flip test off and on (and on with the act4
  boundaries and a subpixel deconv0): without the bank maxvals,
  heatmaps and the preds of every map whose maximum is > 0 equal bit for
  bit (JAX's decode nudges a map whose maximum is <= 0, the port's does not,
  as the reference; ROADMAP C); with the bank (fuse routing on, its
  product in bf16 on both sides, bmm against XLA's dot) the heatmaps within
  one bf16 step of the largest fused value, so a joint whose two best
  pixels lie closer moves (stated in the test);
- ``build_quant_from_variables``' PTQ qparams against JAX's, plain, with
  act4 l12 and with ``subpixel_deconvs={"deconv0"}``: int8 weights, weight
  scales and biases equal, activation scales within
  tests/test_torch_quant.py's calibration bound (rtol 1e-5, 8.7e-7
  measured: the float convs sum in another order);
- with ``qat_batches``: both sides from one calibration, the steps in
  float64 and JAX's jitted (tests/test_torch_qat.py says why): the int8
  weights, weight scales and biases equal, as there;
- subpixel deconvs with QAT raise; act4 with QAT serves QAT's trunk without
  act4, as the JAX package does."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.config import default_config as jax_config
from posetpu.train import qat as jqat
from posetpu.train import serve as jserve
from posetpu_torch.config import default_config
from posetpu_torch.data import registry as tregistry
from posetpu_torch.data.loader import GroupLoader
from posetpu_torch.data.prepare import make_prepare_fn
from posetpu_torch.data.synthetic import write_image_fixture
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_params, from_jax_variables
from posetpu_torch.models.pose_resnet import get_pose_net
from posetpu_torch.train import qat as tqat
from posetpu_torch.train import serve as tserve
from tests.test_torch_qat import _f64, _patch_jax_qat
from tests.test_torch_serving_jns import np_variables

ACT4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(f"layer2_{i}.out" for i in range(4))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_variables(variables) -> dict:
    """Flax variables (numpy) -> the port's {"params", "batch_stats"}, as
    cli/common.load_model_variables gives them."""
    sd = from_jax_variables(variables)
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    return {"params": {k: v for k, v in sd.items() if k not in stats}, "batch_stats": stats}


def _cfgs(root, **over):
    out = []
    for make in (jax_config, default_config):
        c = make()
        c.DATASET.ROOT, c.DATASET.DATA_FORMAT = str(root), "zip"
        c.DATASET.TEST_DATASET = "multiview_h36m"
        c.NETWORK.IMAGE_SIZE, c.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
        c.POSE_RESNET.NUM_LAYERS = 18
        c.NETWORK.AGGRE = True
        c.TEST.BATCH_SIZE = 2
        for k, v in over.items():
            sec, key = k.split(".")
            setattr(getattr(c, sec), key, v)
        out.append(c)
    return out


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this module runs: under a parallel test
    run, eight a process oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    """One validation batch of two groups (prepared on the CPU, as numpy),
    the calibration images, the variables, the data set's flip pairs, and a
    cache of the JAX package's builds."""
    root = tmp_path_factory.mktemp("serve")
    write_image_fixture(str(root), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=4, mpii_valid=4, h36m_train_groups=2, h36m_valid_groups=2,
                        seed=7)
    _, tcfg = _cfgs(root)
    ds = tregistry.get_dataset("multiview_h36m")(tcfg, "validation", False)
    host = next(iter(GroupLoader(ds, 2, shuffle=False, drop_last=False, prefetch=0,
                                 num_threads=1)))
    batch = {k: v.numpy() for k, v in make_prepare_fn(tcfg, "cpu")(host).items()}
    calib = [batch["images"].reshape((-1, 64, 64, 3))]
    variables = np_variables(np.random.RandomState(0))
    return SimpleNamespace(root=root, batch=batch, calib=calib, variables=variables,
                           flip_pairs=ds.flip_pairs, jax_builds={})


def _jax_build(h36m, jcfg, subpixel=False, act4=()):
    """The JAX package's build_quant_from_variables (qparams, qfwd, bank),
    once for each (subpixel, act4)."""
    key = (frozenset(subpixel or ()), tuple(act4))
    if key not in h36m.jax_builds:
        h36m.jax_builds[key] = jserve.build_quant_from_variables(
            jcfg, h36m.variables, h36m.calib, subpixel_deconvs=subpixel, act4=act4)
    return h36m.jax_builds[key]


def _eval_steps(h36m, aggre, flip, act4=(), subpixel=False):
    """(JAX eval step, JAX qvars, port eval step, port qvars): JAX's
    build_quant_from_variables' qparams on both sides."""
    over = {"NETWORK.AGGRE": aggre, "TEST.FUSE_OUTPUT": aggre, "TEST.FLIP_TEST": flip,
            "TEST.SHIFT_HEATMAP": flip, "TEST.POST_PROCESS": True}
    jcfg, tcfg = _cfgs(h36m.root, **over)
    jqp, jfwd, _ = _jax_build(h36m, jcfg, subpixel, act4)
    jbank = h36m.variables["params"]["aggre_layer"]["weight"] if aggre else None
    jstep = jserve.make_quant_eval_step(jfwd, jcfg, flip_pairs=h36m.flip_pairs,
                                        has_aggre=aggre)
    tv = port_variables(h36m.variables)
    _, tfwd, tbank = tserve.build_quant_from_variables(
        tcfg, tv, h36m.calib, subpixel_deconvs=subpixel, act4=act4, device="cpu")
    assert (tbank is not None) is aggre
    if aggre:
        assert tbank.dtype == torch.bfloat16
        torch.testing.assert_close(tbank, torch.from_numpy(np.asarray(jbank)).bfloat16(),
                                   rtol=0, atol=0)
    tstep = tserve.make_quant_eval_step(tfwd, tcfg, flip_pairs=h36m.flip_pairs,
                                        has_aggre=aggre, device="cpu")
    tq_ = from_jax_params({"q": _np_tree(jqp)}, "cpu")["q"]
    return jstep, {"q": jqp, "bank": jbank}, tstep, {"q": tq_, "bank": tbank}


def _assert_preds(got, ref, batch, hm, bound=0.0):
    """Where a map's maximum is > 0 the joints decode alike, but where the
    heatmaps may differ by ``bound``: a map whose two best pixels, or the
    neighbours that set the quarter-pixel nudge's sign, lie within 2 bound
    of each other. Where it is <= 0 the port decodes (0, 0) with no nudge,
    as B7 and the reference do (JAX's channels-last decode nudges it; ROADMAP
    C)."""
    maxvals = ref["maxvals"]
    pos = maxvals > 0
    n, v, h, w, j = hm.shape
    maps = np.moveaxis(hm, -1, 2).reshape(n, v, j, h * w)
    top2 = np.sort(maps, axis=-1)[..., -2:]
    unsure = top2[..., 1] - top2[..., 0] <= 2 * bound
    py, px = np.divmod(maps.argmax(-1), w)
    inner = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    m2 = maps.reshape(n, v, j, h, w)
    at = lambda dy, dx: np.take_along_axis(  # noqa: E731
        m2.reshape(n, v, j, h * w),
        (np.clip(py + dy, 0, h - 1) * w + np.clip(px + dx, 0, w - 1))[..., None], -1)[..., 0]
    unsure |= inner & ((np.abs(at(0, 1) - at(0, -1)) <= 2 * bound)
                       | (np.abs(at(1, 0) - at(-1, 0)) <= 2 * bound))
    sure = pos & ~unsure
    assert sure.sum() >= 16, sure.sum()  # the check is not vacuous
    np.testing.assert_array_equal(got["preds"][sure], ref["preds"][sure])
    origin = tserve.final_preds(torch.zeros(n, v, j, h, w), torch.from_numpy(batch["center"]),
                                torch.from_numpy(batch["scale"]))[0].numpy()
    np.testing.assert_array_equal(got["preds"][~pos], origin[~pos])


@pytest.mark.parametrize("flip,variant", [
    (False, {}), (True, {}), (True, {"act4": ACT4, "subpixel": {"deconv0"}})],
    ids=["plain", "flip", "flip_act4_subpixel"])
def test_quant_eval_step_without_bank_is_bitexact(h36m, flip, variant):
    jstep, jvars, tstep, tvars = _eval_steps(h36m, False, flip, **variant)
    with jax.disable_jit():
        ref = {k: np.asarray(v) for k, v in jstep(jvars, h36m.batch).items()}
    got = {k: v.numpy() for k, v in tstep(tvars, h36m.batch).items()}
    assert set(got) == set(ref)
    assert got["preds"].shape == (2, 4, 16, 2) and got["heatmaps"].shape == (2, 4, 16, 16, 16)
    assert float(got["loss"]) == float(got["acc"]) == 0.0
    assert np.std(got["heatmaps"]) > 0
    for k in ("maxvals", "heatmaps"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _assert_preds(got, ref, h36m.batch, ref["heatmaps"])


@pytest.mark.parametrize("flip", [False, True])
def test_quant_eval_step_with_bank_matches_jax(h36m, flip):
    """The bank's bf16 product sums in another order (torch.bmm against
    XLA's dot), and a sum near a bf16 rounding boundary rounds to the other
    neighbour: each fused value within one bf16 step (2^-7 relative) of the
    largest, times the routing's 0.6 (2.5e-3 of the largest measured with
    the flip test, equal without); maxvals within the same, and the preds
    as :func:`_assert_preds` says."""
    jstep, jvars, tstep, tvars = _eval_steps(h36m, True, flip)
    with jax.disable_jit():
        ref = {k: np.asarray(v) for k, v in jstep(jvars, h36m.batch).items()}
    got = {k: v.numpy() for k, v in tstep(tvars, h36m.batch).items()}
    bound = 0.6 * 2.0 ** -7 * np.abs(ref["heatmaps"]).max()
    np.testing.assert_allclose(got["heatmaps"], ref["heatmaps"], rtol=0, atol=bound)
    np.testing.assert_allclose(got["maxvals"], ref["maxvals"], rtol=0, atol=bound)
    _assert_preds(got, ref, h36m.batch, ref["heatmaps"], bound)


def test_build_quant_ptq_qparams_match_jax(h36m):
    jcfg, tcfg = _cfgs(h36m.root)
    tv = port_variables(h36m.variables)
    for kw in ({}, {"act4": ACT4}, {"subpixel": {"deconv0"}}):
        ref = _np_tree(_jax_build(h36m, jcfg, **kw)[0])
        got = tserve.build_quant_from_variables(
            tcfg, tv, h36m.calib, subpixel_deconvs=kw.get("subpixel", False),
            act4=kw.get("act4", ()), device="cpu")[0]
        assert set(got) == set(ref) == {"weights", "w_scales", "biases", "act_scales"}
        for part in ("weights", "w_scales", "biases", "act_scales"):
            assert set(got[part]) == set(ref[part]), (kw, part)
        for k in ref["weights"]:
            for part in ("weights", "w_scales", "biases"):
                np.testing.assert_array_equal(got[part][k].numpy(), ref[part][k],
                                              err_msg=(kw, part, k))
        for k, v in ref["act_scales"].items():
            np.testing.assert_allclose(float(got["act_scales"][k]), float(v), rtol=1e-5,
                                       err_msg=(kw, k))


def test_build_quant_with_qat_matches_jax(h36m, monkeypatch):
    """Two QAT steps of two images through each package's
    build_quant_from_variables, both from the port's calibration, the
    steps in float64: the int8 weights, their scales and the biases equal
    (tests/test_torch_qat.py's float64 bounds)."""
    jcfg, tcfg = _cfgs(h36m.root)
    qat = [h36m.calib[0][:2], h36m.calib[0][2:4]]
    tv = port_variables(h36m.variables)
    resnet = get_pose_net(tcfg)
    resnet.load_state_dict({k[len("resnet."):]: v for part in tv.values()
                            for k, v in part.items() if k.startswith("resnet.")})
    folded, scales = tq.calibrate(resnet, h36m.calib, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_qat(mp)
        mp.setattr(jqat, "calibrate", lambda model, variables, batches: (
            _f64(folded), dict(scales)))
        with jax.enable_x64():
            ref = _np_tree(jserve.build_quant_from_variables(
                jcfg, h36m.variables, h36m.calib,
                qat_batches=[b.astype(np.float64) for b in qat])[0])
    monkeypatch.setattr(tqat, "calibrate", lambda model, batches, device: (
        _f64(folded), scales))
    got = tserve.build_quant_from_variables(tcfg, tv, h36m.calib, qat_batches=qat,
                                            device="cpu")[0]
    for part in ("weights", "w_scales", "biases"):
        assert set(got[part]) == set(ref[part])
        for k, v in ref[part].items():
            np.testing.assert_array_equal(got[part][k].numpy(), v, err_msg=(part, k))
    assert {k: float(v) for k, v in got["act_scales"].items()} == {
        k: float(v) for k, v in ref["act_scales"].items()}


def test_build_quant_qat_refuses_subpixel_and_drops_act4(h36m):
    _, tcfg = _cfgs(h36m.root)
    tv = port_variables(h36m.variables)
    qat = [h36m.calib[0]]
    with pytest.raises(ValueError, match="PTQ-only"):
        tserve.build_quant_from_variables(tcfg, tv, h36m.calib, qat_batches=qat,
                                          subpixel_deconvs={"deconv0"}, device="cpu")
    plain = tserve.build_quant_from_variables(tcfg, tv, h36m.calib, qat_batches=qat,
                                              device="cpu")
    with_act4 = tserve.build_quant_from_variables(tcfg, tv, h36m.calib, qat_batches=qat,
                                                  act4=ACT4, device="cpu")
    for part in ("weights", "w_scales", "biases", "act_scales"):
        for k, v in plain[0][part].items():
            assert torch.equal(with_act4[0][part][k], v), (part, k)
    x = torch.from_numpy(h36m.calib[0])
    assert torch.equal(with_act4[1](with_act4[0], x), plain[1](plain[0], x))
    # the PTQ trunk does store those boundaries at 4 bits
    ptq = tserve.build_quant_from_variables(tcfg, tv, h36m.calib, device="cpu")
    ptq4 = tserve.build_quant_from_variables(tcfg, tv, h36m.calib, act4=ACT4, device="cpu")
    assert not torch.equal(ptq4[1](ptq4[0], x), ptq[1](ptq[0], x))
