"""posetpu_torch.models.convert_torch against posetpu.models.convert_torch on
random checkpoints in the reference's layout: a ResNet-18 and a ResNet-50
MultiViewPose (tests/test_torch_oracle_full.make_resnet50_state's scales)
with a 12-pair bank at S = 256 and keys no module takes, saved as .pth.tar
in each envelope the reference writes. The port's variables are equal bit
for bit to ``from_jax_variables`` of JAX's conversion, the unused keys are
JAX's, ``drop_aggre`` and ``strict`` behave as JAX's, and
cli/common.load_model_variables reads the files."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from posetpu.models import convert_torch as jct
from posetpu_torch.cli.common import load_model_variables
from posetpu_torch.models import convert_torch as tct
from posetpu_torch.models.convert import from_jax_variables
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from tests.test_torch_oracle_full import _rand_bn, make_resnet50_state

S = 16 * 16
# keys no module takes, each mapped nowhere by both converters
STRAY = ("resnet.layer1.0.conv1.bias", "resnet.deconv_layers.2.weight",
         "resnet.final_layer.extra", "resnet.bn1.foo", "aggre_layer.scale")


def make_resnet18_state(rng, num_joints=16, prefix=""):
    """Random reference-layout state dict of a ResNet-18 (basic blocks)
    PoseResNet, at make_resnet50_state's scales."""
    st = {f"{prefix}conv1.weight": (rng.randn(64, 3, 7, 7) * 0.05).astype(np.float32)}
    _rand_bn(st, f"{prefix}bn1", 64, rng)
    inp = 64
    for s, planes in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            stride = 2 if (s > 1 and b == 0) else 1
            p = f"{prefix}layer{s}.{b}"
            st[f"{p}.conv1.weight"] = (rng.randn(planes, inp, 3, 3) * 0.05).astype(np.float32)
            _rand_bn(st, f"{p}.bn1", planes, rng)
            st[f"{p}.conv2.weight"] = (rng.randn(planes, planes, 3, 3) * 0.05).astype(np.float32)
            _rand_bn(st, f"{p}.bn2", planes, rng)
            if b == 0 and (stride != 1 or inp != planes):
                st[f"{p}.downsample.0.weight"] = (rng.randn(planes, inp, 1, 1) * 0.05
                                                  ).astype(np.float32)
                _rand_bn(st, f"{p}.downsample.1", planes, rng)
            inp = planes
    c = 512
    for i in (0, 3, 6):
        st[f"{prefix}deconv_layers.{i}.weight"] = (rng.randn(c, 256, 4, 4) * 0.05
                                                   ).astype(np.float32)
        _rand_bn(st, f"{prefix}deconv_layers.{i + 1}", 256, rng)
        c = 256
    st[f"{prefix}final_layer.weight"] = (rng.randn(num_joints, 256, 1, 1) * 0.05
                                         ).astype(np.float32)
    st[f"{prefix}final_layer.bias"] = rng.randn(num_joints).astype(np.float32)
    return st


def multiview_state(num_layers: int, seed: int, extras: bool = True) -> dict:
    """A reference MultiViewPose state dict (numpy): the trunk, the 12
    ChannelWiseFC weights U(0, 0.1), and with ``extras`` every
    BatchNorm's num_batches_tracked, torchvision's fc and the stray keys."""
    rng = np.random.RandomState(seed)
    make = make_resnet18_state if num_layers == 18 else make_resnet50_state
    st = make(rng, prefix="resnet.")
    for i in range(12):
        st[f"aggre_layer.aggre.{i}.weight"] = rng.uniform(0, 0.1, (S, S)).astype(np.float32)
    if extras:
        for k in [k for k in st if k.endswith("running_var")]:
            st[k[:-len("running_var")] + "num_batches_tracked"] = np.int64(7)
        st["resnet.fc.weight"] = rng.randn(10, 512).astype(np.float32)
        st["resnet.fc.bias"] = rng.randn(10).astype(np.float32)
        for k in STRAY:
            st[k] = rng.randn(3).astype(np.float32)
    return st


def envelope(state: dict, kind: str):
    """The object the reference's torch.save wrote."""
    sd = {k: torch.as_tensor(v) for k, v in state.items()}
    if kind == "raw":
        return sd
    if kind == "module":  # DDP's prefixes inside the training envelope
        return {"epoch": 3, "state_dict": {f"module.{k}": v for k, v in sd.items()},
                "perf": 0.5}
    return {kind: sd, "epoch": 3}


def _flat(variables) -> dict:
    return {**variables["params"], **variables["batch_stats"]}


def _assert_same(got: dict, ref: dict):
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _jax_side(path, drop_aggre=False):
    variables, unused = jct.convert_multiview(jct.load_torch_state(path), drop_aggre=drop_aggre)
    return from_jax_variables(variables), unused


@pytest.mark.parametrize("kind", ["raw", "state_dict", "state_dict_base_model", "module"])
def test_convert_multiview_r18_matches_jax_in_each_envelope(tmp_path, kind):
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save(envelope(multiview_state(18, 0), kind), path)
    ref, jax_unused = _jax_side(path)
    state = tct.load_torch_state(path)
    assert all(not k.startswith("module.") for k in state)
    variables, unused = tct.convert_multiview(state)
    _assert_same(_flat(variables), ref)
    assert unused == jax_unused
    assert sorted(unused) == sorted(k.removeprefix("resnet.") for k in STRAY)
    # the port's MultiViewPose takes the result as it is
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16)
    model.load_state_dict(_flat(variables))
    assert variables["params"]["aggre_layer.weight"].shape == (12, S, S)


def test_convert_multiview_r50_matches_jax(tmp_path):
    path = str(tmp_path / "final_state.pth.tar")
    torch.save(envelope(multiview_state(50, 1), "module"), path)
    ref, jax_unused = _jax_side(path)
    variables, unused = tct.convert_multiview(tct.load_torch_state(path))
    _assert_same(_flat(variables), ref)
    assert unused == jax_unused
    model = MultiViewPose(PoseResNet(num_layers=50), heatmap_size=16)
    model.load_state_dict(_flat(variables))


def test_drop_aggre_leaves_the_bank_out_as_jax(tmp_path):
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save(envelope(multiview_state(18, 2), "state_dict"), path)
    ref, jax_unused = _jax_side(path, drop_aggre=True)
    variables, unused = tct.convert_multiview(tct.load_torch_state(path), drop_aggre=True)
    _assert_same(_flat(variables), ref)
    assert unused == jax_unused
    assert "aggre_layer.weight" not in variables["params"]
    assert not any(k.startswith("aggre_layer.aggre") for k in unused)


def test_convert_pose_resnet_strict_and_unused_match_jax():
    state = {k: torch.as_tensor(v) for k, v in
             make_resnet18_state(np.random.RandomState(3)).items()}
    variables, unused = tct.convert_pose_resnet(state, strict=True)
    jvars, junused = jct.convert_pose_resnet({k: v.numpy() for k, v in state.items()},
                                             strict=True)
    _assert_same(_flat(variables), from_jax_variables(jvars))
    assert unused == junused == []
    PoseResNet(num_layers=18).load_state_dict(_flat(variables))
    state["stray.weight"] = torch.ones(2)
    with pytest.raises(ValueError, match="unconsumed torch keys"):
        tct.convert_pose_resnet(state, strict=True)
    with pytest.raises(ValueError, match="unconsumed torch keys"):
        jct.convert_pose_resnet({k: v.numpy() for k, v in state.items()}, strict=True)
    assert tct.convert_pose_resnet(state)[1] == ["stray.weight"]


@pytest.mark.parametrize("suffix", [".pth", ".pth.tar"])
def test_load_model_variables_reads_reference_checkpoints(tmp_path, suffix):
    """A MultiViewPose checkpoint, with and without the bank, and a bare
    PoseResNet one (nested under ``resnet.``), as JAX's reader gives them."""
    path = str(tmp_path / f"model{suffix}")
    torch.save(envelope(multiview_state(18, 4, extras=False), "state_dict"), path)
    for drop in (False, True):
        got = load_model_variables(path, drop_aggre=drop)
        _assert_same(_flat(got), _jax_side(path, drop)[0])
        assert ("aggre_layer.weight" in got["params"]) is not drop
    bare = str(tmp_path / f"bare{suffix}")
    torch.save(envelope(make_resnet18_state(np.random.RandomState(5)), "raw"), bare)
    got = load_model_variables(bare)
    ref = jct.convert_multiview({f"resnet.{k}": v
                                 for k, v in jct.load_torch_state(bare).items()})[0]
    _assert_same(_flat(got), from_jax_variables(ref))
    assert all(k.startswith("resnet.") for k in _flat(got))
