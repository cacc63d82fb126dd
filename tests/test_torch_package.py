"""The port stands alone: posetpu_torch and chip_smoke.py import neither JAX,
Flax, optax, orbax nor the JAX package, and importing the kernel build
helper needs no CUDA toolkit."""

from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "posetpu_torch"


def _modules():
    import posetpu_torch

    return ["posetpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(posetpu_torch.__path__, "posetpu_torch."))


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert {"posetpu_torch.serving", "posetpu_torch.models.quant",
            "posetpu_torch.core.inference", "posetpu_torch.ops.heatmap",
            "posetpu_torch.ops.phase_tail", "posetpu_torch.ops.aggregation",
            "posetpu_torch.ops.decode", "posetpu_torch.ops.resblock",
            "posetpu_torch.ops.deconv", "posetpu_torch.ops.warp",
            "posetpu_torch.core.losses", "posetpu_torch.core.evaluate",
            "posetpu_torch.geometry.fundamental", "posetpu_torch.train.state",
            "posetpu_torch.train.optim", "posetpu_torch.train.step",
            "posetpu_torch.train.checkpoint", "posetpu_torch.utils.gradients",
            "posetpu_torch.core.mi", "posetpu_torch.models.discriminators",
            "posetpu_torch.train.gan", "posetpu_torch.geometry.body",
            "posetpu_torch.geometry.pictorial", "posetpu_torch.data.h5io",
            "posetpu_torch.data.h36m", "posetpu_torch.data.registry",
            "posetpu_torch.pseudo.labeler", "posetpu_torch.cli.common",
            "posetpu_torch.cli.triangulate", "posetpu_torch.cli.rpsm",
            "posetpu_torch.cli.pseudo_labels", "posetpu_torch.utils.logging",
            "posetpu_torch.utils.checks", "posetpu_torch.utils.profiling",
            "posetpu_torch.utils.vis", "posetpu_torch.data.zipreader",
            "posetpu_torch.data.base", "posetpu_torch.data.mpii", "posetpu_torch.data.coco",
            "posetpu_torch.data.mixed", "posetpu_torch.data.loader",
            "posetpu_torch.data.prepare", "posetpu_torch.train.loop",
            "posetpu_torch.cli.train", "posetpu_torch.train.qat", "posetpu_torch.train.serve",
            "posetpu_torch.models.convert_torch", "posetpu_torch.cli.validate",
            "posetpu_torch.cli.convert", "posetpu_torch.parallel",
            "posetpu_torch.parallel.mesh", "posetpu_torch.parallel.batchnorm",
            "posetpu_torch.utils.pose_utils",
            "posetpu_torch.cli.generate", "posetpu_torch.cli.diagnostics",
            "posetpu_torch.cli.pipeline"} <= set(mods)
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'posetpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|posetpu)\b"
                        r"|\bposetpu\.", re.MULTILINE)


def test_every_module_imports_with_h5py_and_cv2_blocked():
    """h5py is imported where an H5 file is read or written, and cv2 where
    an image is decoded, warped or drawn, so the package imports where they
    are absent."""
    code = ("import sys, importlib\n"
            "for m in ('h5py', 'cv2'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("module", ["posetpu_torch.models.pose_resnet",
                                    "posetpu_torch.parallel.mesh",
                                    "posetpu_torch.parallel.batchnorm"])
def test_model_and_mesh_layers_import_nothing_of_train(module):
    """The layers depend downwards: the model and the data mesh import
    nothing of train/ (the steps import them, never the reverse)."""
    code = (f"import sys, importlib\nimportlib.import_module({module!r})\n"
            "print(sorted(m for m in sys.modules if m.startswith('posetpu_torch.train')))\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "[]", (r.stdout, r.stderr)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_package_reference(path):
    hits = [m.group(0) for m in _FORBIDDEN.finditer((ROOT / path).read_text())]
    assert not hits, f"{path}: {hits}"


def test_every_kernel_source_has_a_wrapper_module():
    """Each csrc/*.cu is built by the ops module of the same name (requant.cu
    by ops/requant.py, the int8 trunk's requantize); tail2.cu by
    ops/phase_tail.py, whose launcher its wrappers (B1, B2, B5, B6) and
    ops/deconv.py's (B9a, B9b) call."""
    sources = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert sources == ["aggregation", "decode", "requant", "resblock", "tail2"]
    for name in sources:
        text = (PKG / "ops" / f"{ {'tail2': 'phase_tail'}.get(name, name)}.py").read_text()
        assert f'_build.load("{name}"' in text, name
    assert "launch_tail2(" in (PKG / "ops" / "deconv.py").read_text()


def test_build_helper_imports_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent")
    r = _run("import posetpu_torch.ops._build as b; print(b.BUILD_DIR.name)", env=env)
    assert r.returncode == 0 and r.stdout.strip() == "kernels", r.stderr


def test_entry_points_refuse_a_missing_gpu():
    import torch

    from posetpu_torch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_training_entry_points_refuse_a_missing_gpu():
    import torch

    from posetpu_torch.config import default_config
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_eval_step, make_train_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.HEATMAP_SIZE = [16, 16]
    model = get_multiview_pose_net(cfg)
    tx = make_optimizer(cfg, steps_per_epoch=10)
    for build in (lambda: make_train_step(model, cfg, tx), lambda: init_train_state(model, tx),
                  lambda: make_eval_step(model, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert init_train_state(model, tx, device="cpu").step == 0
    for build in (lambda: make_train_step(model, cfg, tx, mesh=object(), device="cpu"),
                  lambda: make_eval_step(model, cfg, mesh=object(), device="cpu")):
        with pytest.raises(TypeError, match="DataMesh"):
            build()


def test_adversarial_entry_points_refuse_a_missing_gpu():
    import torch

    from posetpu_torch.config import default_config
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.gan import init_discriminator_states, make_adversarial_train_step
    from posetpu_torch.train.optim import make_optimizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.HEATMAP_SIZE = [16, 16]
    cfg.LOSS.USE_DOMAIN_TRANSFER_LOSS = True
    cfg.LOSS.USE_VIEW_MI_LOSS = True
    model = get_multiview_pose_net(cfg)
    critics = build_discriminators(cfg)
    tx = make_optimizer(cfg, steps_per_epoch=10)
    tx_d = {n: make_optimizer(cfg, 10, discriminator=True) for n in critics}
    for build in (lambda: make_adversarial_train_step(model, critics, cfg, tx, tx_d),
                  lambda: init_discriminator_states(critics, tx_d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    states = init_discriminator_states(critics, tx_d, device="cpu")
    assert set(states) == {"domain_discriminator", "view_discriminator"}
    assert all(st.step == 0 and st.opt_state["count"] == 0 for st in states.values())
    with pytest.raises(TypeError, match="DataMesh"):
        make_adversarial_train_step(model, critics, cfg, tx, tx_d, mesh=object(), device="cpu")


def test_3d_entry_points_refuse_a_missing_gpu(tmp_path):
    import numpy as np
    import torch

    from posetpu_torch.cli import pseudo_labels, rpsm, triangulate
    from posetpu_torch.config import default_config
    from posetpu_torch.data.synthetic import make_camera_ring, tile_cameras
    from posetpu_torch.pseudo import mint_pseudo_labels

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cams = tile_cameras(make_camera_ring(), 1).map(lambda x: x.reshape((4,) + x.shape[2:]))
    cfg = default_config()
    for call in (lambda: mint_pseudo_labels(np.zeros((4, 16, 2), np.float32),
                                            np.ones((4, 16), np.float32), cams,
                                            str(tmp_path / "out")),
                 lambda: triangulate.run(cfg),
                 lambda: rpsm.run(cfg, str(tmp_path / "hm.h5")),
                 lambda: pseudo_labels.run(cfg, str(tmp_path / "hm.h5"), "exp.yaml")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "out").exists()
