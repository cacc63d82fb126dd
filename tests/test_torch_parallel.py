"""Data parallelism (posetpu_torch/parallel/mesh.py) on the CPU: gloo groups
of W processes run the port's train, eval and adversarial steps, each rank
on its own rows of one global batch, and are held against the port's single
process on the joined batch and against the JAX package's step under
``data_mesh(2)`` with ``shard_batch``.

The setup is tests/test_torch_train.py's: ResNet-18 with the bank, 64x64
images, 16x16 heatmaps, MSE + consistency + fundamental loss and the
grad-norm probe, four four-view groups (two of them h36m), the weights
carried from numpy Flax variables by models/convert.from_jax_variables.

One group of W=2 and one of W=4 are spawned for the whole module (at the
same time, while this process computes the references); the W=2 processes
then run the train and validate CLIs over two processes; the tests read
what they wrote. Each child has a timeout on its collectives and is joined
with one; a child that fails sends its traceback back.

- W=2 and W=4, float64 without the bank (MSE + fundamental + the probe),
  two steps: the loss, every metric and the all-reduced gradients of step
  1 within 1e-10 of each tensor's largest entry, the parameters and BN
  running statistics after step 2 too; the ranks' parameters bit-equal
  after 2 steps; W=2 with the bank and the consistency loss, one step: the
  metrics within 1e-10, the gradients within 1e-7 (an f32 boundary, stated
  in the test);
- W=2, float32, one step: the loss within rtol 1e-4 of the single process
  and of JAX's ``data_mesh(2)`` step, PCK within rtol 1e-5 of JAX's;
- W=2 eval step (flip test): preds, maxvals and heatmaps gathered in rank
  order, within 1e-4 of the single process; against JAX's sharded eval
  step the preds within 1e-4 px and the loss within rtol 1e-4;
- W=2 adversarial step in float64, five critics, parity 0 with draws given
  and parity 1 with the step's own draws from the shared seed: within
  tests/test_torch_gan_f64.py's bounds of the single process; every
  critic's parameters bit-equal across ranks;
- the mesh helpers: shard_batch's rows, replicate, the global BatchNorm
  against F.batch_norm on one process, a mesh that is not a DataMesh
  refused.
"""

from __future__ import annotations

import hashlib
import os
import queue
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from posetpu_torch.config import default_config
from posetpu_torch.core.mi import sample_draws
from posetpu_torch.models.discriminators import build_discriminators
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.parallel import batchnorm as pbn
from posetpu_torch.parallel import mesh as pmesh
from posetpu_torch.train.checkpoint import CheckpointManager
from posetpu_torch.train import gan as tgan
from posetpu_torch.train import step as tstep
from posetpu_torch.train.optim import make_optimizer
from posetpu_torch.train.state import TrainState

N = 4  # groups of the global batch
FLIP_PAIRS = [(0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)]
LOSS = dict(USE_CONSISTENT_LOSS=True, USE_FUNDAMENTAL_LOSS=True, WATCH_GRAD_NORM=True)
GAN_LOSS = ("USE_LOCAL_MI_LOSS", "USE_DOMAIN_TRANSFER_LOSS", "USE_VIEW_MI_LOSS",
            "USE_JOINTS_MI_LOSS", "USE_HEATMAP_MI_LOSS")
JOIN_S = 600  # the longest a group may take


# ------------------------------------------------------------ the setup


def port_cfg(gan: bool = False, aggre: bool = True):
    c = default_config()
    c.NETWORK.IMAGE_SIZE = np.array([64, 64])
    c.NETWORK.HEATMAP_SIZE = np.array([16, 16])
    c.POSE_RESNET.NUM_LAYERS = 18
    c.NETWORK.AGGRE = aggre
    c.TRAIN.LR = 1e-4
    for k, v in LOSS.items():
        setattr(c.LOSS, k, v)
    c.LOSS.USE_CONSISTENT_LOSS = aggre
    if gan:
        c.LOSS.SPECIFIC = "joint"
        c.LOSS.MI_MEASURE = "JSD"
        c.LOCAL_DISCRIMINATOR.OUTPUT_CHANNELS = 256
        # the probe over the mesh is the supervised step's, held there; here
        # it would make the f64 step half as long again
        c.LOSS.WATCH_GRAD_NORM = False
        for k in GAN_LOSS:
            setattr(c.LOSS, k, True)
    return c


def model_of(sd: dict, dtype, aggre: bool = True) -> MultiViewPose:
    m = MultiViewPose(PoseResNet(num_layers=18, dtype=dtype),
                      heatmap_size=16 if aggre else None, dtype=dtype)
    m.load_state_dict({k: v for k, v in sd.items() if aggre or not k.startswith("aggre_")})
    return m.to(dtype)


def cast(batch: dict, dtype) -> dict:
    return {k: (v.astype(dtype) if v.dtype.kind == "f" else v) for k, v in batch.items()}


def digest(module) -> str:
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def grads_of(module) -> dict:
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().clone()
            for k, p in module.named_parameters()}


def floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def run_train(setup, batch, dtype, steps, mesh=None, aggre=True) -> dict:
    """``steps`` supervised steps; the metrics of each, step 1's gradients,
    the state dict after the last and its digest."""
    cfg = port_cfg(aggre=aggre)
    model = model_of(setup["model"], dtype, aggre)
    tx = make_optimizer(cfg, steps_per_epoch=10)
    state = tstep.init_train_state(model, tx, device="cpu")
    step = tstep.make_train_step(model, cfg, tx, mesh=mesh, device="cpu")
    b = cast(batch, {torch.float64: np.float64, torch.float32: np.float32}[dtype])
    out = {"metrics": []}
    for i in range(steps):
        state, m = step(state, b)
        out["metrics"].append(floats(m))
        if i == 0:
            out["grads"] = grads_of(model)
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["digest"] = digest(model)
    return out


def run_eval(setup, batch, mesh=None) -> dict:
    cfg = port_cfg()
    cfg.TEST.FLIP_TEST = True
    model = model_of(setup["model"], torch.float32)
    out = tstep.make_eval_step(model, cfg, flip_pairs=FLIP_PAIRS, mesh=mesh,
                               device="cpu")(model, batch)
    return {k: (v.clone() if v.dim() else float(v)) for k, v in out.items()}


def run_gan(setup, batch, parity, draws, mesh=None) -> dict:
    """One adversarial step in float64 from the setup's weights."""
    cfg = port_cfg(gan=True)
    model = model_of(setup["model"], torch.float64)
    critics = build_discriminators(cfg)
    for n, c in critics.items():
        c.load_state_dict(setup["critics"][n])
        critics[n] = c.to(torch.float64)
    tx = make_optimizer(cfg, 10)
    tx_d = {n: make_optimizer(cfg, 10, discriminator=True) for n in critics}
    states = {"base_model": tstep.init_train_state(model, tx, device="cpu"),
              **tgan.init_discriminator_states(critics, tx_d, device="cpu")}
    step = tgan.make_adversarial_train_step(model, critics, cfg, tx, tx_d, mesh=mesh,
                                            device="cpu", seed=7)
    states, m = step(states, cast(batch, np.float64), parity, draws=draws)
    return {"metrics": floats(m),
            "grads": {n: grads_of(st.params) for n, st in states.items()},
            "digests": {n: digest(st.params) for n, st in states.items()}}


def make_setup(rng) -> dict:
    """Weights (numpy Flax variables, carried), the global batch, the
    critics' weights and the parity-0 draws of the global batch."""
    from posetpu_torch.models.convert import from_jax_variables
    from tests.test_torch_gan import _batch as gan_batch
    from tests.test_torch_serving_jns import np_variables

    variables = np_variables(rng)
    batch = {}
    for i in range(2):  # two of tests/test_torch_gan.py's 3-group batches, 2 groups each
        b = gan_batch(rng)
        batch = {k: np.concatenate([batch[k], v[:2]]) if k in batch else v[:2]
                 for k, v in b.items()}
    batch["is_h36m"] = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    cfg = port_cfg(gan=True)
    critics = build_discriminators(cfg, torch.Generator().manual_seed(3))
    draws = sample_draws({k: torch.from_numpy(v) for k, v in batch.items()}, cfg, 0,
                         torch.Generator().manual_seed(5))
    return {"variables": variables, "model": from_jax_variables(variables),
            "critics": {n: c.state_dict() for n, c in critics.items()},
            "batch": batch, "draws": draws}


# ------------------------------------------------------------ the groups


def _child(work, rank, world, url, out_dir, q, after):
    try:
        torch.set_num_threads(max(1, 4 // world))
        pmesh.initialize_distributed(url, world, rank, device="cpu", timeout=JOIN_S)
        try:
            work(pmesh.data_mesh(world), Path(out_dir))
        finally:
            torch.distributed.destroy_process_group()
        if after is not None:  # work that joins its own groups
            after(rank, world, Path(out_dir))
        q.put((rank, None))
    except BaseException:  # noqa: BLE001 - the traceback goes to the parent
        q.put((rank, traceback.format_exc()))


def spawn_group(work, world: int, out_dir: Path, after=None) -> tuple:
    """``work(mesh, out_dir)`` started in ``world`` gloo processes (a
    ``file://`` rendezvous in ``out_dir``), then ``after(rank, world,
    out_dir)``, which joins its groups itself; :func:`join_group` waits."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    url = f"file://{out_dir}/rdzv"
    procs = [ctx.Process(target=_child, args=(work, r, world, url, str(out_dir), q, after),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def join_group(procs, q, timeout: float = JOIN_S) -> None:
    """Every child's report read (the queue drained before the joins)
    within ``timeout`` in all; a failure raises with the child's traceback,
    a child that died without a report fails at once, and a child still
    running at the end is killed."""
    errors, done, start = [], 0, time.monotonic()
    try:
        while done < len(procs) and not errors:
            try:
                rank, err = q.get(timeout=2)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead and q.empty():
                    errors.append(f"ranks {dead} died with exit codes "
                                  f"{[procs[i].exitcode for i in dead]}")
                elif time.monotonic() - start > timeout:
                    errors.append(f"a rank did not finish within {timeout} s")
                continue
            done += 1
            if err:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not errors, "\n".join(errors)


def steps_work(mesh, out: Path) -> None:
    """What a rank of the module's groups runs: its rows of the global
    batch through the train step (f64, 2 steps) and, at W=2, also the
    train step in f32, the eval step and the adversarial step at both
    parities; rank 0 writes the results, the others their digests."""
    setup = torch.load(out / "setup.pt", weights_only=False)
    local = pmesh.shard_batch(setup["batch"], mesh)
    # replicate: a state that differs by rank takes rank 0's values
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(mesh.rank))
    st = TrainState(lin, {"count": mesh.rank + 1, "mu": {"w": torch.full((2,), mesh.rank)}},
                    mesh.rank)
    pmesh.replicate({"s": st}, mesh)
    replicated = (digest(lin), st.opt_state["count"], st.step, st.opt_state["mu"]["w"].tolist())
    res = {"train64": run_train(setup, local, torch.float64, 2, mesh, aggre=False)}
    if mesh.size == 2:
        res["train64_bank"] = run_train(setup, local, torch.float64, 1, mesh)
        res["train32"] = run_train(setup, local, torch.float32, 1, mesh)
        res["eval"] = run_eval(setup, local, mesh)
        res["gan0"] = run_gan(setup, local, 0, setup["draws"], mesh)
        res["gan1"] = run_gan(setup, local, 1, None, mesh)
    if mesh.rank:
        res = {"train64": {"digest": res["train64"]["digest"]},
               "gan": {k: res[k]["digests"] for k in ("gan0", "gan1") if k in res}}
    else:
        res["gan"] = {k: res[k]["digests"] for k in ("gan0", "gan1") if k in res}
    res["replicated"] = replicated
    torch.save(res, out / f"rank{mesh.rank}.pt")


def jax_mesh_runs(setup) -> dict:
    """JAX's train step under data_mesh(2) with shard_batch (f32, one step)
    and its sharded eval step with the flip test, from the same weights."""
    import jax

    from posetpu.models import MultiViewPose as JMultiView
    from posetpu.models import get_pose_net as jax_pose_net
    from posetpu.parallel.mesh import data_mesh, replicate, shard_batch
    from posetpu.train import optim as joptim
    from posetpu.train import step as jstep
    from posetpu.train.state import TrainState as JState
    from tests.test_torch_train import _cfgs

    jcfg = _cfgs(**LOSS)[0]
    variables = setup["variables"]
    batch = {k: v for k, v in setup["batch"].items() if k not in ("joints_crop", "joints_vis")}
    jmodel = JMultiView(resnet=jax_pose_net(jcfg), aggre=True)
    jtx = joptim.make_optimizer(jcfg, 10)
    state = JState(variables["params"], variables["batch_stats"],
                   jtx.init(variables["params"]), 0)
    mesh = data_mesh(2)
    with mesh:
        _, m = jstep.make_train_step(jmodel, jcfg, jtx)(replicate(state, mesh),
                                                        shard_batch(batch, mesh))
    ecfg = _cfgs(**LOSS)[0]
    ecfg.TEST.FLIP_TEST = True
    with mesh:
        ev = jstep.make_eval_step(jmodel, ecfg, flip_pairs=FLIP_PAIRS, mesh=mesh)(
            replicate(variables, mesh), shard_batch(batch, mesh))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "eval": jax.tree.map(np.asarray, ev)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The W=2 and W=4 groups, the single process's runs on the joined
    batch and JAX's mesh runs."""
    from posetpu_torch.data.synthetic import write_image_fixture

    base = tmp_path_factory.mktemp("parallel")
    setup = make_setup(np.random.RandomState(0))
    dirs = {w: base / f"w{w}" for w in (2, 4)}
    write_image_fixture(str(dirs[2] / "data"), n_images=8, mpii_size=(96, 72),
                        h36m_size=(120, 120), mpii_train=16, mpii_valid=8, h36m_train_groups=2,
                        h36m_valid_groups=1, seed=5)
    groups = {}
    for w, d in dirs.items():
        d.mkdir(exist_ok=True)
        torch.save(setup, d / "setup.pt")
        # the W=2 group then runs the CLIs (cli_work) in the same processes
        groups[w] = spawn_group(steps_work, w, d, after=cli_work if w == 2 else None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the children have the other cores
    try:
        single = {"train64": run_train(setup, setup["batch"], torch.float64, 2, aggre=False),
                  "train64_bank": run_train(setup, setup["batch"], torch.float64, 1),
                  "train32": run_train(setup, setup["batch"], torch.float32, 1),
                  "eval": run_eval(setup, setup["batch"]),
                  "gan0": run_gan(setup, setup["batch"], 0, setup["draws"]),
                  "gan1": run_gan(setup, setup["batch"], 1, None)}
        jax_runs = jax_mesh_runs(setup)
    finally:
        torch.set_num_threads(threads)
        for w in dirs:
            join_group(*groups[w])
    out = {"single": single, "jax": jax_runs, "dir": dirs[2]}
    for w, d in dirs.items():
        out[w] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(w)]
    return out


# ------------------------------------------------------------ the tests


def _close(got: dict, ref: dict, rel: float, what: str) -> None:
    """Every tensor of ``got`` within ``rel`` of ``ref``'s largest entry
    (integer counters equal)."""
    assert set(got) == set(ref), what
    for k, r in ref.items():
        g = got[k]
        if not r.is_floating_point():
            assert torch.equal(g, r), (what, k)
            continue
        scale = max(float(r.abs().max()), 1e-300)
        err = float((g.double() - r.double()).abs().max())
        assert err <= rel * scale, (what, k, err / scale)


def _metrics_close(got, ref, rel):
    for step, (g, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert set(g) == set(r) and "grad_norm_fund" in g, step
        for k in r:
            assert abs(g[k] - r[k]) <= rel * max(abs(r[k]), 1e-300), (step, k, g[k], r[k])


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_f64_equals_the_joined_batch(runs, world):
    """Without the bank the step is float64 from the heatmaps' f32 on
    (the losses read identical f32 heatmaps on both sides): 1e-10."""
    got, ref = runs[world][0]["train64"], runs["single"]["train64"]
    _metrics_close(got, ref, 1e-10)
    _close(got["grads"], ref["grads"], 1e-10, "step 1's all-reduced gradients")
    _close(got["state"], ref["state"], 1e-10, "parameters and BN statistics after 2 steps")


def test_train_step_f64_with_the_bank(runs):
    """With the bank and the consistency loss: the metrics within 1e-10;
    the gradients within 1e-7 of each leaf's largest. The bank's f64
    product reads the f32 heatmaps, so its input gradient is rounded to
    f32 there, and the f64 product summed over a rank's rows and over the
    whole batch differ in the last bits, which flips an f32 ulp here and
    there (4.6e-8 measured)."""
    got, ref = runs[2][0]["train64_bank"], runs["single"]["train64_bank"]
    _metrics_close(got, ref, 1e-10)
    assert "consistent_loss" in got["metrics"][0]
    _close(got["grads"], ref["grads"], 1e-7, "the all-reduced gradients")


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_stay_bit_equal(runs, world):
    """After 2 steps; and replicate gave every rank rank 0's parameters,
    optimizer state and step counts."""
    digests = {r["train64"]["digest"] for r in runs[world]}
    assert len(digests) == 1
    reps = [r["replicated"] for r in runs[world]]
    assert all(x == reps[0] for x in reps)
    assert reps[0][1:] == (1, 0, [0.0, 0.0])


def test_train_step_f32_matches_single_process_and_jax(runs):
    got = runs[2][0]["train32"]["metrics"][0]
    ref = runs["single"]["train32"]["metrics"][0]
    jm = runs["jax"]["metrics"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["loss"], jm["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["acc"], jm["acc"], rtol=1e-5)
    for k in ("mse_loss", "consistent_loss", "fund_loss"):
        np.testing.assert_allclose(got[k], jm[k], rtol=1e-4, err_msg=k)


def test_eval_step_gathers_in_rank_order(runs):
    got, ref = runs[2][0]["eval"], runs["single"]["eval"]
    assert got["preds"].shape == (N, 4, 16, 2) and got["heatmaps"].shape == (N, 4, 16, 16, 16)
    for k in ("preds", "maxvals", "heatmaps"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["acc"], ref["acc"], rtol=1e-5)


def test_eval_step_matches_jax_sharded(runs):
    """JAX's sharded eval step under data_mesh(2): the preds within 1e-4 px,
    the loss within rtol 1e-4."""
    got, jev = runs[2][0]["eval"], runs["jax"]["eval"]
    np.testing.assert_allclose(got["loss"], float(jev["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(jev["preds"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("parity", [0, 1])
def test_adversarial_step_f64_equals_the_joined_batch(runs, parity):
    """tests/test_torch_gan_f64.py's bounds: the loss within rtol 1e-6, each
    model's gradients within 1e-6 of each leaf's largest (5e-4 on the view
    and joints critics at parity 0, 5e-5 on the base at parity 1: the
    soft-argmax joints are f32), a rounding-noise leaf within 1e-6 of its
    model's largest. Parity 1 draws from the step's own seeded generator
    on every rank."""
    got, ref = runs[2][0][f"gan{parity}"], runs["single"][f"gan{parity}"]
    assert set(got["metrics"]) == set(ref["metrics"])
    np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-6)
    for n, gref in ref["grads"].items():
        gmax = max(float(v.abs().max()) for v in gref.values())
        if n in ("view_discriminator", "joints_discriminator") and parity == 0:
            bound = 5e-4
        elif n == "base_model" and parity == 1:
            bound = 5e-5
        else:
            bound = 1e-6
        for k, r in gref.items():
            err = float((got["grads"][n][k] - r).abs().max())
            scale = float(r.abs().max())
            if scale <= 1e-6 * gmax:
                assert err <= 1e-6 * gmax, (n, k, err, gmax)
            else:
                assert err <= bound * scale, (n, k, err / scale)


@pytest.mark.parametrize("parity", [0, 1])
def test_adversarial_ranks_stay_bit_equal(runs, parity):
    a, b = (r["gan"][f"gan{parity}"] for r in runs[2])
    assert set(a) == set(b) and len(a) == 6
    assert a == b


def test_mesh_helpers_in_one_process(tmp_path):
    """A W=1 gloo group in this process: shard_batch's rows, replicate,
    global_batch_norm against F.batch_norm in training mode (output and the
    gradients of x, weight and bias within 1e-10 in f64, both memory
    formats; the moments), the collective count; a mesh that is not a
    DataMesh is refused."""
    pmesh.initialize_distributed(f"file://{tmp_path}/rdzv", 1, 0, device="cpu", timeout=60)
    try:
        mesh = pmesh.data_mesh()
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        with pytest.raises(ValueError):
            pmesh.data_mesh(2)
        b = {"x": np.arange(6)}
        assert pmesh.shard_batch(b, mesh)["x"].tolist() == list(range(6))
        assert pmesh.global_batch_from_full_host(b, mesh)["x"].tolist() == list(range(6))
        assert pmesh.shard_host_batch(b, mesh) is b
        with pytest.raises(ValueError):
            pmesh.shard_host_batch({"x": np.zeros(2), "y": np.zeros(3)}, mesh)
        np.testing.assert_array_equal(pmesh.local_data(torch.arange(3)), np.arange(3))
        for fmt in (torch.contiguous_format, torch.channels_last):
            x = torch.randn(4, 3, 5, 5, dtype=torch.float64).to(memory_format=fmt)
            w, b = torch.rand(3, dtype=torch.float64) + 0.5, torch.randn(3, dtype=torch.float64)
            grad = torch.randn(4, 3, 5, 5, dtype=torch.float64)
            got, ref = [], []
            for out, norm in ((got, lambda *a: pbn.global_batch_norm(*a, 1e-5, mesh)[0]),
                              (ref, lambda *a: F.batch_norm(a[0], None, None, a[1], a[2], True,
                                                            0.1, 1e-5))):
                leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
                pmesh.reset_collective_count()
                y = norm(*leaves)
                (y * grad).sum().backward()
                out.extend([y.detach(), *(t.grad for t in leaves), pmesh.collective_count()])
            for g, r in zip(got[:4], ref[:4]):
                torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)
            assert got[4] == 2 and ref[4] == 0  # one all-reduce forward, one backward
        mean, var = pbn.global_batch_norm(x, w, b, 1e-5, mesh)[1:]
        torch.testing.assert_close(mean, x.mean((0, 2, 3)), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(var, x.var((0, 2, 3), unbiased=False), rtol=1e-10, atol=1e-12)
        st = TrainState(torch.nn.Linear(2, 2), {"count": 3, "mu": {}}, 5)
        assert pmesh.replicate(st, mesh) is st and st.step == 5
        # one rule for the train and validate CLIs: a group of one runs plain
        two = pmesh.DataMesh(None, 0, 2, torch.device("cpu"))
        assert pmesh.use_mesh(mesh) is None and pmesh.use_mesh(None, 4) is None
        assert pmesh.use_mesh(two) is two and pmesh.use_mesh(two, 4) is two
        assert pmesh.use_mesh(two, 3) is None
        # the checkpoint over a mesh saves on rank 0's worker as without one
        ckpt = CheckpointManager(str(tmp_path / "ckpt"), async_save=True, mesh=mesh)
        assert ckpt._pool is not None
        ckpt.save_final({"base_model": st})
        assert ckpt._pending is None and ckpt.exists("final_state")
        assert ckpt.restore("final_state")[0]["base_model"]["step"] == 5
        with pytest.raises(TypeError, match="DataMesh"):
            tstep.make_eval_step(MultiViewPose(PoseResNet(num_layers=18), 16), port_cfg(),
                                 mesh=object(), device="cpu")
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------- the train and validate CLIs

MPII = "experiments/mpii/resnet50/140e_32batch.yaml"


def cli_args(module, out: Path, *extra):
    repo = Path(__file__).resolve().parents[1]
    return module.parse_args(["--cfg", str(repo / MPII), "--modelDir", str(out / "output"),
                              "--logDir", str(out / "log"), "--f32", *extra])


def cli_cfg(args, data: Path, **over):
    """The MPII preset cut to ResNet-18 at 64x64, 2 groups a batch on each
    process (tests/test_torch_cli_train.py's cut)."""
    from posetpu_torch.cli.common import load_cfg

    cfg = load_cfg(args)
    cfg.DATASET.ROOT = str(data)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.DEBUG.DEBUG = False
    cfg.WORKERS = 1
    for k, v in over.items():
        sec, key = k.split(".")
        setattr(getattr(cfg, sec), key, v)
    return cfg


def _lines_logger(name):
    import logging

    log, lines = logging.getLogger(name), []
    log.propagate = False
    log.setLevel(logging.INFO)
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    log.addHandler(handler)
    return log, lines


def cli_work(rank, world, out: Path) -> None:
    """A rank of the train CLI over ``world`` gloo processes: one epoch,
    then a restart that resumes from its checkpoint for a second, then the
    validate CLI over the same processes on its final_state. Writes what
    the parent compares: the first step's batch and loss, the saves and H5
    dumps this rank made, the log lines."""
    import torch.distributed as dist

    from posetpu_torch.cli import train as tcli
    from posetpu_torch.cli import validate as vcli
    from posetpu_torch.train import checkpoint, loop

    data, out = out / "data", out / "cli"
    out.mkdir(exist_ok=True)
    saves, dumps = [], []
    save_sync, save_h5 = checkpoint.CheckpointManager._save_sync, loop.save_heatmaps
    checkpoint.CheckpointManager._save_sync = (
        lambda self, name, st, meta: saves.append(name) or save_sync(self, name, st, meta))
    loop.save_heatmaps = lambda path, *a: dumps.append(os.path.basename(path)) or save_h5(
        path, *a)
    log, lines = _lines_logger(f"posetpu_parallel_cli_{rank}")
    res = {}
    for run, over in enumerate(({}, {"TRAIN.ON_SERVER_CLUSTER": True, "TRAIN.END_EPOCH": 2})):
        args = cli_args(tcli, out, "--coordinator", f"file://{out}/rdzv{run}",
                        "--num-processes", str(world), "--process-id", str(rank))
        tr = tcli.setup(cli_cfg(args, data, **over), args, device="cpu", log=log)
        try:
            step, first = tr.train_step, []

            def recording(state, batch, step=step, first=first):
                state, m = step(state, batch)
                if not first:
                    first.append(({k: v.clone() for k, v in batch.items()}, float(m["loss"])))
                return state, m

            tr.train_step = recording
            res[f"run{run}"] = {"begin_epoch": tr.begin_epoch, "step0": tr.base.step}
            tcli.train_epochs(tr, tr.output_dir)
            res[f"run{run}"].update(first=first[0], steps=tr.base.step,
                                    digest=digest(tr.base.params),
                                    output_dir=tr.output_dir)
            tr.writer.close()
        finally:
            dist.destroy_process_group()
    vargs = cli_args(vcli, out, "--state", os.path.join(res["run1"]["output_dir"],
                                                        "final_state"),
                     "--coordinator", f"file://{out}/rdzv_validate", "--num-processes",
                     str(world), "--process-id", str(rank))
    vcfg = cli_cfg(vargs, data)
    vcfg.TEST.BATCH_SIZE = 2 * world
    res["validate"] = vcli.run(vcfg, vargs, device="cpu", log=log)[2]
    res.update(saves=saves, dumps=dumps, lines=lines)
    torch.save(res, out / f"cli_rank{rank}.pt")


@pytest.fixture(scope="module")
def cli_runs(runs):
    """What the W=2 group's CLI runs wrote (:func:`cli_work`), and this
    process's references: the single-process step on the ranks' first
    batches joined and the validate CLI at W=1."""
    from posetpu_torch.cli import train as tcli
    from posetpu_torch.cli import validate as vcli
    from posetpu_torch.cli.common import build_model

    base = runs["dir"]
    ranks = [torch.load(base / "cli" / f"cli_rank{r}.pt", weights_only=False) for r in range(2)]

    args = cli_args(tcli, base / "w1")
    cfg = cli_cfg(args, base / "data")
    model = build_model(cfg, bf16=False, generator=torch.Generator().manual_seed(int(cfg.SEED)))
    tx = make_optimizer(cfg, steps_per_epoch=1)
    joined = {k: torch.cat([r["run0"]["first"][0][k] for r in ranks])
              for k in ranks[0]["run0"]["first"][0]}
    _, m = tstep.make_train_step(model, cfg, tx, device="cpu")(
        tstep.init_train_state(model, tx, device="cpu"), joined)
    vargs = cli_args(vcli, base / "w1", "--state",
                     os.path.join(ranks[0]["run1"]["output_dir"], "final_state"))
    vcfg = cli_cfg(vargs, base / "data")
    vcfg.TEST.BATCH_SIZE = 4
    log, lines = _lines_logger("posetpu_parallel_cli_w1")
    single = vcli.run(vcfg, vargs, device="cpu", log=log)[2]
    return {"ranks": ranks, "loss": float(m["loss"]), "validate": single, "lines": lines}


def test_cli_first_step_equals_the_joined_batch(cli_runs):
    """The first step of ``--num-processes 2`` (each rank 2 groups of its
    shard) against one process on the 4 groups joined: the loss within rtol
    1e-4 (f32; BatchNorm's global moments are summed otherwise)."""
    r0, r1 = cli_runs["ranks"]
    assert r0["run0"]["first"][1] == r1["run0"]["first"][1]
    np.testing.assert_allclose(r0["run0"]["first"][1], cli_runs["loss"], rtol=1e-4)
    assert not torch.equal(r0["run0"]["first"][0]["images"], r1["run0"]["first"][0]["images"])


def test_cli_rank0_writes_and_a_restart_resumes_on_both(cli_runs):
    r0, r1 = cli_runs["ranks"]
    assert "final_state" in r0["saves"] and "checkpoint" in r0["saves"] and r1["saves"] == []
    out = Path(r0["run1"]["output_dir"])
    assert (out / "final_state.pt").exists() and (out / "final_state_meta.json").exists()
    assert any("data mesh: 2 devices, 2 process(es)" == x for x in r0["lines"])
    assert not any(x.startswith("Epoch [") for x in r1["lines"])
    for r in (r0, r1):
        assert r["run0"]["begin_epoch"] == 0 and r["run0"]["steps"] == 1
        assert r["run1"]["begin_epoch"] == 1 and r["run1"]["step0"] == 1
        assert r["run1"]["steps"] == 2
    assert r0["run1"]["digest"] == r1["run1"]["digest"]
    assert r0["run0"]["digest"] == r1["run0"]["digest"]


def test_validate_cli_over_two_processes(cli_runs):
    r0, r1 = cli_runs["ranks"]
    assert "eval devices: 2" in r0["lines"] and "eval devices: 1" in cli_runs["lines"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["validate"], cli_runs["validate"], rtol=0, atol=1e-4)
    # the H5 dump, once an epoch and once for the validate run, from rank 0 alone
    assert r0["dumps"] == ["heatmaps_locations_valid_mpii.h5"] * 3 and r1["dumps"] == []
