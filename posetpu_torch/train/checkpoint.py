"""Checkpoints with the reference's three roles (lib/utils/utils.py:87-116,
run/pose2d/train.py:368-397): the per-epoch ``checkpoint`` of every
component's train state with its epoch and perf (resume), ``model_best``
kept by perf, and ``final_state`` at the end of training.

Each checkpoint is one ``torch.save`` file ``<name>.pt`` in the directory,
a dict {component: {"params", "batch_stats", "opt_state", "step"}} of
tensors on the CPU (a :class:`~posetpu_torch.train.state.TrainState`'s
``state_dict``), with its metadata in ``<name>_meta.json``.

Over a data mesh the state is replicated, so rank 0 alone copies and
writes it and its metadata, in the same way as one process does; every
rank meets at a barrier when it joins the save, and may then restore from
the shared directory.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import torch

from posetpu_torch.parallel.mesh import barrier, is_primary
from posetpu_torch.train.state import TrainState


def _to_host(tree):
    """The checkpoint's tree with every tensor copied to the CPU; a train
    state becomes its state_dict."""
    if isinstance(tree, TrainState):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    """Save and restore dicts of train states.

    With ``async_save=True`` the file is written by one worker thread while
    training goes on. The device -> host copy happens first, on the calling
    thread, so the device work stays in the order the caller issued it. One
    save is in flight at a time; :meth:`wait_until_finished` (called before
    every save, :meth:`exists` and restore) joins it and raises its error,
    if any.

    With ``mesh`` (parallel/mesh.DataMesh) rank 0 alone copies and saves,
    inline or on its worker as above; :meth:`wait_until_finished` then
    waits at a barrier on every rank after rank 0 has joined its save, so
    each rank sees the finished file once it returns. Every rank calls the
    manager's methods at the same points."""

    def __init__(self, directory: str, async_save: bool = False, mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.mesh = mesh
        self._pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="posetpu-ckpt")
                      if async_save else None)
        self._pending = None

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def _write_meta(self, name: str, meta: dict | None) -> None:
        with open(os.path.join(self.directory, f"{name}_meta.json"), "w") as f:
            json.dump(meta or {}, f)

    # -------------------------------------------------------------- save

    def wait_until_finished(self) -> None:
        """Join any save in flight, raising its error if it failed; over a
        mesh every rank then waits for the others (rank 0 has joined)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        barrier(self.mesh)

    def _run(self, job, states: dict):
        """Join the previous save, copy ``states`` to the host here, then
        run ``job(host_states)`` inline or on the worker (rank 0 alone)."""
        self.wait_until_finished()
        if not is_primary(self.mesh):
            return
        host = _to_host(states)
        if self._pool is None:
            job(host)
        else:
            self._pending = self._pool.submit(job, host)

    def _save_sync(self, name: str, states: dict, meta: dict | None) -> str:
        path = self._path(name)
        tmp = path + ".writing"
        torch.save(states, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        self._write_meta(name, meta)
        return path

    def save(self, name: str, states: dict, meta: dict | None = None) -> str:
        self._run(lambda st: self._save_sync(name, st, meta), states)
        return self._path(name)

    def save_epoch(self, epoch: int, states: dict, perf: float, is_best: bool) -> None:
        """The per-epoch checkpoint and the best one (train.py:368-390):
        ``model_best`` is a copy of the file just written."""
        meta = {"epoch": epoch, "perf": float(perf)}

        def job(states):
            path = self._save_sync("checkpoint", states, meta)
            if is_best:
                best = self._path("model_best")
                shutil.copyfile(path, best + ".copying")
                os.replace(best + ".copying", best)
                self._write_meta("model_best", meta)

        self._run(job, states)

    def save_final(self, states: dict) -> None:
        """final_state.pth.tar (train.py:393-397); returns once written."""
        self.save("final_state", states)
        self.wait_until_finished()

    # ----------------------------------------------------------- restore

    def exists(self, name: str = "checkpoint") -> bool:
        self.wait_until_finished()
        return os.path.exists(self._path(name))

    def restore(self, name: str, template: dict | None = None) -> tuple[dict, dict]:
        """Restore a checkpoint: (states, meta). With ``template`` ({component:
        TrainState}) each component is loaded into the template's state, its
        tensors onto the template's devices and dtypes, and the template
        comes back; without, the saved dicts (tensors on the CPU)."""
        self.wait_until_finished()
        states = torch.load(self._path(name), map_location="cpu", weights_only=True)
        if template is not None:
            for k, st in template.items():
                st.load_state_dict(states[k])
            states = template
        meta_path = os.path.join(self.directory, f"{name}_meta.json")
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return states, meta

    def restore_model(self, name: str = "final_state",
                      keep: tuple = ("params", "batch_stats")) -> dict:
        """Only the ``keep`` entries of each component: the reference's
        model-only RESUME_PATH (run/pose2d/train.py:250-275). The file is
        memory-mapped, so the optimizer's bytes are never read, and the
        saved optimizer's structure does not matter."""
        self.wait_until_finished()
        states = torch.load(self._path(name), map_location="cpu", weights_only=True,
                            mmap=True)
        return {e: {k: v for k, v in sub.items() if k in keep} for e, sub in states.items()}
