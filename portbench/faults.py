"""Faults planted underneath a run, for the check that ``correct`` comes
out false (``portbench/tests``) and for the readings that set the limits
(``portbench.readings``). Each wraps an object of the program; none is
used by a benchmark run.

Serving:
- ``half_batch``: the second half of a request's groups get the first
  half's answers (half of the batch left out);
- ``altered_answer``: a request's first detected 2D joint (maximum > 0)
  moved by one heatmap pixel after the triangulation, so the 3D points are
  of the joints before.
Training:
- ``unchanged``: the step leaves the parameters and the optimizer's state
  as they were;
- ``half_batch``: the step sees the first half of each batch (its mean
  taken over the rest);
- ``altered_answer``: the head's gradient doubled where the optimizer
  takes it;
- ``stats_unchanged``: BatchNorm's running averages left as they were
  before each step;
- ``wrong_momentum``: BatchNorm's running averages keep 0.1 and take 0.9
  of the batch (PyTorch's ``momentum=0.1`` read as Flax's, the other way
  round), set where the program's BatchNorm reads its momentum;
- ``bank_unchanged`` (a configuration with the fusion bank): the
  optimizer's update skips the bank's parameters, its moments kept.
"""

from __future__ import annotations

SERVE = ("half_batch", "altered_answer")
TRAIN = ("unchanged", "half_batch", "altered_answer", "stats_unchanged", "wrong_momentum")
TRAIN_FUSION = ("bank_unchanged",)


def train_faults(cfg: dict) -> tuple:
    """The training faults a cell of configuration ``cfg`` can have."""
    return TRAIN + (TRAIN_FUSION if cfg["aggre"] else ())


def serve_outputs(fault, preds, maxvals, pts, shift_px):
    """Plant a serving fault in one request's answers (tensors, in place
    on copies). ``shift_px``: one heatmap pixel in image pixels."""
    if fault == "half_batch":
        h = preds.shape[0] // 2
        preds, maxvals, pts = preds.clone(), maxvals.clone(), pts.clone()
        preds[h:2 * h], maxvals[h:2 * h], pts[h:2 * h] = preds[:h], maxvals[:h], pts[:h]
    elif fault == "altered_answer":
        preds = preds.clone()
        first = int((maxvals > 0).flatten().nonzero()[0])
        preds.view(-1, 2)[first, 0] += shift_px
    return preds, maxvals, pts


def train_step(fault, step, tx, model):
    """A train step with a training fault planted (``tx`` and ``model`` the
    step's optimizer and module)."""
    if fault == "unchanged":
        tx.update = lambda *a, **k: None
        return step
    if fault == "altered_answer":
        update = tx.update

        def doubled(net, state):
            g = net.resnet.final_layer.weight.grad
            g.mul_(2.0)
            return update(net, state)

        tx.update = doubled
        return step
    if fault == "half_batch":
        def half(state, batch):
            n = batch["images"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    if fault == "stats_unchanged":
        return _restoring(step, [b for n, b in model.named_buffers()
                                 if n.endswith(("running_mean", "running_var"))])
    if fault == "bank_unchanged":
        bank = [p for n, p in model.named_parameters() if n.startswith("aggre_layer.")]
        if not bank:
            raise ValueError("bank_unchanged needs a model with the fusion bank")
        return _restoring(step, bank)
    if fault == "wrong_momentum":
        from posetpu_torch.models import pose_resnet

        def wrong(state, batch):
            kept = pose_resnet.BN_MOMENTUM
            pose_resnet.BN_MOMENTUM = 1.0 - kept
            try:
                return step(state, batch)
            finally:
                pose_resnet.BN_MOMENTUM = kept
        return wrong
    raise ValueError(f"unknown training fault {fault!r}")


def _restoring(step, tensors):
    """``step`` with ``tensors`` put back as they were before each call."""
    import torch

    def restored(state, batch):
        with torch.no_grad():
            kept = [t.detach().clone() for t in tensors]
        out = step(state, batch)
        with torch.no_grad():
            torch._foreach_copy_(tensors, kept)
        return out
    return restored
