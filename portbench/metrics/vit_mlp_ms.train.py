"""vit_mlp_ms.train: device milliseconds a step launched inside the
program's ``vit.mlp`` spans (models/vitpose.py: LayerNorm, the two
projections, GELU, the drop-path and the residual add of each block's
forward), from the traced sub-window (portbench/program_spans.py)."""

from portbench.program_spans import per_iteration


def read(rec):
    return per_iteration(rec, "train", "vit.mlp", "device")
