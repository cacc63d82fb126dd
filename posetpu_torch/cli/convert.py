"""Checkpoint conversion: a reference PyTorch .pth / .pth.tar -> one of the
port's own checkpoints.

    python -m posetpu_torch.cli.convert --cfg <yaml> --torch <ckpt.pth.tar> --out <dir>/<name>

writes ``<dir>/<name>.pt`` in train/checkpoint.py's format (the base
model's params and batch statistics, no optimizer state), which ``--state
<dir>/<name>`` of cli/validate.py and ``TRAIN.RESUME_PATH`` read natively.
The JAX package writes an Orbax directory here; the port writes its own
format. (validate also converts a torch file on the fly; this persists the
result.) The bank is left out where the config's ``NETWORK.AGGRE`` is
false.
"""

from __future__ import annotations


def parse_args(argv=None):
    from posetpu_torch.cli.common import base_parser

    p = base_parser("Convert a reference torch checkpoint to the port's format")
    p.add_argument("--torch", required=True, help="reference .pth/.pth.tar")
    p.add_argument("--out", required=True,
                   help="output checkpoint <dir>/<name> (written as <dir>/<name>.pt)")
    return p.parse_args(argv)


def run(cfg, args) -> str:
    """Convert ``args.torch`` into ``args.out``; returns the file written."""
    import os

    from posetpu_torch.cli.common import load_model_variables
    from posetpu_torch.train.checkpoint import CheckpointManager

    variables = load_model_variables(args.torch, drop_aggre=not cfg.NETWORK.AGGRE)
    stem = args.out[:-3] if args.out.endswith(".pt") else args.out
    path = CheckpointManager(os.path.dirname(os.path.abspath(stem))).save(
        os.path.basename(stem), {"base_model": variables})
    n = sum(v.numel() for v in variables["params"].values() if v.is_floating_point())
    print(f"=> {path}: {n / 1e6:.1f}M params")
    return path


def main(argv=None):
    from posetpu_torch.cli.common import load_cfg

    args = parse_args(argv)
    return run(load_cfg(args), args)


if __name__ == "__main__":
    main()
