"""Shared CLI plumbing: argument and config parsing."""

from __future__ import annotations

import argparse

from posetpu_torch.config import load_config, update_dir


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--modelDir", default="", help="model directory")
    p.add_argument("--logDir", default="", help="log directory")
    p.add_argument("--dataDir", default="", help="data directory")
    return p


def load_cfg(args, **overrides):
    cfg = load_config(args.cfg, **overrides)
    update_dir(cfg, args.modelDir, args.logDir, args.dataDir)
    return cfg
