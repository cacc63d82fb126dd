"""Layered configuration system.

Defaults <- YAML experiment overlay (strict: unknown keys rejected) <- keyword
overrides. The schema mirrors the reference config so its experiment YAMLs load
unchanged (reference: lib/core/config.py:19-329).

Configs are values passed explicitly, never a global. PyYAML is imported only
where a YAML file is read or written, so the package runs where it is absent.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

import numpy as np


class Section:
    """Attribute-access view over one config section with a fixed key set."""

    def __init__(self, **entries: Any) -> None:
        object.__setattr__(self, "_entries", dict(entries))

    def __getattr__(self, name: str) -> Any:
        if name == "_entries":  # not yet set (e.g. during copy protocols)
            raise AttributeError(name)
        try:
            return self._entries[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        import copy as _copy

        new = Section.__new__(Section)
        object.__setattr__(new, "_entries", _copy.deepcopy(self._entries, memo))
        return new

    def __setattr__(self, name: str, value: Any) -> None:
        if name not in self._entries:
            raise KeyError(f"unknown config key: {name}")
        self._entries[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._entries[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self.__setattr__(name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._entries.items():
            if isinstance(v, Section):
                out[k] = v.to_dict()
            elif isinstance(v, np.ndarray):
                out[k] = v.tolist()
            else:
                out[k] = v
        return out


Config = Section  # top level is just a section of sections


def _default_config() -> Config:
    """Full default tree; key names/values match the reference defaults
    (lib/core/config.py:19-235) so its experiment YAMLs overlay cleanly."""
    return Config(
        OUTPUT_DIR="output",
        LOG_DIR="log",
        DATA_DIR="",
        BACKBONE_MODEL="pose_resnet",
        MODEL="multiview_pose_resnet",
        GPUS="0,1",  # accepted for YAML parity; entry points take device=
        WORKERS=8,
        PRINT_FREQ=100,
        SEED=0,
        CUDNN=Section(BENCHMARK=True, DETERMINISTIC=False, ENABLED=True),
        NETWORK=Section(
            PRETRAINED="models/pytorch/imagenet/resnet50-19c8e357.pth",
            NUM_JOINTS=16,
            HEATMAP_SIZE=np.array([80, 80]),
            IMAGE_SIZE=np.array([320, 320]),
            SIGMA=2,
            TARGET_TYPE="gaussian",
            AGGRE=True,
        ),
        POSE_RESNET=Section(
            NUM_LAYERS=50,
            DECONV_WITH_BIAS=False,
            NUM_DECONV_LAYERS=3,
            NUM_DECONV_FILTERS=[256, 256, 256],
            NUM_DECONV_KERNELS=[4, 4, 4],
            FINAL_CONV_KERNEL=1,
        ),
        # ViTPose (Xu et al. 2022) as the backbone (BACKBONE_MODEL: vitpose):
        # ViT-Huge's widths, its drop-path rate, and the classic decoder's
        # two deconvolutions (ViTPose_huge_coco_256x192.py)
        POSE_VIT=Section(
            PATCH_SIZE=16,
            PATCH_PADDING=2,
            EMBED_DIM=1280,
            DEPTH=32,
            NUM_HEADS=16,
            MLP_RATIO=4,
            DROP_PATH_RATE=0.55,
            NUM_DECONV_FILTERS=[256, 256],
            NUM_DECONV_KERNELS=[4, 4],
            FINAL_CONV_KERNEL=1,
        ),
        LOCAL_DISCRIMINATOR=Section(
            LOW_FEATURES_CHANNELS=256,
            HIGH_FEATURES_CHANNELS=256,
            OUTPUT_CHANNELS=2048,
        ),
        DOMAIN_DISCRIMINATOR=Section(FEATURES_CHANNELS=2048),
        VIEW_DISCRIMINATOR=Section(
            VIEW_ONE_NUM=1, VIEW_TWO_NUM=3, OUTPUT_CHANNELS=256
        ),
        JOINTS_DISCRIMINATOR=Section(
            VAR_ONE_NUM=4,
            VAR_TWO_NUM=12,
            OUTPUT_CHANNELS=128,
            VAR_ONE_IDX=np.array([0, 5, 10, 15], dtype=np.int32),
        ),
        HEATMAP_DISCRIMINATOR=Section(
            INPUT_CHANNELS=257, INTER_CHANNELS=64, JOINT_IDX=0
        ),
        LOSS=Section(
            USE_TARGET_WEIGHT=True,
            USE_TARGET_WEIGHT_FUND=True,
            USE_CONSISTENT_LOSS=False,
            USE_FUNDAMENTAL_LOSS=False,
            USE_GLOBAL_MI_LOSS=False,
            USE_LOCAL_MI_LOSS=False,
            USE_GRADIENT_CLIP=False,
            USE_LOW_FEATURES_PREPROCESS=False,
            USE_DOMAIN_TRANSFER_LOSS=False,
            USE_VIEW_MI_LOSS=False,
            USE_JOINTS_MI_LOSS=False,
            USE_HEATMAP_MI_LOSS=False,
            WATCH_GRAD_NORM=False,
            MSE_LOSS_WEIGHT=1,
            CONSISTENT_LOSS_WEIGHT=0.01,
            FUNDAMENTAL_LOSS_WEIGHT=1,
            GLOBAL_MI_LOSS_WEIGHT=1,
            LOCAL_MI_LOSS_WEIGHT=1,
            DOMAIN_LOSS_WEIGHT=1,
            VIEW_MI_LOSS_WEIGHT=1,
            JOINTS_MI_LOSS_WEIGHT=1,
            HEATMAP_MI_LOSS_WEIGHT=1,
            MI_MEASURE="JSD",
            MI_NEG_POS_RATIO=2,
            MI_POSITIVE_NUM=16,
            SPECIFIC="org",
            VIEW_MI_MEASURE="NCE",
            JOINTS_MI_MEASURE="NCE",
            HEATMAP_MI_MEASURE="NCE",
        ),
        DATASET=Section(
            ROOT="data/",
            TRAIN_DATASET="mixed_dataset",
            TEST_DATASET="multiview_h36m",
            TRAIN_SUBSET="train",
            TEST_SUBSET="validation",
            PSEUDO_LABEL_PATH="",
            NO_DISTORTION=False,
            ROOTIDX=0,
            DATA_FORMAT="jpg",
            BBOX=2000,
            MPII_SCALE_FACTOR=0,
            MPII_ROT_FACTOR=0,
            MPII_FLIP=False,
            H36M_SCALE_FACTOR=0,
            H36M_ROT_FACTOR=0,
            H36M_FLIP=False,
            COCO_SCALE_FACTOR=0,
            COCO_ROT_FACTOR=0,
            COCO_FLIP=False,
            MPII_ROOTIDX=6,
            H36M_ROOTIDX=0,
            IF_SAMPLE=False,
            H36M_WEIGHT=1,
            MPII_WEIGHT=10,
            COLOR_JITTER=False,
            MEAN=np.array([0.485, 0.456, 0.406]),
            STD=np.array([0.229, 0.224, 0.225]),
        ),
        TRAIN=Section(
            LR_FACTOR=0.1,
            LR_STEP=[90, 110],
            LR=0.001,
            # Adam first-moment storage dtype: "float32" (the reference's
            # torch.optim.Adam semantics) or "bfloat16". The [12,4096,4096]
            # aggregation bank's f32 p/m/v update is the train step's
            # largest single op (7.2 ms/iter at the HBM floor,
            # TRACE_TABLE_train.json); bf16 mu saves 1.96 ms/step measured
            # (tools/ab_train_opt.py: 357.6 -> 365.6 groups/s). Opt-in.
            ADAM_MU_DTYPE="float32",
            # Linear LR warmup over the first N epochs (0 = off, the
            # reference default — lib/utils/utils.py:62-85 has no warmup).
            # Extension for warm-start retrains: a fresh Adam state on a
            # converged model takes a violent first-epoch transient at
            # small batch (PIPELINE_r04.json mechanism[1]); warmup is the
            # standard remedy and what the fund home-regime A/B uses.
            WARMUP_EPOCHS=0,
            # mmcv's linear warm-up by iterations: the rate times
            # 1 - (1 - i / WARMUP_ITERS) * (1 - WARMUP_RATIO) at step i (0 = off)
            WARMUP_ITERS=0,
            WARMUP_RATIO=0.001,
            LR_DISCRIMINATOR=0.001,
            # "adam", "adamw" (decoupled decay WD on every parameter of two or
            # more dimensions but pos_embed) or "sgd"
            OPTIMIZER="adam",
            # adamw: layer-wise lr decay of a ViT backbone, each parameter's
            # rate times LAYER_DECAY ** (depth + 1 - its layer) (1 = off)
            LAYER_DECAY=1.0,
            # clip the gradient at this global L2 norm before the update (0 = off)
            CLIP_GRAD_NORM=0.0,
            MOMENTUM=0.9,
            WD=0.0001,
            NESTEROV=False,
            GAMMA1=0.99,
            GAMMA2=0.0,
            BEGIN_EPOCH=0,
            END_EPOCH=140,
            RESUME=False,
            RESUME_PATH="",
            ON_SERVER_CLUSTER=False,
            BATCH_SIZE=8,
            SHUFFLE=True,
            FIX_BACKBONE=False,
            # extension over the reference (which saves every epoch): save
            # the rolling checkpoint every N epochs. model_best still saves
            # whenever the perf indicator improves.
            CHECKPOINT_EVERY=1,
        ),
        TEST=Section(
            BATCH_SIZE=8,
            STATE="",
            FLIP_TEST=False,
            POST_PROCESS=False,
            SHIFT_HEATMAP=False,
            USE_GT_BBOX=False,
            IMAGE_THRE=0.1,
            NMS_THRE=0.6,
            OKS_THRE=0.5,
            IN_VIS_THRE=0.0,
            BBOX_FILE="",
            BBOX_THRE=1.0,
            MATCH_IOU_THRE=0.3,
            DETECTOR="fpn_dcn",
            DETECTOR_DIR="",
            MODEL_FILE="",
            FUSE_OUTPUT=True,
        ),
        DEBUG=Section(
            DEBUG=True,
            SAVE_BATCH_IMAGES_GT=True,
            SAVE_BATCH_IMAGES_PRED=True,
            SAVE_HEATMAPS_GT=True,
            SAVE_HEATMAPS_PRED=True,
            SAVE_ALL_PREDS=False,
        ),
        PICT_STRUCT=Section(
            FIRST_NBINS=16,
            RECUR_NBINS=2,
            RECUR_DEPTH=10,
            LIMB_LENGTH_TOLERANCE=150,
            GRID_SIZE=2000,
            DEBUG=False,
            TEST_PAIRWISE=False,
            SHOW_ORIIMG=False,
            SHOW_CROPIMG=False,
            SHOW_HEATIMG=False,
        ),
        PSEUDO_LABEL=Section(
            CONFIDENCE_THRE=0.6,
            IF_RANSAC=True,
            NUM_INLIERS=4,
            REPROJ_THRE=10,
            USE_REPROJ=False,
            REPROJ_TO_OUTLIERS=False,
            IF_LOOP=False,
        ),
    )


def _parse_ratio(expr: str) -> float:
    """Parse the reference's MEAN/STD string form ('123.675/255', or a plain
    float literal) without eval(): a '/'-separated chain of float literals,
    folded left — the only shapes its YAMLs use (lib/core/config.py:237-256)."""
    parts = expr.split("/")
    out = float(parts[0])
    for p in parts[1:]:
        out /= float(p)
    return out


def _coerce(section: str, key: str, value: Any) -> Any:
    """Replicates reference YAML coercions (lib/core/config.py:237-256):
    DATASET.MEAN/STD entries may be strings like '123.675/255'; NETWORK sizes
    may be scalars or pairs."""
    if section == "DATASET" and key in ("MEAN", "STD") and value:
        return np.array(
            [_parse_ratio(x) if isinstance(x, str) else x for x in value]
        )
    if section == "NETWORK" and key in ("HEATMAP_SIZE", "IMAGE_SIZE"):
        if isinstance(value, int):
            return np.array([value, value])
        return np.array(value)
    return value


def _overlay(cfg: Config, updates: Mapping[str, Any]) -> None:
    for k, v in updates.items():
        if k not in cfg:
            raise ValueError(f"{k} not a known config key")
        if isinstance(v, Mapping):
            sec = cfg[k]
            if not isinstance(sec, Section):
                raise ValueError(f"{k} is not a config section")
            for vk, vv in v.items():
                if vk not in sec:
                    raise ValueError(f"{k}.{vk} not a known config key")
                sec[vk] = _coerce(k, vk, vv)
        else:
            cfg[k] = v


def load_config(yaml_path: str | None = None, **overrides: Any) -> Config:
    """Build a config: defaults <- YAML file <- keyword overrides.

    ``overrides`` use dotted keys for nested entries, e.g.
    ``load_config(y, **{"TRAIN.BATCH_SIZE": 32})`` or section dicts.
    """
    cfg = _default_config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            exp = yaml.safe_load(f) or {}
        _overlay(cfg, exp)
    for k, v in overrides.items():
        if "." in k:
            sec, key = k.split(".", 1)
            _overlay(cfg, {sec: {key: v}})
        else:
            _overlay(cfg, {k: v})
    return cfg


def default_config(**overrides: Any) -> Config:
    return load_config(None, **overrides)


def clone(cfg: Config) -> Config:
    return copy.deepcopy(cfg)


def gen_config(cfg: Config, path: str) -> None:
    """Dump a config to YAML (reference: gen_config, config.py:281-288)."""
    import yaml

    with open(path, "w") as f:
        yaml.dump(cfg.to_dict(), f, default_flow_style=False)


def update_dir(cfg: Config, model_dir: str = "", log_dir: str = "", data_dir: str = "") -> None:
    """Rebase data-relative paths (reference: update_dir, config.py:291-308)."""
    if model_dir:
        cfg.OUTPUT_DIR = model_dir
    if log_dir:
        cfg.LOG_DIR = log_dir
    if data_dir:
        cfg.DATA_DIR = data_dir
    cfg.DATASET.ROOT = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
    cfg.TEST.BBOX_FILE = os.path.join(cfg.DATA_DIR, cfg.TEST.BBOX_FILE)
    cfg.NETWORK.PRETRAINED = os.path.join(cfg.DATA_DIR, cfg.NETWORK.PRETRAINED)


def get_model_name(cfg: Config) -> tuple[str, str]:
    """Derive model name/dir suffix (reference: get_model_name, config.py:311-324);
    a ViTPose backbone is named by its depth and width."""
    if cfg.BACKBONE_MODEL == "vitpose":
        name = f"{cfg.MODEL}_{cfg.POSE_VIT.DEPTH}x{cfg.POSE_VIT.EMBED_DIM}"
        filters = cfg.POSE_VIT.NUM_DECONV_FILTERS
    else:
        name = f"{cfg.MODEL}_{cfg.POSE_RESNET.NUM_LAYERS}"
        filters = cfg.POSE_RESNET.NUM_DECONV_FILTERS
    deconv_suffix = "".join(f"d{n}" for n in filters)
    full_name = (
        f"{cfg.NETWORK.IMAGE_SIZE[1]}x{cfg.NETWORK.IMAGE_SIZE[0]}_{name}_{deconv_suffix}"
    )
    return name, full_name
