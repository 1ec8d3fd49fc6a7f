"""3DMatch stage4 experiment config.

Counterpart of `experiments/geotransformer_3dmatch_stage4/config.py`
(value parity: upstream experiments/geotransformer.3dmatch.stage4.gse.k3.
max.oacl.stage2.sinkhorn/config.py:33-141), built on
`config/threedmatch.py::make_cfg` with the same environment overrides:

- REF_GT_OUTPUT_ROOT / REF_GT_3DMATCH_ROOT relocate the outputs / the
  dataset (default `<repo>/output/torch` and `<repo>/data/3DMatch`). The
  directory constants are read from the environment at each access, so a
  caller in the same process may point them elsewhere.
- REF_GT_NEIGHBOR_LIMITS="32,28,28,32" replaces the calibrated per-level
  neighbor caps [38, 36, 36, 38].
- REF_GT_CAPS_SCALE shrinks the static point capacities (channel widths
  stay); e.g. 0.3 makes the coarse cap max(128, int(1024 * 0.3)) = 307.
- REF_GT_LR / REF_GT_LR_DECAY / REF_GT_USE_AUG set the learning rate, its
  per-epoch decay and the train augmentation (default 1e-4, 0.95, on).
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp

from ref_geotransformer_tpu_torch.config import (
    GeoTransformerConfig,
    RansacConfig,
    TestDataConfig,
    TrainDataConfig,
)
from ref_geotransformer_tpu_torch.config.threedmatch import make_cfg as make_base_cfg

_WORKING_DIR = osp.dirname(osp.realpath(__file__))
_ROOT_DIR = osp.dirname(osp.dirname(osp.dirname(_WORKING_DIR)))
EXP_NAME = osp.basename(_WORKING_DIR)
_OUTPUT_SUBDIRS = {"OUTPUT_DIR": "", "SNAPSHOT_DIR": "snapshots", "LOG_DIR": "logs", "EVENT_DIR": "events",
                   "FEATURE_DIR": "features", "REGISTRATION_DIR": "registration"}


def __getattr__(name: str) -> str:
    """OUTPUT_DIR, SNAPSHOT_DIR, LOG_DIR, EVENT_DIR, FEATURE_DIR,
    REGISTRATION_DIR and DATASET_ROOT, from the environment as it is now."""
    if name == "DATASET_ROOT":
        return os.environ.get("REF_GT_3DMATCH_ROOT", osp.join(_ROOT_DIR, "data", "3DMatch"))
    if name in _OUTPUT_SUBDIRS:
        output_dir = osp.join(os.environ.get("REF_GT_OUTPUT_ROOT", osp.join(_ROOT_DIR, "output", "torch")), EXP_NAME)
        return osp.join(output_dir, _OUTPUT_SUBDIRS[name]) if _OUTPUT_SUBDIRS[name] else output_dir
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_cfg(demo: bool = False) -> GeoTransformerConfig:
    """demo=True shrinks the point capacities to the demo pair's pyramid
    (20480/6144/2048/512 points)."""
    cfg = make_base_cfg(demo=demo)
    capacities = cfg.capacities
    nl_env = os.environ.get("REF_GT_NEIGHBOR_LIMITS")
    if nl_env:
        limits = tuple(int(x) for x in nl_env.split(","))
        if len(limits) != 4:
            raise ValueError(f"REF_GT_NEIGHBOR_LIMITS needs 4 neighbor limits, got {nl_env}")
        capacities = dataclasses.replace(capacities, neighbor_limits=limits)
    scale = float(os.environ.get("REF_GT_CAPS_SCALE", "1.0"))
    if scale != 1.0:
        pts = tuple(max(128, int(p * scale)) for p in capacities.points)
        capacities = dataclasses.replace(
            capacities,
            points=pts,
            gt_candidates=min(capacities.gt_candidates, pts[-1] * 4),
            correspondence_limit=min(capacities.correspondence_limit, 2048),
            search_chunk=min(capacities.search_chunk, 512),
        )
    return cfg.replace(
        capacities=capacities,
        ransac=RansacConfig(distance_threshold=0.05, num_points=3, num_iterations=1000),
        optim=dataclasses.replace(
            cfg.optim,
            lr=float(os.environ.get("REF_GT_LR", "1e-4")),
            lr_decay=float(os.environ.get("REF_GT_LR_DECAY", "0.95")),
        ),
        train=TrainDataConfig(
            batch_size=1,
            num_workers=8,
            point_limit=30000,
            use_augmentation=os.environ.get("REF_GT_USE_AUG", "1") != "0",
            augmentation_noise=0.005,
            augmentation_rotation=1.0,
        ),
        test=TestDataConfig(batch_size=1, num_workers=8, point_limit=None),
    )
