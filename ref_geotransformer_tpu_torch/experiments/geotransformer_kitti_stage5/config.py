"""KITTI odometry stage-5 experiment config.

Counterpart of `experiments/geotransformer_kitti_stage5/config.py` (value
parity: upstream experiments/geotransformer.kitti.stage5.gse.k3.max.oacl.
stage2.sinkhorn/config.py:33-141), built on `config/kitti.py::make_cfg`
with the same environment overrides:

- REF_GT_OUTPUT_ROOT / REF_GT_KITTI_ROOT relocate the outputs / the dataset
  (default `<repo>/output/torch` and `<repo>/data/Kitti`). The directory
  constants are read from the environment at each access, so a caller in
  the same process may point them elsewhere.
- REF_GT_CAPS_SCALE shrinks the static point capacities (channel widths
  stay): each cap becomes max(128, int(cap * scale)), gt_candidates at most
  4x the coarse cap, correspondence_limit at most 2048, search_chunk at
  most 512.

The capacities are sized for the 0.3 m-downsampled odometry scans; re-derive
them and the neighbor limits for another dataset with
`ref_geotransformer_tpu_torch.data.calibration`.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp

from ref_geotransformer_tpu_torch.config import GeoTransformerConfig
from ref_geotransformer_tpu_torch.config.kitti import make_cfg as make_base_cfg

_WORKING_DIR = osp.dirname(osp.realpath(__file__))
_ROOT_DIR = osp.dirname(osp.dirname(osp.dirname(_WORKING_DIR)))
EXP_NAME = osp.basename(_WORKING_DIR)
_OUTPUT_SUBDIRS = {"OUTPUT_DIR": "", "SNAPSHOT_DIR": "snapshots", "LOG_DIR": "logs", "EVENT_DIR": "events",
                   "FEATURE_DIR": "features", "REGISTRATION_DIR": "registration"}


def __getattr__(name: str) -> str:
    """OUTPUT_DIR, SNAPSHOT_DIR, LOG_DIR, EVENT_DIR, FEATURE_DIR,
    REGISTRATION_DIR and DATASET_ROOT, from the environment as it is now."""
    if name == "DATASET_ROOT":
        return os.environ.get("REF_GT_KITTI_ROOT", osp.join(_ROOT_DIR, "data", "Kitti"))
    if name in _OUTPUT_SUBDIRS:
        output_dir = osp.join(os.environ.get("REF_GT_OUTPUT_ROOT", osp.join(_ROOT_DIR, "output", "torch")), EXP_NAME)
        return osp.join(output_dir, _OUTPUT_SUBDIRS[name]) if _OUTPUT_SUBDIRS[name] else output_dir
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_cfg() -> GeoTransformerConfig:
    cfg = make_base_cfg()
    scale = float(os.environ.get("REF_GT_CAPS_SCALE", "1.0"))
    if scale == 1.0:
        return cfg
    capacities = cfg.capacities
    pts = tuple(max(128, int(p * scale)) for p in capacities.points)
    return cfg.replace(capacities=dataclasses.replace(
        capacities,
        points=pts,
        gt_candidates=min(capacities.gt_candidates, pts[-1] * 4),
        correspondence_limit=min(capacities.correspondence_limit, 2048),
        search_chunk=min(capacities.search_chunk, 512),
    ))
