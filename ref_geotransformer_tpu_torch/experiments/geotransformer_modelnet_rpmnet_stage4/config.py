"""ModelNet rpmnet stage-4 experiment config (trains on LineMod by default).

Counterpart of `experiments/geotransformer_modelnet_rpmnet_stage4/config.py`
(value parity: upstream experiments/geotransformer.modelnet.rpmnet.stage4.
gse.k3.max.oacl.stage2.sinkhorn/config.py:33-173), built on
`config/modelnet.py::make_cfg` with the same environment overrides:

- REF_GT_OUTPUT_ROOT relocates the outputs (default `<repo>/output/torch`);
  REF_GT_LINEMOD_ROOT the folder that holds `linemod/` (default
  `<repo>/data`); REF_GT_MODELNET_ROOT the ModelNet pickles (default
  `<repo>/data/ModelNet`). These constants, and `LMO` (whose data_folder
  is the LineMod root) and `DDPM`, are read from the environment at each
  access, so a caller in the same process may point them elsewhere.
- REF_GT_LR / REF_GT_WARMUP set the learning rate and the warmup (default
  1e-4 and 10000 iterations), for short runs that must leave the warmup.
- REF_GT_DDPM_STEPS shortens Cordi's diffusion chain (default 100), which
  `DDPM` configures for `train_cordi` and `test --cordi_snapshot`.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp

from ref_geotransformer_tpu_torch.config import DDPMConfig, GeoTransformerConfig
from ref_geotransformer_tpu_torch.config.modelnet import make_cfg as make_base_cfg

_WORKING_DIR = osp.dirname(osp.realpath(__file__))
_ROOT_DIR = osp.dirname(osp.dirname(osp.dirname(_WORKING_DIR)))
EXP_NAME = osp.basename(_WORKING_DIR)
_OUTPUT_SUBDIRS = {"OUTPUT_DIR": "", "SNAPSHOT_DIR": "snapshots", "SNAPSHOT_ENCODER_DIR": "snapshots/encoder",
                   "SNAPSHOT_DDPM_DIR": "snapshots/ddpm", "LOG_DIR": "logs", "FEATURE_DIR": "features"}

# ModelNet synthetic-pair knobs (modelnet config.py:34-45)
MODELNET = dict(
    num_points=717,
    rotation_magnitude=45.0,
    translation_magnitude=0.5,
    keep_ratio=0.7,
    crop_method="plane",
    asymmetric=True,
    twice_sample=True,
    twice_transform=False,
    noise_magnitude=0.05,
    class_indices="all",
)


def _lmo() -> dict:
    """LineMod loader knobs (modelnet config.py:47-55)."""
    return dict(
        data_folder=os.environ.get("REF_GT_LINEMOD_ROOT", osp.join(_ROOT_DIR, "data")),
        reload_data=False,
        data_augmentation=True,
        rotated=False,
        rot_factor=1.0,
        augment_noise=0.001,
        points_limit=1000,
        overfit=None,
    )


def __getattr__(name: str):
    """The directories, LINEMOD_ROOT, MODELNET_ROOT, LMO and DDPM, from the
    environment as it is now."""
    if name == "LINEMOD_ROOT":
        return os.environ.get("REF_GT_LINEMOD_ROOT", osp.join(_ROOT_DIR, "data"))
    if name == "MODELNET_ROOT":
        return os.environ.get("REF_GT_MODELNET_ROOT", osp.join(_ROOT_DIR, "data", "ModelNet"))
    if name == "LMO":
        return _lmo()
    if name == "DDPM":
        return DDPMConfig(num_steps=int(os.environ.get("REF_GT_DDPM_STEPS", "100")))
    if name in _OUTPUT_SUBDIRS:
        output_dir = osp.join(os.environ.get("REF_GT_OUTPUT_ROOT", osp.join(_ROOT_DIR, "output", "torch")), EXP_NAME)
        return osp.join(output_dir, _OUTPUT_SUBDIRS[name]) if _OUTPUT_SUBDIRS[name] else output_dir
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_cfg() -> GeoTransformerConfig:
    cfg = make_base_cfg()
    return cfg.replace(optim=dataclasses.replace(
        cfg.optim,
        lr=float(os.environ.get("REF_GT_LR", "1e-4")),
        warmup_steps=int(os.environ.get("REF_GT_WARMUP", "10000")),
    ))
