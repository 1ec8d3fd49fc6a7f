"""Single-pair demo dataset over data/demo/{ref,src,gt}.npy.

A copy of `ref_geotransformer_tpu/data/datasets/demo.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np


class DemoPairDataset:
    def __init__(self, demo_root: str):
        self.ref_points = np.load(osp.join(demo_root, "ref.npy")).astype(np.float32)
        self.src_points = np.load(osp.join(demo_root, "src.npy")).astype(np.float32)
        self.transform = np.load(osp.join(demo_root, "gt.npy")).astype(np.float32)

    def __len__(self) -> int:
        return 1

    def __getitem__(self, index: int) -> Dict:
        return {
            "scene_name": "demo",
            "ref_frame": 0,
            "src_frame": 1,
            "overlap": 1.0,
            "ref_points": self.ref_points,
            "src_points": self.src_points,
            "ref_feats": np.ones((self.ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((self.src_points.shape[0], 1), np.float32),
            "transform": self.transform,
        }
