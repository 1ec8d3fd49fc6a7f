"""3DMatch / 3DLoMatch pair dataset (host side, numpy).

Ref parity: datasets/registration/threedmatch/dataset.py:18-137 — pkl
metadata + per-fragment `.pth` clouds, random point_limit truncation,
augmentation = one random rotation applied to ref OR src (with the GT
rotation/translation updated accordingly) + uniform noise, optional fully
rotated benchmark variant, features = ones(N, 1).

The `.pth` fragments are torch-saved tensors, loaded on the CPU and turned
into numpy arrays.

A copy of `ref_geotransformer_tpu/data/datasets/threedmatch.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict, List, Optional

import numpy as np

from ref_geotransformer_tpu_torch.data.pointcloud import (
    np_get_transform,
    random_point_limit,
    random_sample_rotation,
    random_sample_rotation_v2,
    get_nearest_correspondences,
)


class ThreeDMatchPairDataset:
    subsets = ("train", "val", "3DMatch", "3DLoMatch")

    def __init__(
        self,
        dataset_root: str,
        subset: str,
        point_limit: Optional[int] = None,
        use_augmentation: bool = False,
        augmentation_noise: float = 0.005,
        augmentation_rotation: float = 1.0,
        overlap_threshold: Optional[float] = None,
        return_corr_indices: bool = False,
        matching_radius: Optional[float] = None,
        rotated: bool = False,
        seed: Optional[int] = None,
    ):
        self.dataset_root = dataset_root
        self.metadata_root = osp.join(dataset_root, "metadata")
        self.data_root = osp.join(dataset_root, "data")
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.aug_noise = augmentation_noise
        self.aug_rotation = augmentation_rotation
        self.rotated = rotated
        self.return_corr_indices = return_corr_indices
        self.matching_radius = matching_radius
        if return_corr_indices and matching_radius is None:
            raise ValueError('"matching_radius" is None but "return_corr_indices" is set.')
        self.rng = np.random.default_rng(seed)

        with open(osp.join(self.metadata_root, f"{subset}.pkl"), "rb") as f:
            self.metadata_list: List[Dict] = pickle.load(f)
        if overlap_threshold is not None:
            self.metadata_list = [m for m in self.metadata_list if m["overlap"] > overlap_threshold]

    def __len__(self) -> int:
        return len(self.metadata_list)

    def _load_point_cloud(self, file_name: str) -> np.ndarray:
        import torch  # CPU-only deserialization of the dataset format

        points = torch.load(osp.join(self.data_root, file_name), weights_only=False)
        if hasattr(points, "numpy"):
            points = points.numpy()
        points = np.asarray(points, dtype=np.float32)
        return random_point_limit(points, self.point_limit, self.rng)

    def _augment(self, ref_points, src_points, rotation, translation):
        aug_rotation = random_sample_rotation(self.aug_rotation, self.rng)
        if self.rng.random() > 0.5:
            ref_points = ref_points @ aug_rotation.T
            rotation = aug_rotation @ rotation
            translation = aug_rotation @ translation
        else:
            src_points = src_points @ aug_rotation.T
            rotation = rotation @ aug_rotation.T
        ref_points = ref_points + (self.rng.random(ref_points.shape) - 0.5) * self.aug_noise
        src_points = src_points + (self.rng.random(src_points.shape) - 0.5) * self.aug_noise
        return ref_points, src_points, rotation, translation

    def __getitem__(self, index: int) -> Dict:
        metadata = self.metadata_list[index]
        rotation = np.asarray(metadata["rotation"], np.float32)
        translation = np.asarray(metadata["translation"], np.float32)

        ref_points = self._load_point_cloud(metadata["pcd0"])
        src_points = self._load_point_cloud(metadata["pcd1"])

        if self.use_augmentation:
            ref_points, src_points, rotation, translation = self._augment(
                ref_points, src_points, rotation, translation
            )

        if self.rotated:
            ref_rot = random_sample_rotation_v2(self.rng)
            ref_points = ref_points @ ref_rot.T
            rotation = ref_rot @ rotation
            translation = ref_rot @ translation
            src_rot = random_sample_rotation_v2(self.rng)
            src_points = src_points @ src_rot.T
            rotation = rotation @ src_rot.T

        transform = np_get_transform(rotation.astype(np.float32), translation.astype(np.float32))

        data = {
            "scene_name": metadata["scene_name"],
            "ref_frame": metadata["frag_id0"],
            "src_frame": metadata["frag_id1"],
            "overlap": metadata["overlap"],
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": transform.astype(np.float32),
        }
        if self.return_corr_indices:
            data["corr_indices"] = get_nearest_correspondences(
                ref_points, src_points, transform, self.matching_radius
            )
        return data
