"""KITTI odometry pair dataset (host side, numpy).

Ref parity: datasets/registration/kitti/dataset.py:16-122 — seq splits
train 00-05 / val 06-07 / test 08-10, npy downsampled clouds, augmentation =
noise + one-sided rotation + global scale in [0.8, 1.2] + per-cloud shift of
±2 m with the GT transform recomposed accordingly.

A copy of `ref_geotransformer_tpu/data/datasets/kitti.py`: only its imports
differ (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict, Optional

import numpy as np

from ref_geotransformer_tpu_torch.data.pointcloud import (
    np_get_transform,
    random_point_limit,
    random_sample_rotation,
    get_nearest_correspondences,
)


class OdometryKittiPairDataset:
    ODOMETRY_KITTI_DATA_SPLIT = {
        "train": ["00", "01", "02", "03", "04", "05"],
        "val": ["06", "07"],
        "test": ["08", "09", "10"],
    }

    def __init__(
        self,
        dataset_root: str,
        subset: str,
        point_limit: Optional[int] = None,
        use_augmentation: bool = False,
        augmentation_noise: float = 0.005,
        augmentation_min_scale: float = 0.8,
        augmentation_max_scale: float = 1.2,
        augmentation_shift: float = 2.0,
        augmentation_rotation: float = 1.0,
        return_corr_indices: bool = False,
        matching_radius: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        self.dataset_root = dataset_root
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.augmentation_noise = augmentation_noise
        self.augmentation_min_scale = augmentation_min_scale
        self.augmentation_max_scale = augmentation_max_scale
        self.augmentation_shift = augmentation_shift
        self.augmentation_rotation = augmentation_rotation
        self.return_corr_indices = return_corr_indices
        self.matching_radius = matching_radius
        if return_corr_indices and matching_radius is None:
            raise ValueError('"matching_radius" is None but "return_corr_indices" is set.')
        self.rng = np.random.default_rng(seed)
        with open(osp.join(dataset_root, "metadata", f"{subset}.pkl"), "rb") as f:
            self.metadata = pickle.load(f)

    def __len__(self) -> int:
        return len(self.metadata)

    def _load_point_cloud(self, file_name: str) -> np.ndarray:
        points = np.load(file_name).astype(np.float32)
        return random_point_limit(points, self.point_limit, self.rng)

    def _augment(self, ref_points, src_points, transform):
        rotation = transform[:3, :3]
        translation = transform[:3, 3]
        ref_points = ref_points + (self.rng.random(ref_points.shape) - 0.5) * self.augmentation_noise
        src_points = src_points + (self.rng.random(src_points.shape) - 0.5) * self.augmentation_noise
        aug_rotation = random_sample_rotation(self.augmentation_rotation, self.rng)
        if self.rng.random() > 0.5:
            ref_points = ref_points @ aug_rotation.T
            rotation = aug_rotation @ rotation
            translation = aug_rotation @ translation
        else:
            src_points = src_points @ aug_rotation.T
            rotation = rotation @ aug_rotation.T
        scale = self.augmentation_min_scale + (
            self.augmentation_max_scale - self.augmentation_min_scale
        ) * self.rng.random()
        ref_points = ref_points * scale
        src_points = src_points * scale
        translation = translation * scale
        ref_shift = self.rng.uniform(-self.augmentation_shift, self.augmentation_shift, 3)
        src_shift = self.rng.uniform(-self.augmentation_shift, self.augmentation_shift, 3)
        ref_points = ref_points + ref_shift
        src_points = src_points + src_shift
        translation = -(rotation @ src_shift) + translation + ref_shift
        return ref_points, src_points, np_get_transform(
            rotation.astype(np.float32), translation.astype(np.float32)
        )

    def __getitem__(self, index: int) -> Dict:
        metadata = self.metadata[index]
        ref_points = self._load_point_cloud(osp.join(self.dataset_root, metadata["pcd0"]))
        src_points = self._load_point_cloud(osp.join(self.dataset_root, metadata["pcd1"]))
        transform = np.asarray(metadata["transform"], np.float32)

        if self.use_augmentation:
            ref_points, src_points, transform = self._augment(ref_points, src_points, transform)

        data = {
            "scene_name": f"seq{metadata['seq_id']}",
            "ref_frame": metadata["frame0"],
            "src_frame": metadata["frame1"],
            "overlap": 1.0,
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
