"""ModelNet40 synthetic registration pairs (host side, numpy).

Ref parity: datasets/registration/modelnet/dataset.py:24-243 — normalize to
the unit sphere, RPMNet-style random SE(3) (rotation <= rotation_magnitude
deg, translation <= translation_magnitude), plane/viewpoint crop keeping
keep_ratio, twice-sample to num_points, jitter, shuffle; 40 categories with
the asymmetric-category filter and seen/unseen splits.

A copy of `ref_geotransformer_tpu/data/datasets/modelnet.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict, List, Optional, Union

import numpy as np

from ref_geotransformer_tpu_torch.data.pointcloud import np_get_transform, np_inverse_transform
from ref_geotransformer_tpu_torch.data.transforms import (
    normalize_points,
    random_crop_points_from_viewpoint,
    random_crop_points_with_plane,
    random_jitter_points,
    random_sample_points,
    random_sample_viewpoint,
    random_shuffle_points,
)
from ref_geotransformer_tpu_torch.utils.registration import compute_overlap


def random_sample_transform(
    rotation_magnitude: float, translation_magnitude: float, rng: np.random.Generator
) -> np.ndarray:
    """Random SE(3) with per-axis Euler angles <= rotation_magnitude (deg)
    and per-axis translation <= translation_magnitude."""
    euler = rng.uniform(-rotation_magnitude, rotation_magnitude, 3) * np.pi / 180.0
    cx, cy, cz = np.cos(euler)
    sx, sy, sz = np.sin(euler)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rotation = (rz @ ry @ rx).astype(np.float32)
    translation = rng.uniform(-translation_magnitude, translation_magnitude, 3).astype(np.float32)
    return np_get_transform(rotation, translation)


class ModelNetPairDataset:
    # fmt: off
    ALL_CATEGORIES = [
        'airplane', 'bathtub', 'bed', 'bench', 'bookshelf', 'bottle', 'bowl', 'car', 'chair', 'cone', 'cup',
        'curtain', 'desk', 'door', 'dresser', 'flower_pot', 'glass_box', 'guitar', 'keyboard', 'lamp', 'laptop',
        'mantel', 'monitor', 'night_stand', 'person', 'piano', 'plant', 'radio', 'range_hood', 'sink', 'sofa',
        'stairs', 'stool', 'table', 'tent', 'toilet', 'tv_stand', 'vase', 'wardrobe', 'xbox',
    ]
    ASYMMETRIC_INDICES = [
        0, 1, 2, 3, 4, 7, 8, 11, 12, 13, 14, 16, 17, 18, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
        35, 36, 38, 39,
    ]
    # fmt: on

    def __init__(
        self,
        dataset_root: str,
        subset: str,
        num_points: int = 1024,
        rotation_magnitude: float = 45.0,
        translation_magnitude: float = 0.5,
        noise_magnitude: Optional[float] = None,
        keep_ratio: float = 0.7,
        crop_method: str = "plane",
        asymmetric: bool = True,
        class_indices: Union[str, List[int]] = "all",
        deterministic: bool = False,
        twice_sample: bool = False,
        twice_transform: bool = False,
        min_overlap: Optional[float] = None,
        max_overlap: Optional[float] = None,
        overfitting_index: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        assert subset in ("train", "val", "test")
        assert crop_method in ("plane", "point")
        self.subset = subset
        self.num_points = num_points
        self.rotation_magnitude = rotation_magnitude
        self.translation_magnitude = translation_magnitude
        self.noise_magnitude = noise_magnitude
        self.keep_ratio = keep_ratio
        self.crop_method = crop_method
        self.deterministic = deterministic
        self.twice_sample = twice_sample
        self.twice_transform = twice_transform
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.check_overlap = min_overlap is not None or max_overlap is not None
        self.overfitting_index = overfitting_index
        self.class_indices = self._get_class_indices(class_indices, asymmetric)
        self.base_seed = seed

        with open(osp.join(dataset_root, f"{subset}.pkl"), "rb") as f:
            data_list = pickle.load(f)
        data_list = [x for x in data_list if x["label"] in self.class_indices]
        if overfitting_index is not None and deterministic:
            data_list = [data_list[overfitting_index]]
        self.data_list = data_list

    def _get_class_indices(self, class_indices, asymmetric) -> List[int]:
        if isinstance(class_indices, str):
            assert class_indices in ("all", "seen", "unseen")
            if class_indices == "all":
                class_indices = list(range(40))
            elif class_indices == "seen":
                class_indices = list(range(20))
            else:
                class_indices = list(range(20, 40))
        if asymmetric:
            class_indices = [x for x in class_indices if x in self.ASYMMETRIC_INDICES]
        return class_indices

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int) -> Dict:
        if self.overfitting_index is not None:
            index = min(self.overfitting_index, len(self.data_list) - 1)
        item = self.data_list[index]
        if self.deterministic:
            rng = np.random.default_rng(index)
        else:
            rng = np.random.default_rng(None if self.base_seed is None else self.base_seed + index * 9973)

        raw_points = normalize_points(np.asarray(item["points"], np.float32).copy())
        raw_normals = np.asarray(item.get("normals", np.zeros_like(raw_points)), np.float32).copy()

        if not self.twice_sample:
            raw_points, raw_normals = random_sample_points(raw_points, self.num_points, raw_normals, rng)

        ref_points = raw_points.copy()
        ref_normals = raw_normals.copy()
        if self.twice_transform:
            t = random_sample_transform(self.rotation_magnitude, self.translation_magnitude, rng)
            ref_points = ref_points @ t[:3, :3].T + t[:3, 3]
            ref_normals = ref_normals @ t[:3, :3].T

        src_points = ref_points.copy()
        src_normals = ref_normals.copy()
        transform = random_sample_transform(self.rotation_magnitude, self.translation_magnitude, rng)
        inv = np_inverse_transform(transform)
        src_points = src_points @ inv[:3, :3].T + inv[:3, 3]
        src_normals = src_normals @ inv[:3, :3].T

        raw_ref = (ref_points, ref_normals)
        raw_src = (src_points, src_normals)
        while True:
            ref_points, ref_normals = raw_ref
            src_points, src_normals = raw_src
            if self.keep_ratio is not None:
                if self.crop_method == "plane":
                    ref_points, ref_normals = random_crop_points_with_plane(
                        ref_points, keep_ratio=self.keep_ratio, normals=ref_normals, rng=rng
                    )
                    src_points, src_normals = random_crop_points_with_plane(
                        src_points, keep_ratio=self.keep_ratio, normals=src_normals, rng=rng
                    )
                else:
                    viewpoint = random_sample_viewpoint(rng=rng)
                    ref_points, ref_normals = random_crop_points_from_viewpoint(
                        ref_points, viewpoint=viewpoint, keep_ratio=self.keep_ratio, normals=ref_normals, rng=rng
                    )
                    src_points, src_normals = random_crop_points_from_viewpoint(
                        src_points, viewpoint=viewpoint, keep_ratio=self.keep_ratio, normals=src_normals, rng=rng
                    )
            if not self.check_overlap:
                break
            overlap = compute_overlap(ref_points, src_points, transform, positive_radius=0.05)
            if (self.min_overlap is None or overlap >= self.min_overlap) and (
                self.max_overlap is None or overlap <= self.max_overlap
            ):
                break

        if self.twice_sample:
            ref_points, ref_normals = random_sample_points(ref_points, self.num_points, ref_normals, rng)
            src_points, src_normals = random_sample_points(src_points, self.num_points, src_normals, rng)

        if self.noise_magnitude is not None:
            ref_points = random_jitter_points(ref_points, 0.01, self.noise_magnitude, rng)
            src_points = random_jitter_points(src_points, 0.01, self.noise_magnitude, rng)

        ref_points, ref_normals = random_shuffle_points(ref_points, ref_normals, rng)
        src_points, src_normals = random_shuffle_points(src_points, src_normals, rng)

        return {
            "scene_name": f"modelnet_{index}",
            "ref_frame": 0,
            "src_frame": 1,
            "overlap": 1.0,
            "raw_points": raw_points.astype(np.float32),
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_normals": ref_normals.astype(np.float32),
            "src_normals": src_normals.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": transform.astype(np.float32),
            "label": int(item["label"]),
            "index": int(index),
        }
