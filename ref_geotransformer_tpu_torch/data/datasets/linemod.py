"""LineMod-Occluded (BOP) 6-DoF object-pose pair dataset — fork addition.

Ref parity: datasets/registration/linemod/linemod.py:17-212 — src = CAD-mesh
surface sample (10k pts, mm -> m), ref = depth back-projection masked by the
visibility mask, GT pose from scene_gt.json, whole-set pickle cache,
augmentation = one-sided random rotation + uniform noise, random truncation
to points_limit.

A copy of `ref_geotransformer_tpu/data/datasets/linemod.py`: its imports
differ (the port imports nothing of the JAX package), and depth maps and
masks are decoded by `png.read_png` instead of PIL, to the same arrays.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.spatial.transform import Rotation

from ref_geotransformer_tpu_torch.data.datasets.bop_utils import (
    depth_to_pointcloud,
    get_camera_info,
    get_gt,
    resize_pcd,
    sample_point_from_mesh,
)
from ref_geotransformer_tpu_torch.data.datasets.png import read_png
from ref_geotransformer_tpu_torch.data.pointcloud import np_get_transform


class LMODataset:
    def __init__(
        self,
        data_folder: str,
        reload_data: bool = False,
        data_augmentation: bool = True,
        rotated: bool = False,
        rot_factor: float = 1.0,
        augment_noise: float = 0.001,
        points_limit: int = 1000,
        mode: str = "train",
        overfit: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.base_dir = osp.join(data_folder, "linemod")
        self.data_augmentation = data_augmentation
        self.rotated = rotated
        self.rot_factor = rot_factor
        self.augment_noise = augment_noise
        self.points_limit = points_limit
        self.mode = mode
        self.corr_radius = 0.01
        self.overfit = overfit
        self.rng = np.random.default_rng(seed)

        cache = osp.join(self.base_dir, "cache", f"lm_{mode}_{points_limit}.pkl")
        if osp.exists(cache) and not reload_data:
            with open(cache, "rb") as f:
                self.data: List[Dict] = pickle.load(f)
        else:
            self.data = self._build_dataset()
            os.makedirs(osp.dirname(cache), exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(self.data, f)

    def _build_dataset(self) -> List[Dict]:
        data = []
        model_root = osp.join(self.base_dir, "models")
        frame_root = osp.join(self.base_dir, self.mode)
        model_files = sorted(Path(model_root).glob("*.ply"))
        obj_ids = [self.overfit - 1] if self.overfit is not None else range(len(model_files))

        for obj_id in obj_ids:
            model_path = str(model_files[obj_id])
            src_full, _ = sample_point_from_mesh(model_path, samples=10000, seed=0)

            model_id = str(obj_id + 1).zfill(6)
            frame_path = osp.join(frame_root, model_id)
            depth_files = {p.stem: str(p) for p in Path(osp.join(frame_path, "depth")).glob("*.png")}
            mask_files = {p.stem: str(p) for p in Path(osp.join(frame_path, "mask_visib")).glob("*.png")}
            gt_path = osp.join(frame_path, "scene_gt.json")
            cam_path = osp.join(frame_path, "scene_camera.json")

            for frame_id in depth_files:
                cam_cx, cam_cy, cam_fx, cam_fy = get_camera_info(cam_path, int(frame_id))
                rot, trans = get_gt(gt_path, int(frame_id))
                depth = read_png(depth_files[frame_id])
                vis_mask = read_png(mask_files[frame_id + "_000000"])
                mask = np.logical_and(vis_mask == 255, depth != 0)
                ref_points = depth_to_pointcloud(depth, mask, cam_cx, cam_cy, cam_fx, cam_fy)

                data.append(
                    {
                        "obj_id": int(obj_id),
                        "frame_id": int(frame_id),
                        "src_points": resize_pcd(src_full * 1000.0 * 0.001, self.points_limit, self.rng).astype(
                            np.float32
                        ),
                        "ref_points": resize_pcd(ref_points, self.points_limit, self.rng).astype(np.float32),
                        "rot": rot.astype(np.float32),
                        "trans": trans.astype(np.float32),
                    }
                )
        return data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict:
        item = self.data[index]
        src_points = item["src_points"].copy()
        ref_points = item["ref_points"].copy()
        rot = item["rot"].copy()
        trans = item["trans"].reshape(3).copy()

        if self.data_augmentation:
            euler = self.rng.random(3) * np.pi * 2.0 / self.rot_factor
            rot_ab = Rotation.from_euler("zyx", euler).as_matrix().astype(np.float32)
            if self.rng.random() > 0.5:
                src_points = src_points @ rot_ab.T
                rot = rot @ rot_ab.T
            else:
                ref_points = ref_points @ rot_ab.T
                rot = rot_ab @ rot
                trans = rot_ab @ trans
            src_points = src_points + (self.rng.random(src_points.shape) - 0.5) * self.augment_noise
            ref_points = ref_points + (self.rng.random(ref_points.shape) - 0.5) * self.augment_noise

        transform = np_get_transform(rot.astype(np.float32), trans.astype(np.float32))
        return {
            "scene_name": f"lmo_obj{item['obj_id']}",
            "ref_frame": item["frame_id"],
            "src_frame": item["obj_id"],
            "overlap": 1.0,
            "obj_id": int(item["obj_id"]),
            "frame_id": int(item["frame_id"]),
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": transform.astype(np.float32),
        }
