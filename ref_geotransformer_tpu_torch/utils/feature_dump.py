"""Per-pair .npz feature dumps for the offline two-phase eval protocol.

Ref parity: experiments/*/test.py (e.g. geotransformer.3dmatch.../test.py:65-92,
geotransformer.kitti.../test.py:65-80) — the same key set, with one
static-shape consequence: everything coarse is dumped in COMPACTED
(valid-nodes-only) space so the offline eval sees self-consistent shapes;
padded-space proposal indices are remapped to compact positions and the
dense GT overlap map is compacted accordingly.

A copy of `ref_geotransformer_tpu/utils/feature_dump.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os.path as osp

import numpy as np


def dump_registration_npz(feature_dir: str, data, meta, output) -> str:
    """Write one pair's features/correspondences; returns the file path."""
    scene_name = meta["scene_name"]
    ref_frame, src_frame = meta["ref_frame"], meta["src_frame"]
    ref_mask_c = np.asarray(output["ref_node_masks"])
    src_mask_c = np.asarray(output["src_node_masks"])
    ref_mask_f = np.asarray(output["ref_masks_f"])
    src_mask_f = np.asarray(output["src_masks_f"])
    corr_masks = np.asarray(output["corr_masks"])
    ref_remap = np.cumsum(ref_mask_c) - 1
    src_remap = np.cumsum(src_mask_c) - 1
    ref_node_corr = ref_remap[np.asarray(output["ref_node_corr_indices"])]
    src_node_corr = src_remap[np.asarray(output["src_node_corr_indices"])]
    gt_map = np.asarray(output["gt_node_overlap_map"])[np.ix_(ref_mask_c, src_mask_c)]
    file_name = osp.join(feature_dir, f"{scene_name}_{ref_frame}_{src_frame}.npz")
    np.savez_compressed(
        file_name,
        ref_points=np.asarray(data["ref_points"])[np.asarray(data["ref_masks"])],
        src_points=np.asarray(data["src_points"])[np.asarray(data["src_masks"])],
        ref_points_f=np.asarray(output["ref_points_f"])[ref_mask_f],
        src_points_f=np.asarray(output["src_points_f"])[src_mask_f],
        ref_points_c=np.asarray(output["ref_points_c"])[ref_mask_c],
        src_points_c=np.asarray(output["src_points_c"])[src_mask_c],
        ref_feats_c=np.asarray(output["ref_feats_c"])[ref_mask_c],
        src_feats_c=np.asarray(output["src_feats_c"])[src_mask_c],
        ref_node_corr_indices=ref_node_corr,
        src_node_corr_indices=src_node_corr,
        ref_corr_points=np.asarray(output["ref_corr_points"])[corr_masks],
        src_corr_points=np.asarray(output["src_corr_points"])[corr_masks],
        corr_scores=np.asarray(output["corr_scores"])[corr_masks],
        gt_node_corr_overlaps=gt_map,
        estimated_transform=np.asarray(output["estimated_transform"]),
        transform=np.asarray(data["transform"]),
        overlap=meta.get("overlap", 1.0),
    )
    return file_name
