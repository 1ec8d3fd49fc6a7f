"""3DMatch scene-level benchmark protocol (offline, numpy).

Ref parity: datasets/registration/threedmatch/utils.py:15-228 — scene
tables, gt.log/gt.info parsers, est.log writer, covariance-weighted transform
error, and per-scene registration recall. This is the official 3DMatch
evaluation convention (Choi et al. redwood format): a predicted pair counts
as correct when the covariance-weighted relative-pose error p satisfies
p <= threshold^2, evaluated only over non-consecutive fragment pairs.

A copy of `ref_geotransformer_tpu/data/benchmark_3dmatch.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List

import numpy as np

SCENE_NAME_TO_NUM_FRAGMENTS = {
    "7-scenes-redkitchen": 60,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 60,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 60,
    "sun3d-hotel_uc-scan3": 55,
    "sun3d-hotel_umd-maryland_hotel1": 57,
    "sun3d-hotel_umd-maryland_hotel3": 37,
    "sun3d-mit_76_studyroom-76-1studyroom2": 66,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 38,
}

SCENE_NAME_TO_ABBR = {
    "7-scenes-redkitchen": "Kitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1": "Home_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30": "Home_2",
    "sun3d-hotel_uc-scan3": "Hotel_1",
    "sun3d-hotel_umd-maryland_hotel1": "Hotel_2",
    "sun3d-hotel_umd-maryland_hotel3": "Hotel_3",
    "sun3d-mit_76_studyroom-76-1studyroom2": "Study",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": "MIT_Lab",
}


def get_num_fragments(scene_name: str, gt_log_file: str | None = None) -> int:
    """Fragment count for a benchmark scene. Official scenes come from the
    reference's table (threedmatch/utils.py:15-40); custom/fixture scenes
    fall back to the count recorded in the scene's own gt.log header."""
    if scene_name in SCENE_NAME_TO_NUM_FRAGMENTS:
        return SCENE_NAME_TO_NUM_FRAGMENTS[scene_name]
    if gt_log_file is not None and osp.isfile(gt_log_file):
        with open(gt_log_file) as f:
            head = f.readline().split()
        if len(head) >= 3:
            return int(head[2])
    raise ValueError(f'Unsupported test scene name "{scene_name}".')


def get_scene_abbr(scene_name: str) -> str:
    return SCENE_NAME_TO_ABBR.get(scene_name, scene_name)


def read_log_file(file_name: str) -> List[Dict]:
    """Redwood .log: blocks of 5 lines (ids + 4x4 transform)."""
    with open(file_name) as f:
        lines = [line.strip() for line in f]
    pairs = []
    for i in range(len(lines) // 5):
        head = lines[i * 5].split()
        transform = np.array([lines[i * 5 + j].split() for j in range(1, 5)], np.float32)
        pairs.append(
            {"test_pair": [int(head[0]), int(head[1])], "num_fragments": int(head[2]), "transform": transform}
        )
    return pairs


def read_info_file(file_name: str) -> List[Dict]:
    """Redwood .info: blocks of 7 lines (ids + 6x6 covariance)."""
    with open(file_name) as f:
        lines = [line.strip() for line in f]
    pairs = []
    for i in range(len(lines) // 7):
        head = lines[i * 7].split()
        covariance = np.array([lines[i * 7 + j].split() for j in range(1, 7)], np.float32)
        pairs.append(
            {"test_pair": [int(head[0]), int(head[1])], "num_fragments": int(head[2]), "covariance": covariance}
        )
    return pairs


def write_log_file(file_name: str, test_pairs: List[Dict]) -> None:
    os.makedirs(osp.dirname(file_name), exist_ok=True)
    with open(file_name, "w") as f:
        for pair in test_pairs:
            frag_id0, frag_id1 = pair["test_pair"]
            f.write(f"{frag_id0}\t{frag_id1}\t{pair['num_fragments']}\n")
            for row in np.asarray(pair["transform"]).tolist():
                f.write("\t".join(str(x) for x in row) + "\n")


def read_pose_file(file_name: str) -> np.ndarray:
    """Read a raw 3DMatch per-fragment pose file: one header line, then the
    whitespace-separated rows of the 4x4 camera pose
    (threedmatch/utils.py:52-61)."""
    with open(file_name) as f:
        lines = f.readlines()[1:]
    return np.stack([[float(x) for x in line.split()] for line in lines if line.strip()], axis=0)


def voxel_down_sample_np(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Centroid-per-occupied-voxel downsample (numpy, open3d-free). Voxel
    grid is anchored at the cloud's min bound, matching open3d's
    voxel_down_sample used by the reference's benchmark-authoring path."""
    points = np.asarray(points, np.float64)
    if points.shape[0] == 0:
        return points.astype(np.float32)
    keys = np.floor((points - points.min(axis=0)) / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    np.add.at(sums, inverse, points)
    return (sums / counts[:, None]).astype(np.float32)


def calibrate_ground_truth(
    ref_points: np.ndarray,
    src_points: np.ndarray,
    transform: np.ndarray,
    voxel_size: float = 0.006,
    rng: np.random.Generator | None = None,
):
    """Overlap + 6x6 gt.info covariance for one ground-truth pair — the
    benchmark-scene authoring utility (threedmatch/utils.py:197-228).

    Both clouds are voxel-downsampled to 1 cm; overlap uses radius
    5*voxel_size. The covariance is sum_i g_i^T g_i over <=5000 mutual
    near-neighbor src points, where g = [I_3 | -[p]_x] linearizes the
    small-pose residual (the redwood-benchmark convention: columns 3:6 are
    the rotational DoF crossed against the point). Takes raw (N, 3) arrays
    instead of open3d point clouds.
    """
    from scipy.spatial import cKDTree

    from ref_geotransformer_tpu_torch.utils.registration import apply_transform_np, compute_overlap

    ref_points = voxel_down_sample_np(np.asarray(ref_points), 0.01)
    src_points = voxel_down_sample_np(np.asarray(src_points), 0.01)

    overlap = compute_overlap(ref_points, src_points, transform, positive_radius=voxel_size * 5)

    # per ref point: nearest transformed-src index; keep src points that are
    # the NN of a ref point within voxel_size (duplicates kept, matching the
    # reference's indexing direction at threedmatch/utils.py:208-212)
    src_t = apply_transform_np(src_points, transform)
    nn_distances, nn_indices = cKDTree(src_t).query(ref_points, k=1)
    nn_indices = nn_indices[nn_distances < voxel_size]
    if nn_indices.shape[0] > 5000:
        rng = rng or np.random.default_rng()
        nn_indices = rng.choice(nn_indices, 5000, replace=False)
    p = src_t[nn_indices]
    if p.shape[0] == 0:
        return overlap, np.zeros((6, 6))
    g = np.zeros((p.shape[0], 3, 6))
    g[:, :3, :3] = np.eye(3)
    g[:, 0, 4] = p[:, 2]
    g[:, 0, 5] = -p[:, 1]
    g[:, 1, 3] = -p[:, 2]
    g[:, 1, 5] = p[:, 0]
    g[:, 2, 3] = p[:, 1]
    g[:, 2, 4] = -p[:, 0]
    cov_matrix = np.einsum("nij,nik->jk", g, g)
    return overlap, cov_matrix


def _rotation_to_quaternion(rot: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion from a rotation matrix (Shepperd's method)."""
    m = rot
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q if w >= 0 else -q


def compute_transform_error(transform: np.ndarray, covariance: np.ndarray, estimated_transform: np.ndarray) -> float:
    """Covariance-weighted pose error (threedmatch/utils.py:130-136)."""
    relative = np.linalg.inv(transform) @ estimated_transform
    r = relative[:3, :3]
    t = relative[:3, 3]
    q = _rotation_to_quaternion(r)
    er = np.concatenate([t, q[1:]], axis=0)
    return float((er.reshape(1, 6) @ covariance @ er.reshape(6, 1))[0, 0] / covariance[0, 0])


def compute_registration_error(gt_transform: np.ndarray, transform: np.ndarray):
    """(RRE deg, RTE) between two 4x4 transforms (numpy)."""
    rel_r = gt_transform[:3, :3].T @ transform[:3, :3]
    x = np.clip(0.5 * (np.trace(rel_r) - 1.0), -1.0, 1.0)
    rre = float(np.degrees(np.arccos(x)))
    rte = float(np.linalg.norm(gt_transform[:3, 3] - transform[:3, 3]))
    return rre, rte


def evaluate_registration_one_scene(
    gt_log_file: str, gt_info_file: str, result_file: str, positive_threshold: float = 0.2
) -> Dict:
    """Scene-level precision/recall + RRE/RTE stats (threedmatch/utils.py:139-194)."""
    gt_logs = read_log_file(gt_log_file)
    gt_infos = read_info_file(gt_info_file)
    result_logs = read_log_file(result_file)

    num_fragments = gt_logs[0]["num_fragments"]
    gt_indices = -np.ones((num_fragments, num_fragments), np.int32)
    num_gt_pairs = 0
    for i, gt_log in enumerate(gt_logs):
        frag_id0, frag_id1 = gt_log["test_pair"]
        if frag_id1 > frag_id0 + 1:  # skip consecutive (odometry) pairs
            gt_indices[frag_id0, frag_id1] = i
            num_gt_pairs += 1

    num_pos_pairs = 0
    num_pred_pairs = 0
    rres, rtes, errors = [], [], []
    for result_log in result_logs:
        frag_id0, frag_id1 = result_log["test_pair"]
        if gt_indices[frag_id0, frag_id1] == -1:
            continue
        num_pred_pairs += 1
        gt_index = gt_indices[frag_id0, frag_id1]
        transform = gt_logs[gt_index]["transform"]
        covariance = gt_infos[gt_index]["covariance"]
        error = compute_transform_error(transform, covariance, result_log["transform"])
        errors.append({"id0": frag_id0, "id1": frag_id1, "error": error})
        if error <= positive_threshold**2:
            num_pos_pairs += 1
            rre, rte = compute_registration_error(transform, result_log["transform"])
            rres.append(rre)
            rtes.append(rte)

    def _mean(xs):
        return float(np.mean(xs)) if xs else 0.0

    def _median(xs):
        return float(np.median(xs)) if xs else 0.0

    return {
        "precision": num_pos_pairs / num_pred_pairs if num_pred_pairs > 0 else 0.0,
        "recall": num_pos_pairs / num_gt_pairs if num_gt_pairs > 0 else 0.0,
        "mean_rre": _mean(rres),
        "mean_rte": _mean(rtes),
        "median_rre": _median(rres),
        "median_rte": _median(rtes),
        "num_pos_pairs": num_pos_pairs,
        "num_pred_pairs": num_pred_pairs,
        "num_gt_pairs": num_gt_pairs,
        "errors": errors,
    }
