"""BOP (LineMod-Occluded) data utilities, dependency-light.

Ref parity: datasets/registration/linemod/bop_utils.py:12-249 — mesh
sampling, bbox/mask helpers, GT/cam parsers. The reference uses open3d +
cv2; here: a pure-numpy PLY reader + area-weighted triangle sampling, and
scipy.ndimage for the largest connected component (cv2.findContours' role).

A copy of `ref_geotransformer_tpu/data/datasets/bop_utils.py`, its
correspondence-matrix helpers for Cordi (`build_corr_matrix`,
`get_corr_from_matrix_topk_np`) included.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

BORDER_LIST = [-1, 40, 80, 120, 160, 200, 240, 280, 320, 360, 400, 440, 480, 520, 560, 600, 640, 680]


def read_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader (ascii + binary_little_endian) returning
    (vertices (V, 3) float64, faces (F, 3) int64)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header_lines if l.startswith("format"))
        counts = {}
        props = {}
        current = None
        for line in header_lines:
            parts = line.split()
            if parts and parts[0] == "element":
                current = parts[1]
                counts[current] = int(parts[2])
                props[current] = []
            elif parts and parts[0] == "property" and current is not None:
                props[current].append(parts[1:])

        nv = counts.get("vertex", 0)
        nf = counts.get("face", 0)

        type_map = {
            "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8), "float64": ("f8", 8),
            "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1), "int8": ("i1", 1),
            "short": ("i2", 2), "int16": ("i2", 2), "ushort": ("u2", 2), "uint16": ("u2", 2),
            "int": ("i4", 4), "int32": ("i4", 4), "uint": ("u4", 4), "uint32": ("u4", 4),
        }

        if fmt == "ascii":
            tokens = f.read().decode("ascii").split("\n")
            vertex_rows = [tokens[i].split() for i in range(nv)]
            vertices = np.array([[float(r[0]), float(r[1]), float(r[2])] for r in vertex_rows])
            faces = []
            for i in range(nv, nv + nf):
                row = tokens[i].split()
                k = int(row[0])
                if k >= 3:
                    faces.append([int(row[1]), int(row[2]), int(row[3])])
            return vertices, np.asarray(faces, np.int64)

        # binary little endian
        vert_dtype = np.dtype([(f"p{i}", "<" + type_map[p[0]][0]) for i, p in enumerate(props["vertex"])])
        vert_data = np.frombuffer(f.read(vert_dtype.itemsize * nv), dtype=vert_dtype, count=nv)
        vertices = np.stack([vert_data["p0"], vert_data["p1"], vert_data["p2"]], axis=1).astype(np.float64)

        faces = np.empty((nf, 3), np.int64)
        face_props = props.get("face", [])
        # standard: property list uchar int vertex_indices
        count_t = "<" + type_map[face_props[0][1]][0]
        idx_t = "<" + type_map[face_props[0][2]][0]
        count_size = np.dtype(count_t).itemsize
        idx_size = np.dtype(idx_t).itemsize
        buf = f.read()
        off = 0
        for i in range(nf):
            k = int(np.frombuffer(buf, count_t, 1, off)[0])
            off += count_size
            idx = np.frombuffer(buf, idx_t, k, off)
            off += idx_size * k
            faces[i] = idx[:3]
        return vertices, faces


def sample_point_from_mesh(model_path: str, samples: int = 10000, seed: Optional[int] = None):
    """Uniform (area-weighted) surface sampling; coordinates scaled mm -> m
    (bop_utils.py:12-21's open3d sample_points_uniformly + 0.001 scale)."""
    rng = np.random.default_rng(seed)
    vertices, faces = read_ply_mesh(model_path)
    v0, v1, v2 = vertices[faces[:, 0]], vertices[faces[:, 1]], vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), samples, p=probs)
    u = rng.random((samples, 1))
    v = rng.random((samples, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    points = v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])
    points = points * 0.001
    normals = np.cross(v1[tri] - v0[tri], v2[tri] - v0[tri])
    normals = normals / (np.linalg.norm(normals, axis=1, keepdims=True) + 1e-12)
    return points, normals


def mask_to_bbox(mask: np.ndarray) -> list:
    """Bounding box [x, y, w, h] of the largest connected mask component
    (bop_utils.py:59-65, cv2-free via scipy.ndimage)."""
    from scipy import ndimage

    labeled, num = ndimage.label(mask.astype(np.uint8))
    if num == 0:
        return [0, 0, 0, 0]
    sizes = ndimage.sum_labels(np.ones_like(labeled), labeled, index=range(1, num + 1))
    largest = int(np.argmax(sizes)) + 1
    rows, cols = np.nonzero(labeled == largest)
    x, y = int(cols.min()), int(rows.min())
    w, h = int(cols.max() - cols.min() + 1), int(rows.max() - rows.min() + 1)
    return [x, y, w, h]


def get_bbox(bbox: list) -> Tuple[int, int, int, int]:
    """Snap a bbox to the BOP border grid (bop_utils.py:23-57)."""
    rmin, rmax, cmin, cmax = bbox[1], bbox[1] + bbox[3], bbox[0], bbox[0] + bbox[2]
    rmin, rmax = max(rmin, 0), min(rmax, 479)
    cmin, cmax = max(cmin, 0), min(cmax, 639)
    r_b, c_b = rmax - rmin, cmax - cmin
    for i in range(len(BORDER_LIST) - 1):
        if BORDER_LIST[i] < r_b < BORDER_LIST[i + 1]:
            r_b = BORDER_LIST[i + 1]
            break
    for i in range(len(BORDER_LIST) - 1):
        if BORDER_LIST[i] < c_b < BORDER_LIST[i + 1]:
            c_b = BORDER_LIST[i + 1]
            break
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
    rmin, rmax = center[0] - r_b // 2, center[0] + r_b // 2
    cmin, cmax = center[1] - c_b // 2, center[1] + c_b // 2
    return max(rmin, 0), min(rmax, 480), max(cmin, 0), min(cmax, 640)


def get_gt(gt_file: str, frame_id: int):
    """GT pose from scene_gt.json; translation mm -> m (bop_utils.py:67-76)."""
    with open(gt_file) as f:
        gt = json.load(f)[str(frame_id)][0]
    rot = np.array(gt["cam_R_m2c"]).reshape(3, 3)
    trans = np.array(gt["cam_t_m2c"]) / 1000.0
    return rot, trans


def get_camera_info(cam_file: str, frame_id: int):
    """Camera intrinsics from scene_camera.json (bop_utils.py:78-88)."""
    with open(cam_file) as f:
        cam = json.load(f)[str(frame_id)]
    cam_k = np.array(cam["cam_K"]).reshape(3, 3)
    return cam_k[0, 2], cam_k[1, 2], cam_k[0, 0], cam_k[1, 1]


def resize_pcd(pcd: np.ndarray, points_limit: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random truncation to points_limit (bop_utils.py:90-96)."""
    rng = rng or np.random.default_rng()
    if pcd.shape[0] > points_limit:
        pcd = pcd[rng.permutation(pcd.shape[0])[:points_limit]]
    return pcd


def depth_to_pointcloud(
    depth: np.ndarray, mask: np.ndarray, cam_cx: float, cam_cy: float, cam_fx: float, cam_fy: float
) -> np.ndarray:
    """Back-project masked depth to a camera-frame cloud in meters
    (linemod.py:169-185's xmap/ymap logic, vectorized)."""
    rmin, rmax, cmin, cmax = get_bbox(mask_to_bbox(mask))
    sub_mask = mask[rmin:rmax, cmin:cmax]
    sub_depth = depth[rmin:rmax, cmin:cmax].astype(np.float32)
    rows, cols = np.nonzero(sub_mask)
    z = sub_depth[rows, cols]
    xs = (cols + cmin - cam_cx) * z / cam_fx
    ys = (rows + rmin - cam_cy) * z / cam_fy
    cloud = np.stack([xs, ys, z], axis=1)
    return cloud / 1000.0


def build_corr_matrix(
    ref_points: np.ndarray, src_points: np.ndarray, transform: np.ndarray, radius: float
) -> np.ndarray:
    """+-1 correspondence matrix from nearest-within-radius pairs
    (bop_utils.py:199-224)."""
    from scipy.spatial import cKDTree

    src_t = src_points @ transform[:3, :3].T + transform[:3, 3]
    tree = cKDTree(src_t)
    pairs = tree.query_ball_point(ref_points, radius)
    mat = -np.ones((ref_points.shape[0], src_points.shape[0]), np.float32)
    for i, js in enumerate(pairs):
        for j in js:
            mat[i, j] = 1.0
    return mat


def get_corr_from_matrix_topk_np(corr_matrix: np.ndarray, k: int):
    """Top-k cells of a correspondence matrix (bop_utils.py:238-249)."""
    r, s = corr_matrix.shape
    flat = corr_matrix.reshape(-1)
    idx = np.argpartition(-flat, k - 1)[:k]
    return idx // s, idx % s
