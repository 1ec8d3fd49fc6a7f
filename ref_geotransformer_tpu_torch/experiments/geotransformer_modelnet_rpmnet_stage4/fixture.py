"""Synthetic LineMod (BOP) and ModelNet trees for fixture runs of the experiment.

`make_linemod_tree(base, ...)` writes a BOP tree under `base` (point
REF_GT_LINEMOD_ROOT at the folder that holds it, `base` being
`<root>/linemod`): one box object's mesh, and train and test frames of
16-bit depth and 8-bit `mask_visib` PNGs rendering the box's z = 0 face at
varied translations, with `scene_gt.json` and `scene_camera.json`. It is
`tools/train_linemod_twophase.py::make_synthetic_linemod_tree` (the same
random draws and the same images), written without PIL: the PNGs go through
`data/datasets/png.py`.

`make_modelnet_tree(root, ...)` writes `{train,val,test}.pkl`, each a list
of {"points", "normals", "label"} of a few synthetic surfaces whose labels
are asymmetric ModelNet40 classes (point REF_GT_MODELNET_ROOT at `root`);
the generator of `tests/test_dataset_fixtures.py::modelnet_root`.
"""

import json
import os
import os.path as osp
import pickle
import shutil

import numpy as np

from ref_geotransformer_tpu_torch.data.datasets.png import write_png

# box mesh in mm (LineMod objects are ~5-15 cm)
BOX_VERTICES_MM = np.array([[x, y, z] for x in (0, 60) for y in (0, 80) for z in (0, 100)], np.float64)
BOX_FACES = np.array(
    [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
    np.int64,
)


def _write_ply(path, vertices, faces):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\nproperty list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def make_linemod_tree(base: str, n_train: int = 12, n_test: int = 4) -> None:
    """A BOP-format LineMod tree of one box object (BOP layout per reference
    datasets/registration/linemod/linemod.py:66-132)."""
    if osp.exists(base):
        shutil.rmtree(base)
    os.makedirs(osp.join(base, "models"))
    _write_ply(osp.join(base, "models", "obj_000001.ply"), BOX_VERTICES_MM, BOX_FACES)

    h, w = 120, 160
    fx = fy = 500.0
    cx, cy = 80.0, 60.0
    rng = np.random.default_rng(0)

    for mode, n_frames in (("train", n_train), ("test", n_test)):
        frame_dir = osp.join(base, mode, "000001")
        os.makedirs(osp.join(frame_dir, "depth"))
        os.makedirs(osp.join(frame_dir, "mask_visib"))
        cams, gts = {}, {}
        for fid in range(n_frames):
            # identity rotation, varied translation; augmentation supplies
            # rotation diversity at load time (linemod.py __getitem__)
            tx = float(rng.uniform(-0.03, 0.01))
            ty = float(rng.uniform(-0.03, 0.01))
            tz = float(rng.uniform(0.6, 0.9))
            # the z=0 face (x in [0,60]mm, y in [0,80]mm) projects to a rect
            u0 = max(int(np.ceil(fx * tx / tz + cx)) + 1, 0)
            u1 = min(int(np.floor(fx * (tx + 0.060) / tz + cx)) - 1, w)
            v0 = max(int(np.ceil(fy * ty / tz + cy)) + 1, 0)
            v1 = min(int(np.floor(fy * (ty + 0.080) / tz + cy)) - 1, h)
            depth = np.zeros((h, w), np.uint16)
            mask = np.zeros((h, w), np.uint8)
            # mild surface relief so the cloud is not a perfect plane
            vv, uu = np.mgrid[v0:v1, u0:u1]
            relief = (2.0 * np.sin(uu / 7.0) * np.cos(vv / 9.0)).astype(np.int32)
            depth[v0:v1, u0:u1] = np.uint16(round(tz * 1000)) + relief.astype(np.uint16)
            mask[v0:v1, u0:u1] = 255
            write_png(osp.join(frame_dir, "depth", f"{fid:06d}.png"), depth)
            write_png(osp.join(frame_dir, "mask_visib", f"{fid:06d}_000000.png"), mask)
            cams[str(fid)] = {"cam_K": [fx, 0.0, cx, 0.0, fy, cy, 0.0, 0.0, 1.0], "depth_scale": 1.0}
            gts[str(fid)] = [{
                "cam_R_m2c": np.eye(3).flatten().tolist(),
                "cam_t_m2c": [tx * 1000, ty * 1000, tz * 1000],
                "obj_id": 1,
            }]
        with open(osp.join(frame_dir, "scene_camera.json"), "w") as f:
            json.dump(cams, f)
        with open(osp.join(frame_dir, "scene_gt.json"), "w") as f:
            json.dump(gts, f)


def make_modelnet_tree(root: str, labels=(0, 2, 4), points: int = 2048) -> None:
    """`{train,val,test}.pkl`, the same list in each: one synthetic surface
    with random unit normals per label (labels among the asymmetric classes)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(2)
    data_list = []
    for label in labels:
        pts = rng.uniform(-1, 1, (points, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(3 * pts[:, 0]) + 0.2 * pts[:, 1]
        normals = rng.normal(size=(points, 3)).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        data_list.append({"points": pts, "normals": normals, "label": label})
    for subset in ("train", "val", "test"):
        with open(osp.join(root, f"{subset}.pkl"), "wb") as f:
            pickle.dump(data_list, f)
