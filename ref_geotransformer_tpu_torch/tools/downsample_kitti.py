"""KITTI odometry preprocessing: voxel-downsample raw .bin scans to the
0.3 m .npy clouds that the dataset reader consumes.

    python -m ref_geotransformer_tpu_torch.tools.downsample_kitti --input_root data/Kitti/sequences \
        --output_root data/Kitti/downsampled [--voxel_size 0.3] [--sequences 00 01 ...]

Counterpart of `tools/downsample_kitti.py`: each `<input_root>/<seq>/velodyne/
<frame>.bin` (float32 x, y, z, intensity) becomes `<output_root>/<seq>/
<frame>.npy`, the float32 voxel centroids of its points from the host C++
kernel (`native.grid_subsample_native`), the layout `data/datasets/kitti.py`
reads.
"""

import argparse
import os
import os.path as osp

import numpy as np

from ref_geotransformer_tpu_torch.native import grid_subsample_native


def read_kitti_bin(path: str) -> np.ndarray:
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan[:, :3]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_root", required=True, help="KITTI sequences dir (XX/velodyne/*.bin)")
    parser.add_argument("--output_root", required=True)
    parser.add_argument("--voxel_size", type=float, default=0.3)
    parser.add_argument("--sequences", nargs="*", default=None, help="default: all found")
    args = parser.parse_args(argv)

    sequences = args.sequences or sorted(
        d for d in os.listdir(args.input_root) if osp.isdir(osp.join(args.input_root, d))
    )
    for seq in sequences:
        vel_dir = osp.join(args.input_root, seq, "velodyne")
        if not osp.isdir(vel_dir):
            continue
        out_dir = osp.join(args.output_root, seq)
        os.makedirs(out_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(vel_dir) if f.endswith(".bin"))
        for fname in files:
            points = read_kitti_bin(osp.join(vel_dir, fname))
            down, _ = grid_subsample_native(points, args.voxel_size)
            np.save(osp.join(out_dir, fname.replace(".bin", ".npy")), down.astype(np.float32))
        print(f"seq {seq}: {len(files)} scans -> {out_dir}")


if __name__ == "__main__":
    main()
