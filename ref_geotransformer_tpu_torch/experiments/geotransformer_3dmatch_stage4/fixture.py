"""A synthetic 3DMatch tree for fixture runs of the CLI chain.

`make_fixture_tree(root, ...)` writes torch-saved fragments, the metadata
pickles and a "val" benchmark (gt.log, gt.info) in the reference's on-disk
layout; point REF_GT_3DMATCH_ROOT at `root` to train, test and evaluate on
it. A copy of `tools/train_3dmatch_fixture.py::make_fixture_tree` (the same
random draws, so both packages get the same tree from the same arguments):
the tool imports the JAX package, which the port does not.
"""

import os
import os.path as osp
import pickle
import shutil

import numpy as np
import torch

from ref_geotransformer_tpu_torch.data.benchmark_3dmatch import write_log_file


def _surface(rng, n):
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    pts[:, 2] = (0.3 * np.sin(2.2 * pts[:, 0]) + 0.25 * np.cos(1.7 * pts[:, 1])
                 + 0.15 * pts[:, 0] * pts[:, 1])
    return pts


def _transform(rng):
    from scipy.spatial.transform import Rotation

    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = Rotation.from_euler("xyz", rng.uniform(-30, 30, 3), degrees=True).as_matrix()
    t[:3, 3] = rng.uniform(-0.3, 0.3, 3)
    return t


def make_fixture_tree(root, n_train=4, n_val=2, points=2400, val_from_train=False,
                      real_base=None):
    """torch-saved .pth fragments + metadata pkls + val benchmark gt files
    (the reference's on-disk layout, threedmatch/dataset.py:52-66).

    real_base: optional list of .npy cloud paths — fragments become random
    subsets of REAL scans instead of synthetic height-field surfaces.
    Smooth synthetic surfaces are geometrically self-similar, which starves
    the coarse matching supervision; real indoor geometry overfits much
    faster (the regime OVERFIT_PROBE_r03.json proved)."""
    scene = "7-scenes-fixture"
    rng = np.random.default_rng(5)
    if osp.isdir(root):
        shutil.rmtree(root)
    os.makedirs(osp.join(root, "metadata"))
    bases = [np.load(p).astype(np.float32) for p in real_base] if real_base else None

    def build_split(split, pairs):
        os.makedirs(osp.join(root, "data", split, scene), exist_ok=True)
        metadata = []
        for pair_i, (frag0, frag1) in enumerate(pairs):
            gt = _transform(rng)
            if bases is not None:
                base = bases[pair_i % len(bases)]
            else:
                base = _surface(rng, int(points * 1.3))
            ref = base[rng.permutation(len(base))[:points]]
            src_sel = base[rng.permutation(len(base))[:points]]
            src = (src_sel - gt[:3, 3]) @ gt[:3, :3]
            ref = ref + rng.normal(0, 0.004, ref.shape).astype(np.float32)
            src = (src + rng.normal(0, 0.004, src.shape)).astype(np.float32)
            pcd0 = f"{split}/{scene}/cloud_bin_{frag0}.pth"
            pcd1 = f"{split}/{scene}/cloud_bin_{frag1}.pth"
            torch.save(torch.from_numpy(ref.astype(np.float32)), osp.join(root, "data", pcd0))
            torch.save(torch.from_numpy(src), osp.join(root, "data", pcd1))
            metadata.append({
                "scene_name": scene, "frag_id0": frag0, "frag_id1": frag1,
                "overlap": 0.75, "rotation": gt[:3, :3], "translation": gt[:3, 3],
                "pcd0": pcd0, "pcd1": pcd1,
            })
        with open(osp.join(root, "metadata", f"{split}.pkl"), "wb") as f:
            pickle.dump(metadata, f)
        return metadata

    # train pairs (2i, 2i+1) keep every fragment id unique; val reuses ids in
    # a disjoint split dir so frame naming stays benchmark-compatible
    train_meta = build_split("train", [(2 * i, 2 * i + 1) for i in range(n_train)])
    if val_from_train:
        # overfit-probe mode: the val/benchmark pairs ARE the train pairs
        # (the reference's own correctness-probe pattern, modelnet
        # dataset.py:64,92-98) — copy fragments into the val split dir.
        # Remap fragment ids to (3i, 3i+2): the benchmark RR protocol only
        # scores NON-consecutive pairs (reference threedmatch/utils.py
        # evaluate_registration_one_scene; benchmark_3dmatch.py:162), so
        # gap-1 ids would leave RR with an empty denominator.
        os.makedirs(osp.join(root, "data", "val", scene), exist_ok=True)
        val_meta = []
        for i, m in enumerate(train_meta[:n_val]):
            vm = dict(m)
            vm["frag_id0"], vm["frag_id1"] = 3 * i, 3 * i + 2
            for key, fid in (("pcd0", vm["frag_id0"]), ("pcd1", vm["frag_id1"])):
                dst = f"val/{scene}/cloud_bin_{fid}.pth"
                shutil.copyfile(osp.join(root, "data", m[key]), osp.join(root, "data", dst))
                vm[key] = dst
            val_meta.append(vm)
        with open(osp.join(root, "metadata", "val.pkl"), "wb") as f:
            pickle.dump(val_meta, f)
    else:
        val_meta = build_split("val", [(0, 3), (1, 5)][:n_val])

    # "val" doubles as a benchmark: gt.log + covariance gt.info
    bench_dir = osp.join(root, "metadata", "benchmarks", "val", scene)
    os.makedirs(bench_dir)
    gt_pairs = []
    info_lines = []
    num_fragments = 10
    for m in val_meta:
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = m["rotation"]
        t[:3, 3] = m["translation"]
        gt_pairs.append({"test_pair": [m["frag_id0"], m["frag_id1"]],
                         "num_fragments": num_fragments, "transform": t})
        info_lines.append((m["frag_id0"], m["frag_id1"]))
    write_log_file(osp.join(bench_dir, "gt.log"), gt_pairs)
    cov = np.eye(6, dtype=np.float32)
    with open(osp.join(bench_dir, "gt.info"), "w") as f:
        for a, b in info_lines:
            f.write(f"{a}\t{b}\t{num_fragments}\n")
            for row in cov:
                f.write("\t".join(str(x) for x in row) + "\n")
