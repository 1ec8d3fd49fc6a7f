"""KITTI odometry stage-5 configuration at its published widths.

The values of `experiments/geotransformer_kitti_stage5/config.py::make_cfg`
(upstream experiments/geotransformer.kitti.stage5.gse.k3.max.oacl.stage2.
sinkhorn/config.py:33-141), without the environment override: a 5-stage
backbone (voxel 0.3 m, radius 4.25x, f32) whose decoders stop at level 1,
capacities sized for the 0.3 m-downsampled odometry scans
(30720/10240/3072/1024/384), geometric input_dim 2048 and hidden 128,
patches of K = 128 points, fine top-k 2, RR at RRE < 5 deg and RTE < 2 m.
"""

from __future__ import annotations

from ref_geotransformer_tpu_torch.config.base import (
    BackboneConfig,
    CapacityConfig,
    CoarseLossConfig,
    CoarseMatchingConfig,
    EvalConfig,
    FineLossConfig,
    FineMatchingConfig,
    GeoTransformerConfig,
    GeoTransformerModuleConfig,
    LossWeights,
    ModelConfig,
    OptimConfig,
    RansacConfig,
    TestDataConfig,
    TrainDataConfig,
)


def make_cfg() -> GeoTransformerConfig:
    return GeoTransformerConfig(
        seed=7351,
        capacities=CapacityConfig(
            points=(30720, 10240, 3072, 1024, 384),
            neighbor_limits=(40, 38, 36, 36, 34),
            gt_candidates=2048,
            correspondence_limit=8192,
            search_chunk=2048,
        ),
        backbone=BackboneConfig(
            num_stages=5,
            init_voxel_size=0.3,
            kernel_size=15,
            base_radius=4.25,
            base_sigma=2.0,
            group_norm=32,
            input_dim=1,
            init_dim=64,
            output_dim=256,
            fine_level=1,
        ),
        model=ModelConfig(
            ground_truth_matching_radius=0.6,
            num_points_in_patch=128,
            num_sinkhorn_iterations=100,
        ),
        coarse_matching=CoarseMatchingConfig(
            num_targets=128, overlap_threshold=0.1, num_correspondences=256, dual_normalization=True
        ),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=2048,
            hidden_dim=128,
            output_dim=256,
            num_heads=4,
            blocks=("self", "cross", "self", "cross", "self", "cross"),
            sigma_d=4.8,
            sigma_a=15.0,
            angle_k=3,
            reduction_a="max",
        ),
        fine_matching=FineMatchingConfig(
            topk=2,
            acceptance_radius=0.6,
            mutual=True,
            confidence_threshold=0.05,
            use_dustbin=False,
            use_global_score=False,
            correspondence_threshold=3,
            correspondence_limit=None,
            num_refinement_steps=5,
        ),
        coarse_loss=CoarseLossConfig(
            positive_margin=0.1,
            negative_margin=1.4,
            positive_optimal=0.1,
            negative_optimal=1.4,
            log_scale=40.0,
            positive_overlap=0.1,
        ),
        fine_loss=FineLossConfig(positive_radius=0.6),
        loss=LossWeights(),
        eval=EvalConfig(
            acceptance_overlap=0.0,
            acceptance_radius=1.0,
            inlier_ratio_threshold=0.05,
            rre_threshold=5.0,
            rte_threshold=2.0,
            recall_criterion="rre_rte",
        ),
        ransac=RansacConfig(distance_threshold=0.3, num_points=4, num_iterations=50000),
        optim=OptimConfig(
            lr=1e-4, lr_decay=0.95, lr_decay_steps=4, weight_decay=1e-6, max_epoch=160, grad_acc_steps=1
        ),
        train=TrainDataConfig(
            batch_size=1,
            num_workers=8,
            point_limit=30000,
            use_augmentation=True,
            augmentation_noise=0.01,
            augmentation_rotation=1.0,
        ),
        test=TestDataConfig(batch_size=1, num_workers=8, point_limit=None),
    )
