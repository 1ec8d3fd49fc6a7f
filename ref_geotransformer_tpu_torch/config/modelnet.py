"""ModelNet rpmnet stage-4 configuration (trained on LineMod) at its published widths.

The values of `experiments/geotransformer_modelnet_rpmnet_stage4/config.py::
make_cfg` (upstream experiments/geotransformer.modelnet.rpmnet.stage4.gse.k3.
max.oacl.stage2.sinkhorn/config.py:33-173), without the environment
overrides: a 3-stage backbone whose decoders stop at level 0, voxel 0.003 m
(LineMod meters), geometric input_dim 512, 64 coarse targets and
correspondences, patches of K = 128 points, AdamW under a warmup-cosine
schedule over 100k iterations.
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
    """The published values; the learning rate and the warmup are the
    reference's (1e-4, 10000 iterations)."""
    return GeoTransformerConfig(
        seed=7351,
        capacities=CapacityConfig(
            # LineMod clouds capped at 1000 raw pts; level1 voxel 0.006 m,
            # level2 voxel 0.012 m on ~10 cm objects
            points=(1024, 640, 256),
            neighbor_limits=(32, 32, 32),
            gt_candidates=1024,
            correspondence_limit=4096,
            search_chunk=512,
        ),
        backbone=BackboneConfig(
            num_stages=3,
            init_voxel_size=0.003,
            kernel_size=15,
            base_radius=3.0,
            base_sigma=2.0,
            group_norm=32,
            input_dim=1,
            init_dim=64,
            output_dim=256,
            fine_level=0,
        ),
        model=ModelConfig(
            ground_truth_matching_radius=0.005,
            num_points_in_patch=128,
            num_sinkhorn_iterations=100,
        ),
        coarse_matching=CoarseMatchingConfig(
            num_targets=64, overlap_threshold=0.1, num_correspondences=64, dual_normalization=True
        ),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=512,
            hidden_dim=256,
            output_dim=256,
            num_heads=4,
            blocks=("self", "cross", "self", "cross", "self", "cross"),
            sigma_d=0.2,
            sigma_a=15.0,
            angle_k=3,
            reduction_a="max",
        ),
        fine_matching=FineMatchingConfig(
            topk=3,
            acceptance_radius=0.1,
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
            log_scale=24.0,
            positive_overlap=0.1,
        ),
        fine_loss=FineLossConfig(positive_radius=0.05),
        loss=LossWeights(),
        eval=EvalConfig(
            acceptance_overlap=0.0,
            acceptance_radius=0.01,
            inlier_ratio_threshold=0.05,
            rre_threshold=1.0,
            rte_threshold=0.1,
            recall_criterion="rre_rte",
        ),
        ransac=RansacConfig(distance_threshold=0.05, num_points=3, num_iterations=1000),
        optim=OptimConfig(
            lr=1e-4,
            weight_decay=1e-6,
            grad_acc_steps=1,
            max_iteration=100000,
            snapshot_steps=2000,
            warmup_steps=10000,
            eta_init=0.1,
            eta_min=0.1,
        ),
        train=TrainDataConfig(batch_size=1, num_workers=8, point_limit=1000),
        test=TestDataConfig(batch_size=1, num_workers=8, point_limit=1000),
    )
