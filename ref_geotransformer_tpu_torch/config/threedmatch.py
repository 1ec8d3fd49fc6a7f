"""3DMatch stage-4 configuration at its published widths.

The values of `experiments/geotransformer_3dmatch_stage4/config.py::make_cfg`
(upstream experiments/geotransformer.3dmatch.stage4.gse.k3.max.oacl.stage2.
sinkhorn/config.py), without the environment overrides.
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
)


def make_cfg(demo: bool = False) -> GeoTransformerConfig:
    """demo=True: capacities sized to the demo pair's pyramid
    (20480/6144/2048/512 points); otherwise the full 3DMatch capacities
    (30720/10240/3072/1024)."""
    capacities = CapacityConfig(
        points=(20480, 6144, 2048, 512) if demo else (30720, 10240, 3072, 1024),
        neighbor_limits=(38, 36, 36, 38),
        gt_candidates=2048 if demo else 4096,
        correspondence_limit=8192,
        search_chunk=2048,
    )
    return GeoTransformerConfig(
        seed=7351,
        capacities=capacities,
        backbone=BackboneConfig(
            num_stages=4,
            init_voxel_size=0.025,
            kernel_size=15,
            base_radius=2.5,
            base_sigma=2.0,
            group_norm=32,
            input_dim=1,
            init_dim=64,
            output_dim=256,
            fine_level=1,
            dtype="bfloat16",
        ),
        model=ModelConfig(
            ground_truth_matching_radius=0.05,
            num_points_in_patch=64,
            num_sinkhorn_iterations=100,
        ),
        coarse_matching=CoarseMatchingConfig(
            num_targets=128,
            overlap_threshold=0.1,
            num_correspondences=256,
            dual_normalization=True,
        ),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=1024,
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
        loss=LossWeights(weight_coarse_loss=1.0, weight_fine_loss=1.0),
        eval=EvalConfig(
            acceptance_overlap=0.0,
            acceptance_radius=0.1,
            inlier_ratio_threshold=0.05,
            rmse_threshold=0.2,
            rre_threshold=15.0,
            rte_threshold=0.3,
        ),
        optim=OptimConfig(lr=1e-4, lr_decay=0.95, lr_decay_steps=1, weight_decay=1e-6, max_epoch=40,
                          grad_acc_steps=1),
    )
