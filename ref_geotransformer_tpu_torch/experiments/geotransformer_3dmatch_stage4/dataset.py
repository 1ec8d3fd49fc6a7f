"""The train, validation and test loaders of the 3DMatch experiment.

Counterpart of `experiments/geotransformer_3dmatch_stage4/dataset.py` (ref
parity: experiments/geotransformer.3dmatch.../dataset.py:9-57): loaders ship
padded raw clouds; the pyramid is built on the device by the steps, with
the neighbor limits frozen in config.
"""

from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets import ThreeDMatchPairDataset
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import config


def train_valid_data_loader(cfg, batch_size=None):
    train_dataset = ThreeDMatchPairDataset(
        config.DATASET_ROOT,
        "train",
        point_limit=cfg.train.point_limit,
        use_augmentation=cfg.train.use_augmentation,
        augmentation_noise=cfg.train.augmentation_noise,
        augmentation_rotation=cfg.train.augmentation_rotation,
        seed=cfg.seed,
    )
    train_loader = PairLoader(
        train_dataset,
        cfg,
        batch_size=batch_size or cfg.train.batch_size,
        shuffle=True,
        drop_last=True,
        seed=cfg.seed,
    )
    valid_dataset = ThreeDMatchPairDataset(
        config.DATASET_ROOT,
        "val",
        point_limit=cfg.test.point_limit,
        use_augmentation=False,
        seed=cfg.seed,
    )
    valid_loader = PairLoader(valid_dataset, cfg, batch_size=batch_size or cfg.train.batch_size)
    return train_loader, valid_loader


def test_data_loader(cfg, benchmark: str, rotated: bool = False):
    test_dataset = ThreeDMatchPairDataset(
        config.DATASET_ROOT,
        benchmark,
        point_limit=cfg.test.point_limit,
        use_augmentation=False,
        rotated=rotated,
    )
    return PairLoader(test_dataset, cfg, batch_size=1)
