"""The train, validation and test loaders of the KITTI experiment.

Counterpart of `experiments/geotransformer_kitti_stage5/dataset.py` (ref
parity: experiments/geotransformer.kitti.../dataset.py): loaders ship padded
raw clouds; the pyramid is built on the device by the steps, with the
neighbor limits frozen in config.
"""

from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets.kitti import OdometryKittiPairDataset
from ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5 import config


def train_valid_data_loader(cfg, batch_size=None):
    train_dataset = OdometryKittiPairDataset(
        config.DATASET_ROOT,
        "train",
        point_limit=cfg.train.point_limit,
        use_augmentation=cfg.train.use_augmentation,
        augmentation_noise=cfg.train.augmentation_noise,
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
    valid_dataset = OdometryKittiPairDataset(
        config.DATASET_ROOT, "val", point_limit=cfg.test.point_limit, use_augmentation=False, seed=cfg.seed
    )
    valid_loader = PairLoader(valid_dataset, cfg, batch_size=batch_size or cfg.train.batch_size)
    return train_loader, valid_loader


def test_data_loader(cfg):
    test_dataset = OdometryKittiPairDataset(
        config.DATASET_ROOT, "test", point_limit=cfg.test.point_limit, use_augmentation=False
    )
    return PairLoader(test_dataset, cfg, batch_size=1)
