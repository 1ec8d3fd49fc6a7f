"""Dataloaders of the ModelNet/LineMod experiment.

Counterpart of `experiments/geotransformer_modelnet_rpmnet_stage4/dataset.py`
(ref parity: experiments/geotransformer.modelnet.../dataset.py:11-39): the
fork routes this experiment to LMODataset; the ModelNet pairs stay
available with use_modelnet=True. LineMod validates on its test frames,
ModelNet on its val split. One process reads the whole dataset: the loaders
are not sharded.
"""

from ref_geotransformer_tpu_torch.data import PairLoader
from ref_geotransformer_tpu_torch.data.datasets.linemod import LMODataset
from ref_geotransformer_tpu_torch.data.datasets.modelnet import ModelNetPairDataset
from ref_geotransformer_tpu_torch.experiments.geotransformer_modelnet_rpmnet_stage4 import config


def _linemod(cfg, mode):
    lmo = config.LMO
    return LMODataset(
        lmo["data_folder"],
        reload_data=lmo["reload_data"],
        data_augmentation=lmo["data_augmentation"] and mode == "train",
        rotated=lmo["rotated"],
        rot_factor=lmo["rot_factor"],
        augment_noise=lmo["augment_noise"],
        points_limit=lmo["points_limit"],
        mode=mode,
        overfit=lmo["overfit"],
        seed=cfg.seed,
    )


def _modelnet(cfg, subset):
    knobs = config.MODELNET
    return ModelNetPairDataset(
        config.MODELNET_ROOT,
        subset,
        num_points=knobs["num_points"],
        rotation_magnitude=knobs["rotation_magnitude"],
        translation_magnitude=knobs["translation_magnitude"],
        noise_magnitude=knobs["noise_magnitude"] if subset == "train" else None,
        keep_ratio=knobs["keep_ratio"],
        crop_method=knobs["crop_method"],
        asymmetric=knobs["asymmetric"],
        class_indices=knobs["class_indices"],
        deterministic=subset != "train",
        twice_sample=knobs["twice_sample"],
        twice_transform=knobs["twice_transform"],
        seed=cfg.seed,
    )


def train_valid_data_loader(cfg, batch_size=None, use_modelnet=False):
    make = _modelnet if use_modelnet else _linemod
    train_dataset = make(cfg, "train")
    valid_dataset = make(cfg, "val" if use_modelnet else "test")
    train_loader = PairLoader(
        train_dataset,
        cfg,
        batch_size=batch_size or cfg.train.batch_size,
        shuffle=True,
        drop_last=True,
        seed=cfg.seed,
    )
    valid_loader = PairLoader(valid_dataset, cfg, batch_size=batch_size or cfg.train.batch_size)
    return train_loader, valid_loader


def test_data_loader(cfg, use_modelnet=False):
    make = _modelnet if use_modelnet else _linemod
    return PairLoader(make(cfg, "test"), cfg, batch_size=1)
