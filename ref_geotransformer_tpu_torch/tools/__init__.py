"""Command-line tools of the port: KITTI preprocessing and the overfit probe
(counterparts of the JAX repository's `tools/downsample_kitti.py` and
`tools/overfit_probe.py`)."""
