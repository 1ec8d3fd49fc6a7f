"""Experiments of the port, one package each, run as
`python -m ref_geotransformer_tpu_torch.experiments.<experiment>.<script>`."""
