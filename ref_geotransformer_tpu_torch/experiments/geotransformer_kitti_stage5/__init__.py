"""KITTI odometry stage 5: `trainval`, `test` and `eval` (the counterparts of
`experiments/geotransformer_kitti_stage5/{trainval,test,eval}.py`), with
`config`, `dataset` and the synthetic `fixture` tree."""
