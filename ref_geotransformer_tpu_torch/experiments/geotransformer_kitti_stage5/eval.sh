#!/bin/bash
# two-phase protocol (counterpart of experiments/geotransformer_kitti_stage5/eval.sh):
# dump features with test, then offline-eval with LGR
set -e
SNAPSHOT=${1:-epoch-160}
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
EXP=ref_geotransformer_tpu_torch.experiments.geotransformer_kitti_stage5
python3 -m "$EXP.test" --snapshot "$SNAPSHOT"
python3 -m "$EXP.eval" --method lgr --verbose
