#!/bin/bash
# two-phase protocol (counterpart of experiments/geotransformer_3dmatch_stage4/eval.sh):
# dump features with test, then offline-eval with LGR
set -e
SNAPSHOT=${1:-epoch-40}
BENCHMARK=${2:-3DMatch}
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
EXP=ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4
python3 -m "$EXP.test" --snapshot "$SNAPSHOT" --benchmark "$BENCHMARK"
python3 -m "$EXP.eval" --benchmark "$BENCHMARK" --method lgr --verbose
