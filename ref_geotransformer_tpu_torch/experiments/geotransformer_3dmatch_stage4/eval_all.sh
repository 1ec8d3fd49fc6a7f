#!/bin/bash
# epoch sweep (counterpart of experiments/geotransformer_3dmatch_stage4/eval_all.sh: epochs 20-40)
set -e
BENCHMARK=${1:-3DMatch}
ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
EXP=ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4
for epoch in $(seq 20 40); do
  echo "=== epoch-$epoch ==="
  python3 -m "$EXP.test" --snapshot "epoch-$epoch" --benchmark "$BENCHMARK"
  python3 -m "$EXP.eval" --benchmark "$BENCHMARK" --method lgr
done
