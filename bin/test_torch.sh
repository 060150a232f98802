#!/usr/bin/env bash
# Sample from a trained job with the PyTorch port:
#   bash bin/test_torch.sh <job_dir> <result_dir> [key=value ...]
# The arguments of bin/test.sh.
set -eu
JOB_DIR=${1:?job_dir}
RESULT_DIR=${2:?result_dir}
shift 2
exec python -m layoutdm_tpu_torch.sample_cli "job_dir=$JOB_DIR" "result_dir=$RESULT_DIR" "$@"
