#!/usr/bin/env bash
# Train a model with the PyTorch port:
#   bash bin/train_torch.sh <dataset> <experiment> [key=value ...]
# The arguments of bin/train.sh.  With training.num_devices=N (N > 1) the
# trainer runs data-parallel over N processes, one a GPU, under torchrun.
set -eu
DATASET=${1:?dataset (rico25|publaynet|synthetic)}
EXPERIMENT=${2:?experiment (layoutdm|maskgit|blt|bart|autoreg|ruite|vqdiffusion)}
shift 2
N=1
for arg in "$@"; do
  case "$arg" in
    training.num_devices=*) N=${arg#training.num_devices=} ;;
  esac
done
if [ "$N" -gt 1 ]; then
  exec torchrun --standalone --nproc_per_node="$N" -m layoutdm_tpu_torch.train.loop \
    "$EXPERIMENT" "$DATASET" "$@"
fi
exec python -m layoutdm_tpu_torch.train.loop "$EXPERIMENT" "$DATASET" "$@"
