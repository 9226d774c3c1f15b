#!/bin/bash
# Ablation matrix (reference scripts/run_ablations.sh):
# invariant / no_temp / no_aug / no_env / no_H / no_Z / nothing.
set -e
BASE="python -m cartnet_tpu_torch.cli --dataset ADP --batch 4 --batch_accumulation 16 --epochs 50"
declare -A ABL=(
  [invariant]="--augment --invariant"
  [no_temp]="--augment --disable_temp"
  [no_aug]=""
  [no_env]="--augment --disable_envelope"
  [no_H]="--augment --disable_H"
  [no_Z]="--augment --disable_atom_types"
  [nothing]="--disable_temp --disable_envelope --disable_H --disable_atom_types"
)
for name in "${!ABL[@]}"; do
  for seed in 0 1 2 3; do
    $BASE --name "ablation_${name}" --seed $seed ${ABL[$name]} "$@"
  done
  python -m cartnet_tpu_torch.aggregate --name "ablation_${name}" --seeds 0 1 2 3
done
