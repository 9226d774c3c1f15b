#!/bin/bash
# Materials Project (megnet) CartNet (reference scripts/train_cartnet_megnet.sh).
# Targets contain SPACES ("gap pbe", "bulk modulus", "shear modulus") so they
# are iterated as a bash array, never word-split. bulk/shear load the
# pre-split pickles (place {bulk,shear}_megnet_{train,val,test}.pkl under the
# dataset path; figshare.com/projects/Bulk_and_shear_datasets/165430).
set -e
TARGETS=("e_form" "gap pbe" "bulk modulus" "shear modulus")
for target in "${TARGETS[@]}"; do
  tname=${target// /_}
  for seed in 1 2 3 4; do
    python -m cartnet_tpu_torch.cli --dataset megnet --figshare_target "$target" \
      --name "CartNet_megnet_${tname}" --seed $seed --batch 64 \
      --batch_accumulation 1 --epochs 500 --lr 1e-3 "$@"
  done
  python -m cartnet_tpu_torch.aggregate --name "CartNet_megnet_${tname}" --seeds 1 2 3 4
done
