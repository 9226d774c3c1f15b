#!/bin/bash
# Jarvis-DFT CartNet (reference scripts/train_cartnet_jarvis.sh parity:
# batch 64, no accumulation, lr 1e-3, 500 epochs, seeds 1-4, scalar head).
set -e
TARGETS=${TARGETS:-"formation_energy_peratom optb88vdw_bandgap optb88vdw_total_energy mbj_bandgap ehull"}
for target in $TARGETS; do
  for seed in 1 2 3 4; do
    python -m cartnet_tpu_torch.cli --dataset jarvis --figshare_target "$target" \
      --name "CartNet_jarvis_${target}" --seed $seed --batch 64 \
      --batch_accumulation 1 --epochs 500 --lr 1e-3 "$@"
  done
  python -m cartnet_tpu_torch.aggregate --name "CartNet_jarvis_${target}" --seeds 1 2 3 4
done
