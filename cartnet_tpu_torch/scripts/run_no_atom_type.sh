#!/bin/bash
# CartNet_no_Z ablation, 4 seeds (reference scripts/run_no_atom_type.sh).
set -e
for seed in 0 1 2 3; do
  python -m cartnet_tpu_torch.cli --dataset ADP --dataset_path "${ADP_DATASET:-./dataset/ADP_DATASET}" \
    --name CartNet_no_Z --seed $seed --batch 4 --batch_accumulation 16 \
    --epochs 50 --lr 1e-3 --augment --disable_atom_types "$@"
done
python -m cartnet_tpu_torch.aggregate --name CartNet_no_Z --seeds 0 1 2 3
