#!/bin/bash
# e/iComformer on ADP (reference scripts/train_{e,i}comformer_adp.sh:
# max_neighbours 25, no augmentation; iComformer lattice-optimized cells).
set -e
MODEL=${1:-icomformer}; shift || true
for seed in 0 1 2 3; do
  python -m cartnet_tpu_torch.cli --dataset ADP --dataset_path "${ADP_DATASET:-./dataset/ADP_DATASET}" \
    --model "$MODEL" --name "$MODEL" --seed $seed --batch 4 \
    --batch_accumulation 16 --epochs 50 --lr 1e-3 --max_neighbours 25 "$@"
done
python -m cartnet_tpu_torch.aggregate --name "$MODEL" --seeds 0 1 2 3
