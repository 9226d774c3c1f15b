#!/bin/bash
# ADP CartNet, 4 seeds (reference scripts/train_cartnet_adp.sh parity:
# batch 4 x accum 16, lr 1e-3, 50 epochs, radius 5, 4 layers, dim 256,
# rbf 64, SO(3) augmentation, temperature on, envelope on, Cholesky head).
# Seeds run sequentially here (one card); use --dp for data parallelism
# over several cards.
set -e
for seed in 0 1 2 3; do
  python -m cartnet_tpu_torch.cli --dataset ADP --dataset_path "${ADP_DATASET:-./dataset/ADP_DATASET}" \
    --name CartNet --seed $seed --batch 4 --batch_accumulation 16 \
    --epochs 50 --lr 1e-3 --radius 5.0 --num_layers 4 --dim_in 256 \
    --dim_rbf 64 --augment "$@"
done
python -m cartnet_tpu_torch.aggregate --name CartNet --seeds 0 1 2 3
