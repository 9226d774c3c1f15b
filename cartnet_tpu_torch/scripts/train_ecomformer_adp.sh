#!/bin/bash
# eComformer on ADP (reference scripts/train_ecomformer_adp.sh).
exec "$(dirname "$0")/train_comformer_adp.sh" ecomformer "$@"
