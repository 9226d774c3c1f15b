#!/bin/bash
# iComformer on ADP (reference scripts/train_icomformer_adp.sh).
exec "$(dirname "$0")/train_comformer_adp.sh" icomformer "$@"
