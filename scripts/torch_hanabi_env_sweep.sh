#!/bin/bash
# Fixed-experience Hanabi training sweep over env counts through the port
# (counterpart of scripts/hanabi_env_sweep.sh; reference:
# scripts/hanabi_env_train.sh): one env-step budget trained at several batch
# sizes by centralized self-play (torch_hanabi_train.py --single), each env
# step one launch of the Hanabi step kernel (K3) on the card.  Arguments are
# passed on; a later flag overrides these, e.g.
#   bash scripts/torch_hanabi_env_sweep.sh --total-timesteps 65536
#   bash scripts/torch_hanabi_env_sweep.sh --device cpu --config very_small --total-timesteps 1024
set -e
cd "$(dirname "$0")"

for i in 256 1024 512; do
    python3 torch_hanabi_train.py --num-envs "$i" --num-steps 64 \
        --total-timesteps 275000000 --lr 1e-3 --single "$@"
done
