#!/usr/bin/env bash
# The quality run of the port: configs/synthetic256_long.yaml trained by the
# training entry point, then its newest checkpoint evaluated by the
# evaluation entry point on the 20 held-out scenes. From the repo root:
#
#     bash lara_tpu_torch/tools/quality_run.sh OUT
#
# Training runs under `timeout -s TERM 3300`, so that training and evaluate
# fit in one hour. On SIGTERM the trainer checkpoints after the micro-step
# it is in and returns; rerunning in the same logger.dir resumes at the
# saved epoch + 1. The store
# dataset/synthetic256L is written on first use. OUT receives the card's name
# and power limit (card.txt), the device memory in use every 5 s
# (memory.csv, MiB), each command's start, end and exit code (times.txt),
# train.log, eval.log, the run's scalars.jsonl and the evaluate metrics
# (synthetic.json). `python -m lara_tpu_torch.tools.quality_report OUT` reads
# them beside the JAX record. The exit code is evaluate's.
set -u
OUT=$1
STORE=dataset/synthetic256L
LOG=logs/LaRa/synthetic-256-long
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
nvidia-smi --query-gpu=memory.used --format=csv,noheader,nounits -l 5 > "$OUT/memory.csv" &
SMI=$!
trap 'kill $SMI 2>/dev/null' EXIT

t0=$(date +%s.%N)
timeout -s TERM 3300 python -m lara_tpu_torch.train configs/synthetic256_long.yaml \
    "train_dataset.data_root=$STORE" "test_dataset.data_root=$STORE" > "$OUT/train.log" 2>&1
rc=$?
echo "train $t0 $(date +%s.%N) $rc" > "$OUT/times.txt"
cp "$LOG/scalars.jsonl" "$OUT/"

t0=$(date +%s.%N)
python -m lara_tpu_torch.evaluate configs/synthetic256_long.yaml \
    infer_dataset.dataset_name=synthetic "infer_dataset.data_root=$STORE" \
    infer_dataset.split=test "infer_dataset.img_size=[256,256]" infer_dataset.n_scenes=200 \
    "infer.ckpt_path=$LOG/ckpts" "infer.save_folder=$LOG/eval" "infer.metric_path=$OUT" \
    > "$OUT/eval.log" 2>&1
rc=$?
echo "evaluate $t0 $(date +%s.%N) $rc" >> "$OUT/times.txt"
exit $rc
