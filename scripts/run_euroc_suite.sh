#!/bin/bash
# Sequential EuRoC GT-replay suite (the reference's dataset-run validation
# across all 11 sequences, evaluation/Ground_truth/EuRoC_left_cam/*).
# Usage: [JAX_PLATFORMS=cpu] run_euroc_suite.sh <sensor> <out.jsonl> [seq...]
set -u
SENSOR="${1:-imu-stereo}"
OUT="${2:-/tmp/euroc_suite.jsonl}"
shift 2 2>/dev/null || shift $#
SEQS=("$@")
[ ${#SEQS[@]} -eq 0 ] && SEQS=(MH02 MH03 MH04 MH05 V101 V102 V103 V201 V202 V203)
cd "$(dirname "$0")/.."
# XLA:CPU JIT mmaps one code section per compiled program; a long replay
# compiles enough shape buckets to exhaust the default vm.max_map_count
# (65530) and die with "LLVM ERROR: Unable to allocate section memory"
sysctl -w vm.max_map_count=1048576 >/dev/null 2>&1 || true
for SEQ in "${SEQS[@]}"; do
  echo "=== $SEQ $SENSOR ===" >&2
  timeout 10800 python scripts/run_gt_replay.py \
    --seq "$SEQ" --sensor "$SENSOR" --render features \
    >> "$OUT" 2> "/tmp/replay_${SEQ}_${SENSOR}.log"
  echo "rc=$? $SEQ done" >&2
done
