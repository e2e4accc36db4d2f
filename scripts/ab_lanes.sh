#!/bin/bash
# Interactive GET latency of two checkouts in turns on one card: chip_smoke.py's
# main and lanes phases (config 3 behind the daemon's batcher over HTTP) of
# PARENT_DIR and of this checkout, in the order parent, change, change,
# parent, each log under LOG_DIR/ab_lanes_<n>_<tree>.log; prints each
# run's exit line and its lanes (a) GET p50/p99. Needs one H100 and about
# 1500 seconds.
#
#   git archive <parent> | tar -x -C build/parent
#   bash scripts/ab_lanes.sh build/parent [LOG_DIR]   # LOG_DIR: build/ab_lanes
set -u
parent=$(cd "${1:-build/parent}" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
logs=${2:-$here/build/ab_lanes}
mkdir -p "$logs"
logs=$(cd "$logs" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for t in parent change change parent; do
  i=$((i + 1))
  if [ "$t" = parent ]; then d=$parent; else d=$here; fi
  out="$logs/ab_lanes_${i}_$t.log"
  (cd "$d" && timeout 420 python3 chip_smoke.py --only build,main,lanes > "$out" 2>&1
   echo "rc $?" >> "$out")
  echo "== $i $t $(tail -1 "$out")"
  grep -o '"p50_ms": [0-9.]*, "p99_ms": [0-9.]*' "$out" | head -1
done
