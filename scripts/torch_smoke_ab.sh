#!/bin/bash
# Run chip_smoke.py from two unpacked trees of the repo in turns (A, B, B,
# A) on one card, so the two versions' main_path lines come from one
# machine.  Each run's whole output goes to OUT/smoke_<n>_<name>.log; the
# card, main_path and result lines are echoed.
#
#   git archive <commit> | tar -x -C build/a     (and the other into build/b)
#   bash scripts/torch_smoke_ab.sh build/a build/b build/smoke_ab
set -u
a=$1
b=$2
out=${3:-build/smoke_ab}
mkdir -p "$out"
out=$(cd "$out" && pwd)
i=0
for d in "$a" "$b" "$b" "$a"; do
  i=$((i + 1))
  name=$(basename "$d")
  log="$out/smoke_${i}_${name}.log"
  (cd "$d" && timeout 700 python3 chip_smoke.py > "$log" 2>&1)
  echo "run $i $name rc=$?"
  grep -E '^(main_path|NVIDIA)|"ok"' "$log" | cut -c1-2000
done
