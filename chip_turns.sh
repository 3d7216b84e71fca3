#!/usr/bin/env bash
# Runs one chip_smoke.py on two checkouts in turns, OLD NEW NEW OLD, on one
# card, so that two versions of a kernel are compared within one machine and
# power limit, measured by the same script: NEW_DIR's chip_smoke.py, copied
# into OLD_DIR as chip_smoke_turns.py so that there it imports OLD_DIR's
# package (or OLD_DIR's own script: TURNS_OLD_SCRIPT below).  Each turn's output goes to OUT_DIR/<n>_<old|new>.log; the exit
# code is the first non-zero one of the turns.  The script imports its cases
# from the tree it runs in (that tree's tests/torch_cases.py).
#
#   bash chip_turns.sh OLD_DIR NEW_DIR OUT_DIR [chip_smoke.py arguments ...]
#
# OLD_DIR is typically the parent commit unpacked with
# `git archive HEAD~ | tar -x -C build/parent` (build/ is gitignored).  Leave
# `build` out of the phases: its gates hold the new tree's kernels (the
# other phases build each library at first use).  With TURNS_OLD_SCRIPT=own
# the old turns run OLD_DIR's own chip_smoke.py instead: for a phase whose
# code calls entry points that the old tree does not have, each tree is
# then measured by its own version of the phase.
set -u
old=$(cd "$1" && pwd); new=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
shift 3
if [ "${TURNS_OLD_SCRIPT:-new}" = own ]; then
    cp "$old/chip_smoke.py" "$old/chip_smoke_turns.py"
else
    cp "$new/chip_smoke.py" "$old/chip_smoke_turns.py"
fi
rc=0
n=0
for tag in old new new old; do
    n=$((n + 1))
    script=$new/chip_smoke.py; dir=$new
    [ "$tag" = old ] && script=$old/chip_smoke_turns.py && dir=$old
    (cd "$dir" && python3 "$script" "$@") > "$out/${n}_${tag}.log" 2>&1
    r=$?
    echo "turn $n ($tag): exit $r"
    [ $rc -eq 0 ] && rc=$r
done
exit $rc
