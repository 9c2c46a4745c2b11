"""Two trees of the repository against each other on one card: the ladder
rung (config 4, GPT-2 125M) from each, in turns.

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.ab_ladder --base build/parent \
        [--rounds 3] [--trace] [-- LADDER ARGUMENTS]

``--base`` is another checkout of the repository (for instance the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists); the other tree is the one this module lives in. Each run is a fresh
process of ``benchmarks.ladder --config 4`` started from its tree (with
the arguments after ``--``, e.g. ``--steps 20``), so each builds and
loads its own kernels. The runs go base, change, change, base, ...
(``--rounds`` such groups), so a drift of the card or the host falls on
both alike. With ``--trace`` every run also traces its steps, and the
summary adds the device busy time, the idle share of an untraced step
(one less busy over step time: the profiler slows the traced steps'
host) and the flash kernels' device time per step. Every run's JSON line
is printed as it ends; the last line is the summary: step ms of each
run, the median, tokens/s at the median, per tree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
TOKENS_PER_STEP = 8 * 512  # the rung's batch x seq


def order(rounds: int) -> list[str]:
    """``["base", "change", "change", "base"]`` repeated ``rounds`` times."""
    return ["base", "change", "change", "base"] * rounds


def summarize(runs: list[tuple[str, dict]]) -> dict:
    """Per tree: the runs' step ms in the order they ran, their median and
    tokens/s at it, and (where traced) the medians of busy ms, the idle
    share of the untraced step and each flash kernel's ms per step."""
    out = {}
    for tree in ("base", "change"):
        recs = [r for t, r in runs if t == tree]
        if not recs:
            continue
        steps = [r["step_ms"] for r in recs]
        med = statistics.median(steps)
        s = {"step_ms": steps, "median_step_ms": med,
             "tokens_per_s_at_median": TOKENS_PER_STEP / med * 1e3,
             "loss": [r["loss"] for r in recs]}
        traced = [r for r in recs if "busy_ms" in r]
        if traced:
            s["busy_ms"] = statistics.median(r["busy_ms"] for r in traced)
            s["step_idle_share"] = statistics.median(
                1.0 - r["busy_ms"] / r["step_ms"] for r in traced)
            s["flash_ms_per_step"] = {
                k: statistics.median(r["flash_kernels"][k]["ms"] for r in traced)
                for k in traced[0]["flash_kernels"]}
        out[tree] = s
    return out


def run(tree: Path, args: list[str], trace: Path | None) -> dict:
    """One ladder run as a fresh process from ``tree``; its JSON line."""
    cmd = [sys.executable, "-m", "pytorch_distributedtraining_tpu_torch.benchmarks.ladder",
           "--config", "4", *args]
    if trace is not None:
        cmd += ["--trace", str(trace)]
    out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("ladder_args", nargs=argparse.REMAINDER,
                    help="after --: arguments for every ladder run")
    opt = ap.parse_args(argv)
    args = [a for a in opt.ladder_args if a != "--"]
    trees = {"base": opt.base.resolve(), "change": HERE}
    runs = []
    for i, tree in enumerate(order(opt.rounds)):
        trace = None
        if opt.trace:
            (trees[tree] / "build").mkdir(exist_ok=True)
            trace = trees[tree] / "build" / f"ab_{i}.json"
        rec = run(trees[tree], args, trace)
        runs.append((tree, rec))
        print(json.dumps({"tree": tree, **rec}), flush=True)
    print(json.dumps({"ab_ladder": summarize(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
