"""Two trees of the repository against each other on one card: the SwinIR-S
step profile (``benchmarks.profile_swinir``) from each, in turns.

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.ab_swinir --base build/parent \
        [--rounds 1] [-- PROFILE ARGUMENTS]

``--base`` is another checkout of the repository (for instance the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists); the other tree is the one this module lives in. Each run is a fresh
process of ``benchmarks.profile_swinir`` started from its tree, unchanged
(with the arguments after ``--``, e.g. ``--steps 5``), so each builds and
loads its own kernels; it times the bench step untraced, then traces it,
in f32 and in bf16. The runs go base, change, change, base, ... (``--rounds``
such groups), so a drift of the card or the host falls on both alike.
Every run's JSON lines are printed as they come; the last line is the
summary per tree and precision: the untraced step ms of each run in the
order run, their median and images/s at it, and the medians of device
busy ms per step, the idle share of an untraced step (one less busy over
step time: the profiler slows the traced steps' host) and window
attention's (K1/K2) device ms per step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from .ab_ladder import order
from .profile_swinir import ACCUM, BATCH

HERE = Path(__file__).resolve().parents[2]
IMAGES_PER_STEP = BATCH * ACCUM
WINDOW_FAMILY = "window attention (K1/K2)"


def summarize(runs: list[tuple[str, dict]]) -> dict:
    """``{tree: {precision: summary}}`` of ``(tree, profile record)`` pairs."""
    out: dict = {}
    for tree in ("base", "change"):
        for precision in ("fp32", "bf16"):
            recs = [r for t, r in runs if t == tree and r["precision"] == precision]
            if not recs:
                continue
            steps = [r["step_ms"] for r in recs]
            med = statistics.median(steps)
            s = {"step_ms": steps, "median_step_ms": med,
                 "images_per_s_at_median": IMAGES_PER_STEP / med * 1e3}
            traced = [r for r in recs if "busy_ms" in r]
            if traced:
                s["busy_ms"] = statistics.median(r["busy_ms"] for r in traced)
                s["step_idle_share"] = statistics.median(
                    1.0 - r["busy_ms"] / r["step_ms"] for r in traced)
                s["window_attn_ms"] = statistics.median(
                    r["device_ms_by_family"].get(WINDOW_FAMILY, 0.0) for r in traced)
            out.setdefault(tree, {})[precision] = s
    return out


def run(tree: Path, args: list[str]) -> list[dict]:
    """One profile run as a fresh process from ``tree``: its JSON lines."""
    (tree / "build").mkdir(exist_ok=True)  # where the profile writes its traces
    cmd = [sys.executable, "-m", "pytorch_distributedtraining_tpu_torch.benchmarks.profile_swinir",
           *args]
    out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, check=True).stdout
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("profile_args", nargs=argparse.REMAINDER,
                    help="after --: arguments for every profile run")
    opt = ap.parse_args(argv)
    args = [a for a in opt.profile_args if a != "--"]
    trees = {"base": opt.base.resolve(), "change": HERE}
    runs = []
    for tree in order(opt.rounds):
        for rec in run(trees[tree], args):
            runs.append((tree, rec))
            print(json.dumps({"tree": tree, **rec}), flush=True)
    print(json.dumps({"ab_swinir": summarize(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
