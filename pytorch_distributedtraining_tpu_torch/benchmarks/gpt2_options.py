"""GPT-2 125M's training options one at a time: what each costs a step.

Each row is the ladder's config 4 (bf16, batch 8 x 512, the flash
``attn_fn``, per-leaf AdamW, built by ``ladder.build_lm``) with one option
on: an untied head, dropout 0.1 (masks from the train state's stream),
full per-block remat (``GPT2Config.remat``), the numerics probe
(``TrainStep(numerics=True)``), then all four. The base runs first and
again last, since a process's first steps run slower. On a card each row
also traces ``--steps`` steps (device busy ms, kernels and device ms by
family, the idle share) and reads the allocator's peak. One JSON line a
row::

    python -m pytorch_distributedtraining_tpu_torch.benchmarks.gpt2_options --steps 10

``--tiny --device cpu`` runs the rows at ``GPT2Config.tiny`` (batch 8 x
32), untimed by the card, as the tests do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from ..models.gpt2 import GPT2Config
from ..runtime.dist import resolve_device
from .ladder import _timed_steps, _traced_steps, build_lm

ALL = {"tie_word_embeddings": False, "dropout": 0.1, "remat": "full", "numerics": True}
ROWS = [("none", {}), ("untied head", {"tie_word_embeddings": False}),
        ("dropout 0.1", {"dropout": 0.1}), ("remat full", {"remat": "full"}),
        ("numerics probe", {"numerics": True}), ("all four", ALL), ("none (again)", {})]


def run_row(name: str, options: dict, tiny: bool, steps: int, warmup: int,
            device: torch.device, trace_dir: str) -> dict:
    fields = dict(options)
    numerics = fields.pop("numerics", False)
    cfg = dataclasses.replace(GPT2Config.tiny() if tiny else GPT2Config.gpt2_125m(), **fields)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _, step, tokens = build_lm(cfg, 8, 32 if tiny else 512, device, numerics=numerics)
    dt, metrics = _timed_steps(step, tokens, steps, warmup)
    row = {"options": name, "step_ms": dt / steps * 1e3, "loss": float(metrics["loss"]),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if device.type == "cuda":
        row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        traced = _traced_steps(step, tokens, steps, os.path.join(trace_dir, "options.json"))
        row.update({k: traced[k] for k in ("busy_ms", "kernels_per_step", "device_ms_by_family",
                                           "flash_kernels")})
        row["idle_untraced"] = 1 - row["busy_ms"] / row["step_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = ap.parse_args(argv)
    device = resolve_device(opt.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as trace_dir:
        for name, options in ROWS:
            print(json.dumps(run_row(name, options, opt.tiny, opt.steps, opt.warmup, device,
                                     trace_dir)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
