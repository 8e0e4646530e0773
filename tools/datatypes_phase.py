#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s data-types phase (15: store_sales with its money
columns decimal(7,2) through the write, a plan, reads with the residual on
the card and on the host, MERGEs, a DV UPDATE and DELETE, OPTIMIZE ZORDER
BY, a struct-stats checkpoint and time travel; then a table of struct,
list and map columns through the write, a MERGE, a DV DELETE and
OPTIMIZE) at full size on one card, with each step's wall time: the quick
check of the decimal and nested path after a change to it, without the
smoke's other phases.

    python3 tools/datatypes_phase.py

Prints the phase's lines as the smoke does and ``datatypes_phase: ok``
last; exits non-zero without a CUDA device or when a check fails.
"""
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from delta_tpu_torch.ops import native  # noqa: E402
from delta_tpu_torch.utils.config import conf  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("datatypes_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)} | {card}")
    cs.say(f"build: {native.build_all():.3f} s")
    with tempfile.TemporaryDirectory(prefix="datatypes_phase_") as workdir:
        t0 = time.perf_counter()
        with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
            cs.run_decimal(dev, workdir, card)
        cs.say(f"phase 15a: {time.perf_counter() - t0:.1f} s | {card}")
        t0 = time.perf_counter()
        cs.run_nested(dev, workdir, card)
        cs.say(f"phase 15b: {time.perf_counter() - t0:.1f} s | {card}")
    cs.say("datatypes_phase: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
