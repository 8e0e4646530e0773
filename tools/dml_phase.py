#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s MERGE command phase (7) and then its DML phase
(13: DELETE, UPDATE, MERGE, RESTORE, VACUUM and time travel on bench config
2) at full size on one card, with each phase's wall time: the quick check
of the DML path after a change to it, without the smoke's other phases.

    python3 tools/dml_phase.py

Prints the phases' lines as the smoke does and ``dml_phase: ok`` last;
exits non-zero without a CUDA device or when a check fails.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("dml_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)} | {card}")
    cs.say(f"build: {native.build_all():.3f} s")
    with tempfile.TemporaryDirectory(prefix="dml_phase_") as workdir:
        t0 = time.perf_counter()
        cctx = cs.run_merge_command(dev, workdir)
        c2 = {"path": cctx["path"], "state": cctx["state"], "m3": cctx["merges"][-1]}
        cctx = None
        cs.say(f"phase 7: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.run_dml(dev, c2, workdir, card)
        cs.say(f"phase 13: {time.perf_counter() - t0:.1f} s | {card}")
    cs.say("dml_phase: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
