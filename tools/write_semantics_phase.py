#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s write-semantics phase (17) at full size on one
card, with its wall times: bench config 2's store_sales (10M rows) with the
change data feed, a CHECK constraint and a generated column, the evolving
1M-row MERGE, a DV DELETE and UPDATE, a refused batch, ``table_changes``
and two streams. The quick check of the write semantics after a change to
them, without the smoke's other phases.

    python3 tools/write_semantics_phase.py

Prints the phase's lines as the smoke does and ``write_semantics_phase: ok``
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
from delta_tpu_torch.ops import native, page_codec  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("write_semantics_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)} | {card}")
    cs.say(f"build: {native.build_all():.3f} s")
    with tempfile.TemporaryDirectory(prefix="write_semantics_phase_") as workdir:
        t0 = time.perf_counter()
        before = dict(page_codec.device_ms)
        cs.run_write_semantics(dev, workdir, card)
        spent = {k: round(v - before.get(k, 0.0), 3) for k, v in page_codec.device_ms.items()}
        cs.say(f"phase 17: {time.perf_counter() - t0:.1f} s, page codec device ms {spent} "
               f"| {card}")
    cs.say("write_semantics_phase: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
