#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s partitioned phase (14: bench config 6p's plans,
then store_sales partitioned by date through the writer, reads with the
device residual, MERGE, DELETE, UPDATE, replaceWhere, OPTIMIZE and VACUUM)
at full size on one card, with each part's wall time: the quick check of
the partitioned path after a change to it, without the smoke's other
phases.

    python3 tools/partition_phase.py

Prints the phase's lines as the smoke does and ``partition_phase: ok``
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
from delta_tpu_torch.ops import native, state_cache  # noqa: E402
from delta_tpu_torch.utils.config import conf  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("partition_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)} | {card}")
    cs.say(f"build: {native.build_all():.3f} s")
    with tempfile.TemporaryDirectory(prefix="partition_phase_") as workdir:
        t0 = time.perf_counter()
        with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
            cs.run_c6p(dev, workdir, card)
        state_cache.DeviceStateCache.reset()
        cs.say(f"phase 14a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.run_partitioned(dev, workdir, card)
        cs.say(f"phase 14b: {time.perf_counter() - t0:.1f} s | {card}")
    cs.say("partition_phase: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
