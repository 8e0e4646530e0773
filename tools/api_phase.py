#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s table API phase (16) at full size on one card,
with its wall times: 16a on config 6's 1M-file residency (phase 4 first,
under ``devicePlan.mode=force``), then 16b-16d (bench config 2 through
``DeltaTable``, clone, GENERATE, the catalog, CONVERT TO DELTA). The quick
check of the table API after a change to it, without the smoke's other
phases.

    python3 tools/api_phase.py [--no-16a]

Prints the phases' lines as the smoke does and ``api_phase: ok`` last;
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
from delta_tpu_torch.ops import native, page_codec  # noqa: E402
from delta_tpu_torch.utils.config import conf  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("api_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)} | {card}")
    cs.say(f"build: {native.build_all():.3f} s")
    with tempfile.TemporaryDirectory(prefix="api_phase_") as workdir:
        if "--no-16a" not in sys.argv[1:]:
            t0 = time.perf_counter()
            with conf.set_temporarily(**{"delta.tpu.stateCache.devicePlan.mode": "force"}):
                ctx = cs.run_slice(dev, workdir)
                cs.say(f"phase 4: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                cs.run_plan_queries(dev, ctx)
            cs.say(f"phase 16a: {time.perf_counter() - t0:.1f} s | {card}")
            ctx = None
            cs.state_cache.DeviceStateCache.reset()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        before = dict(page_codec.device_ms)
        cs.run_table_api(dev, workdir, card)
        spent = {k: round(v - before.get(k, 0.0), 3) for k, v in page_codec.device_ms.items()}
        cs.say(f"phase 16b-d: {time.perf_counter() - t0:.1f} s, page codec device ms {spent} "
               f"| {card}")
    cs.say("api_phase: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
