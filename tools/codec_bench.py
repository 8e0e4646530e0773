#!/usr/bin/env python3
"""Time the page codec's kernels (``csrc/page_codec.cu``) on one card at
the writer's shapes: ``chip_smoke.codec_rows`` (a 1 MiB page and eight, cut
from store_sales columns' PLAIN and BYTE_STREAM_SPLIT bytes), then the
small-file shape of a date-partitioned store_sales (eight pages of 2,000
rows, one file's columns), each as the wrapper's whole call and as the
launch alone.

    python3 tools/codec_bench.py

Prints one JSON line a shape with the card's name and power limit.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from delta_tpu_torch.exec import snappy  # noqa: E402
from delta_tpu_torch.ops import native, page_codec  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("codec_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    native.build_all()
    rows = cs.codec_rows(dev, {})
    print(json.dumps({"card": card, "rows": rows}))
    plain, bss = cs.kernel_cases()._store_sales_bytes(2000)
    pages = [b for _, b in plain + bss]
    sizes = [len(p) for p in pages]
    z = page_codec.compress(pages, dev)
    check = page_codec.decompress(z, sizes, dev)
    cs.check(check == pages, "small pages do not round-trip")
    out = {"card": card, "shape": "8 pages of 2,000 rows (16,000 bytes each)",
           "snappy_bytes": sum(map(len, z)),
           "compress_ms": cs.cuda_ms(lambda: page_codec.compress(pages, dev), 50),
           "decompress_ms": cs.cuda_ms(lambda: page_codec.decompress(z, sizes, dev), 50),
           "plain_compress_ms": cs.cuda_ms(lambda: [snappy.compress(p) for p in pages], 5),
           "plain_decompress_ms": cs.cuda_ms(lambda: [snappy.decompress(x) for x in z], 5)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
