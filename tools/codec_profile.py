#!/usr/bin/env python3
"""Where the page codec's kernels spend their cycles, phase by phase, on
one card: an instrumented copy of ``delta_tpu_torch/csrc/page_codec.cu``
(``clock64`` read by thread 0 of block 0 after each phase's barrier, into
a device array) is built with ``nvcc`` into ``build/codec_profile/`` and
run once on ``chip_smoke.codec_rows``' 1 MiB page of store_sales bytes.

    python3 tools/codec_profile.py [--no-match-any]

Prints one JSON line: the card's name and power limit, and the cycles of
each phase of block 0 (``snappy_decompress``: the page, 161 chunks;
``snappy_compress``: its first fragment), with the chunk and round counts.
The compressor's walk (warp 1) and hash (warp 0) run side by side and are
also timed alone. ``--no-match-any`` times the compressor with
``__match_any_sync`` taken out of the hash (its output is then not the
kernel's: timing only). The copy is made by inserting counters after
fixed lines of the source; a line that moved stops the script.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from delta_tpu_torch.ops import native, page_codec  # noqa: E402

#: (the source line a counter follows, the counter): phase k adds the cycles
#: since the last counter of the thread
PROBES = [
    ("namespace {\n", "\n__device__ long long g_prof[32];\n#define PROF_BEGIN long long _t = clock64();\n"
     "#define PROF(k) if (threadIdx.x == 0 && blockIdx.x == 0) { long long _n = clock64(); "
     "g_prof[k] += _n - _t; _t = _n; }\n"),
    ("  while (!e && s < n) {\n", "    PROF_BEGIN\n"),
    ("    __syncthreads();  // every thread's copies of this chunk's units have landed\n",
     "    PROF(0)\n"),
    ("      sh.gx[seg0 + g * 32 + lane] = (uint16_t)p;\n      __syncwarp();\n    }\n"
     "    __syncthreads();\n", "    PROF(1)\n"),
    ("      sh.entry[kWarps] = e;\n    }\n    __syncthreads();\n", "    PROF(2)\n"),
    ("      sh.ws_out[warp] = run;\n    }\n    __syncthreads();\n", "    PROF(3)\n"),
    ("      sh.word[3] = nb;\n    }\n    __syncthreads();\n", "    PROF(4)\n"),
    ("          sh.est[nel] = (int)(o + el.out_len);\n        }\n      }\n    }\n"
     "    __syncthreads();\n", "    PROF(5)\n"),
    ("          st[pad(q - b0)] = w;\n        }\n      }\n", "      PROF(6)\n"),
    ("      while (__syncthreads_or(pending)) {\n",
     "        if (threadIdx.x == 0 && blockIdx.x == 0) g_prof[10] += 1;\n"),
    ("            pending |= !(w[i] & kDone);\n          }\n        }\n      }\n", "      PROF(7)\n"),
    ("        dst[b0 + i] = v;\n      }\n      __syncthreads();\n", "      PROF(8)\n"),
    ("    op = end;\n    s = sh.word[1];\n    __syncthreads();\n",
     "    PROF(9)\n    if (threadIdx.x == 0 && blockIdx.x == 0) g_prof[11] += 1;\n"),
    ("      // (b) warp 1 walks the chosen matches, one shared load a step; lane\n"
     "      // k % 32 keeps the k-th, stored 32 at a time\n", "      long long _w0 = clock64();\n"),
    ("      if (lane == 0) {\n        sh.walk[0] = k;\n        sh.walk[1] = cur;\n      }\n",
     "      if (threadIdx.x == 32 && blockIdx.x == 0) g_prof[21] += clock64() - _w0;\n"),
    ("      // meanwhile warp 0 finds the next tile's candidates\n", "      long long _h0 = clock64();\n"),
    ("      hash_tile(sh, base + kTile, min(base + 2 * kTile, n), n, sh.cand[(t + 1) & 1], lane);\n",
     "      if (threadIdx.x == 0 && blockIdx.x == 0) g_prof[22] += clock64() - _h0;\n"),
    ("  if (warp == 0 && n >= 4) hash_tile(sh, 0, min(kTile, n), n, sh.cand[0], lane);\n"
     "  __syncthreads();\n", "  PROF_BEGIN\n"),
    ("    sh.first[tid] = run;\n    __syncthreads();\n", "    PROF(16)\n"),
    ("        sh.next[lo + k] = w == kNoMatch ? w : w + ((w & 0xffu) << 8);\n      }\n    }\n"
     "    __syncthreads();\n", "    PROF(17)\n"),
    ("g_prof[22] += clock64() - _h0;\n    }\n    __syncthreads();\n", "    PROF(18)\n"),
    ("        o += copy_bytes(offset, sh.len[i]);\n      }\n    }\n    __syncthreads();\n",
     "    PROF(19)\n"),
    ("    op += total;\n    __syncthreads();\n", "    PROF(20)\n"),
]
PHASES = {0: "d: input wait", 1: "d: decode, group and segment exits", 2: "d: segment entries",
          3: "d: members, warp scan", 4: "d: warp bases", 5: "d: checks",
          6: "d: batch bytes (thread 0)", 7: "d: batch rounds", 8: "d: ring and slot",
          9: "d: chunk end", 10: "d: rounds", 11: "d: chunks",
          16: "c: lengths", 17: "c: suffix, next", 18: "c: walk beside hash", 19: "c: emit",
          20: "c: long literals", 21: "c: walk alone (warp 1)", 22: "c: hash alone (warp 0)"}
READ = '''
extern "C" int dtt_prof_read(long long* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 32);
  long long z[32] = {0};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)cudaGetLastError();
}
'''


def instrumented(src: str, match_any: bool) -> str:
    for line, probe in PROBES:
        at = src.find(line)
        if at < 0:
            raise SystemExit(f"codec_profile: the source has no line {line!r}")
        at += len(line)
        src = src[:at] + probe + src[at:]
    if not match_any:
        src = src.replace("__match_any_sync(kFull, has ? h : (0x80000000u | lane))", "(1u << lane)")
    return src + READ


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-match-any", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("codec_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "codec_profile")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "page_codec_prof.cu"), os.path.join(out_dir, "page_codec_prof.so")
    with open(os.path.join(ROOT, "delta_tpu_torch", "csrc", "page_codec.cu")) as f:
        text = instrumented(f.read(), not args.no_match_any)
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([native._nvcc(), *native._FLAGS, "-o", so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for fn in (lib.dtt_snappy_compress, lib.dtt_snappy_decompress):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
    lib.dtt_prof_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    native.build_all()
    plain, bss = cs.kernel_cases()._store_sales_bytes(1 << 20)
    page = b"".join(b for _, b in plain + bss)[:1 << 20]
    z = page_codec.compress([page], dev)
    table, _ = page_codec.fragment_table([len(page)])
    src = torch.from_numpy(np.frombuffer(page, np.uint8).copy()).to(dev)
    frags = torch.from_numpy(table).to(dev)
    scratch = torch.empty(len(table) * page_codec.FRAG_CAP, dtype=torch.uint8, device=dev)
    fsizes = torch.empty(len(table), dtype=torch.int32, device=dev)
    zsrc = torch.from_numpy(np.frombuffer(z[0], np.uint8).copy()).to(dev)
    pt = torch.tensor([[0, len(z[0]), 0, len(page)]], dtype=torch.int64, device=dev)
    out = torch.empty(len(page), dtype=torch.uint8, device=dev)
    err = torch.empty(1, dtype=torch.int32, device=dev)
    cycles = np.zeros(32, np.int64)
    lib.dtt_prof_read(cycles.ctypes.data)
    stream = torch.cuda.current_stream().cuda_stream
    lib.dtt_snappy_decompress(zsrc.data_ptr(), pt.data_ptr(), 1, out.data_ptr(), err.data_ptr(),
                              stream)
    lib.dtt_snappy_compress(src.data_ptr(), frags.data_ptr(), len(table), scratch.data_ptr(),
                            fsizes.data_ptr(), stream)
    torch.cuda.synchronize()
    lib.dtt_prof_read(cycles.ctypes.data)
    cs.check(torch.equal(out, src) and int(err.item()) == 0,
             "codec_profile: the instrumented decompressor is wrong")
    print(json.dumps({"card": cs.card_line(), "match_any": not args.no_match_any,
                      "page": "1 MiB of store_sales PLAIN and BYTE_STREAM_SPLIT bytes",
                      "cycles": {name: int(cycles[k]) for k, name in PHASES.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
