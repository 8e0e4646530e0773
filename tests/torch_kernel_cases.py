"""Inputs of the slab probe K9 and of the tail apply (K3 with K2) at their
hard shapes, as numpy arrays.

Imports numpy only, so the GPU tests (which run where JAX cannot be
imported), ``chip_smoke.py`` and the CPU tests (which hand the same arrays
to ``delta_tpu``'s kernels) share them.

``probe_case(name, scale)`` returns ``(sorted_keys int64 (cap,),
sorted_valid bool (cap,), n, s_keys int32 or int64 (m,))``: the real rows
``[0, n)`` sorted, the rows ``[n, cap)`` whatever the case puts there (the
kernel must ignore them). ``scale`` multiplies the row counts (1 on the
CPU). ``name`` is one of :data:`CASE_NAMES`:

* ``i32-high-bits``: an int32 source against slab keys that equal a source
  key in the low 32 bits only (a key narrowed to int32 would match);
* ``i64-extremes``: ``INT64_MIN`` (the hash table's empty-slot key) and
  ``INT64_MAX`` among the real slab keys and the source's;
* ``i32-min``: ``INT32_MIN`` (the int32 table's empty-slot key) in an int32
  source and among the slab keys;
* ``long-runs``: runs of thousands of equal slab keys, some rows valid and
  some not, one run all invalid;
* ``dup-source``: source keys repeated, matched and unmatched (multi);
* ``pad-rows``: rows in ``[n, cap)``, valid, whose keys equal source keys;
* ``m8``: a source of 8 keys;
* ``n0``: no real row;
* ``full``: ``n = cap``;
* ``sentinel-padded``: the source as ``KeyCache.probe_async`` builds it,
  ``m`` keys then copies of the int32 sentinel up to the bucket;
* ``crowded``: the slab's keys span +-2^62 but nearly all of them, and of
  the source's, lie in [0, 6000): ordered by key, the source crowds a few
  slots of the kernel's table and spills into its overflow part.

:func:`reference_probe` is an independent numpy oracle of the contract.

``compact_case(case, scale)`` returns the pair compaction K10's inputs
``(t_match bool (cap,), s_first int32 (cap,), perm int32 (cap,), out_cap)``
as the probe hands them over: ``perm`` the sort's permutation (the real rows
``[0, n)`` shuffled, the pad rows ``[n, cap)`` in place), no match at or past
``n``. ``case`` is one of :data:`COMPACT_CASES`: ``none`` (no match),
``all`` (every row of a full slab), ``exact`` (``out_cap`` equal to the
count, not a power of two), ``short`` (``out_cap`` below the count: the
first pairs in physical order are kept), ``tile-edge`` (matches only at
physical rows from 32,768, a boundary of the emit's 8,192-row tiles, and at
the slab's last live row), ``band`` (a band of rows that are neighbours in both orders, all
matched: whole bitmap words set by one warp) and ``n-below-cap`` (half the
rows are pad). :func:`reference_compact` is a numpy oracle of the contract.

``advance_case(rng, cap, d, case, wide)`` returns one slab advance's parts
as ``key_cache.pack_advance`` takes them (keyword arguments): distinct rows
in a slice of ``d // 2`` rows, three runs (one of a single row) and a row
list of ``d`` rows holding pads (``cap``) and negative rows (XLA wraps
them), keys past int32 when ``wide``; ``case`` is one of
:data:`ADVANCE_CASES`: ``slice`` (the slice, an unkeyed list, the runs),
``keyed`` (the list carries keys too), ``mirror`` (no key changes: the list
and the runs, as an advance with the sorted view live).

``tail_case(c, case, cap)`` returns a commit tail as
``ResidentState._apply_tail_device`` hands it to ``tail_apply``: the lanes
``alive`` (cap,) bool and ``mins``, ``maxs`` (c, cap) float32; the dead rows
padded to 512 with ``cap``, with negative and out-of-range indices (XLA
wraps or drops them); the added range ``(start, k)`` and its (c, k) float32
bounds, NaN in every seventh column. ``case`` is one of
:data:`TAIL_CASES`: ``fresh`` (a range below cap), ``wrap`` (a negative
start), ``past-cap`` (a range that runs past cap, whose tail is dropped),
``overlap`` (dead rows inside the added range, which end True).

``combine_case(op, n, k, offset, seed)`` returns a flat numpy buffer of
``n * k + offset + 3`` elements (int64 for ``sum``, u8 for ``or``, mostly
zero) that holds the cross-shard combine's ``(n, k)`` rows at element
``offset``; :func:`combine_rows` cuts them out of it (a numpy array or a
tensor), contiguous, their base off a 16-byte boundary when ``offset`` is
not a multiple of 16 bytes' elements. :func:`reference_combine` is the
numpy oracle (the wrapping sum, the bytewise OR). ``COMBINE_KS`` and
``COMBINE_NS`` are the widths and row counts the tests cross.

``zsort_case(case)`` returns an int64 column for the Z-order sorts (the
key's unsigned order and a column's signed rank): ``equal`` (one value),
``sorted`` and ``reversed`` (full 64-bit keys, bit 63 set in half, in
unsigned order and its reverse), ``narrow`` (a k = 2 key: 32 bits that
vary, many ties), ``one`` and ``two`` (n = 1, 2), ``big`` (n = 2^22 + 5,
random 64-bit patterns, runs of ties). ``ZSORT_CASES`` names them;
:func:`reference_key_order` and :func:`reference_rank` are the numpy
oracles (``np.argsort(kind="stable")`` of the unsigned key; ``rank_u16``).

``codec_pages(big)`` returns the page codec's batch as ``(name, bytes)``:
0 B, 1 B, 64 KiB - 1, 64 KiB and 64 KiB + 1 (a fragment's edges), a
short-period repeat, random bytes, zeros, literal-length edges (60-64,
256 and 65,536 bytes of random bytes), bench config 2's store_sales
columns (``bench.py:168-181``'s draws, seed 7) as 32,768 rows' PLAIN
int64 and BYTE_STREAM_SPLIT float64 pages, and pages of 1 MiB and 8 MiB cut
from those columns' bytes; ``big=False`` (the CPU) takes 8,192 rows and
256 KiB in place of 32,768 rows, 1 MiB and 8 MiB.
``codec_malformed()`` returns ``(name, body, uncompressed size)`` of raw
Snappy bodies that must not decode: cut short, a copy of offset 0, a copy
reaching before the page, a preamble that disagrees with the size, and
output past the size.

``codec_streams()`` returns ``(name, body, expected bytes)`` of raw Snappy
bodies that the port's compressor never writes, built element by element
here (no ``pyarrow``): :data:`CODEC_STREAMS` names them: ``copy-tags``
(copy-1, copy-2 and copy-4 tags at random offsets and lengths, copies of 1-3
bytes among them), ``copy4-far`` (a 2 MiB page of copy-4 tags whose
offsets reach past 64 KiB), ``overlap`` (a copy of every offset 1-63 at
every length 4-64), ``literal-lengths`` (literals with 1, 2, 3 and 4 length
bytes, one of them over 64 KiB) and ``one-run`` (1 MiB of one byte).
``codec_faults()`` returns ``(name, body, uncompressed size, error word)``
of bodies whose fault lies after their 33rd element, in the first input
chunk or deep in the page (:data:`CODEC_FAULTS`); the error words are
``ops/page_codec.ERRORS``'.
"""
import numpy as np

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
TAIL_CASES = ["fresh", "wrap", "past-cap", "overlap"]
ADVANCE_CASES = ["slice", "keyed", "mirror"]
COMPACT_CASES = ["none", "all", "exact", "short", "tile-edge", "band", "n-below-cap"]
COMBINE_KS = [0, 1, 15, 16, 17, (1 << 20) + 3]
COMBINE_NS = [1, 3, 8, 33]
ZSORT_CASES = ["equal", "sorted", "reversed", "narrow", "one", "two", "big"]
CODEC_MALFORMED = ["truncated", "offset-0", "before-page", "preamble", "overflow"]
CODEC_STREAMS = ["copy-tags", "copy4-far", "overlap", "literal-lengths", "one-run"]
CODEC_FAULTS = ["mid-offset-0", "mid-before-page", "mid-copy4-before", "mid-overflow",
                "mid-literal-past-input", "mid-tag-past-input", "deep-offset", "deep-overflow",
                "short"]
CASE_NAMES = ["i32-high-bits", "i64-extremes", "i32-min", "long-runs", "dup-source", "pad-rows",
              "m8", "n0", "full", "sentinel-padded", "crowded"]


def _sorted(keys, valid, n, pad_keys=None, pad_valid=None):
    order = np.argsort(keys[:n], kind="stable")
    cap = len(keys)
    pk = np.full(cap - n, I64_MAX, np.int64) if pad_keys is None else pad_keys
    pv = np.zeros(cap - n, bool) if pad_valid is None else pad_valid
    return (np.concatenate([keys[:n][order], pk]).astype(np.int64),
            np.concatenate([valid[:n][order], pv]).astype(bool))


def probe_case(name: str, scale: int = 1):
    rng = np.random.RandomState(CASE_NAMES.index(name) + 100 * scale)
    cap = 16384 * scale
    n = cap - 1000 * scale
    valid = rng.rand(cap) > 0.2
    if name == "i32-high-bits":
        base = rng.randint(I32_MIN, I32_MAX, 2000 * scale).astype(np.int64)
        keys = base[rng.randint(0, len(base), cap)] + (rng.randint(-3, 4, cap) << 32)
        s = base[rng.randint(0, len(base), 4096 * scale)].astype(np.int32)
        return (*_sorted(keys, valid, n), n, s)
    if name == "i64-extremes":
        keys = rng.randint(-1000, 1000, cap).astype(np.int64)
        keys[rng.choice(n, 300, replace=False)] = I64_MIN
        keys[rng.choice(n, 300, replace=False)] = I64_MAX
        keys[rng.choice(n, 50, replace=False)] = I64_MAX - 1
        s = np.concatenate([rng.randint(-1500, 1500, 4000 * scale),
                            [I64_MIN, I64_MIN, I64_MAX, I64_MAX - 1, I64_MIN + 1, 7, 7, 7]])
        return (*_sorted(keys, valid, n), n, s[rng.permutation(len(s))].astype(np.int64))
    if name == "i32-min":
        keys = rng.randint(-1000, 1000, cap).astype(np.int64)
        keys[rng.choice(n, 200, replace=False)] = I32_MIN
        keys[rng.choice(n, 200, replace=False)] = I32_MIN - 1  # outside int32: no match
        s = np.concatenate([rng.randint(-1500, 1500, 4096 * scale - 8), [I32_MIN] * 3,
                            [I32_MAX] * 5]).astype(np.int32)
        return (*_sorted(keys, valid, n), n, s[rng.permutation(len(s))])
    if name == "long-runs":
        keys = rng.randint(0, 5000, cap).astype(np.int64)
        for k, rows in ((11, 3000), (22, 2500), (33, 4000)):
            keys[rng.choice(n, rows * scale, replace=False)] = k
        valid[keys == 33] = False  # one run all invalid
        s = np.concatenate([[11, 22, 33, 11], rng.randint(0, 8000, 4096 * scale - 4)])
        return (*_sorted(keys, valid, n), n, s[rng.permutation(len(s))].astype(np.int64))
    if name == "dup-source":
        keys = rng.randint(0, 3000, cap).astype(np.int64)
        s = np.repeat(rng.randint(0, 6000, 1024 * scale), 4)  # half present, each 4 times
        return (*_sorted(keys, valid, n), n, s[rng.permutation(len(s))].astype(np.int32))
    if name == "pad-rows":
        keys = rng.randint(0, 3000, cap).astype(np.int64)
        s = rng.randint(0, 6000, 4096 * scale).astype(np.int64)
        s[:8] = [I64_MAX, 9000, 9001, 9002, 9003, 9004, 9005, 9006]  # only in the pad rows
        pad = np.concatenate([[I64_MAX], 9000 + np.arange(cap - n - 1) % 7]).astype(np.int64)
        return (*_sorted(keys, valid, n, pad, np.ones(cap - n, bool)), n, s)
    if name == "m8":
        keys = rng.randint(0, 100, cap).astype(np.int64)
        return (*_sorted(keys, valid, n), n, np.array([5, 99, 5, 200, -1, 0, 50, 5], np.int64))
    if name == "n0":
        keys = rng.randint(0, 100, cap).astype(np.int64)
        return (*_sorted(keys, valid, 0, keys, valid), 0,
                rng.randint(0, 100, 64).astype(np.int32))
    if name == "full":
        keys = rng.randint(0, 8000, cap).astype(np.int64)
        return (*_sorted(keys, valid, cap), cap, rng.randint(0, 16000, 2048 * scale).astype(np.int64))
    if name == "crowded":
        keys = rng.randint(0, 3000, cap).astype(np.int64)
        keys[rng.choice(n, 500, replace=False)] = rng.randint(-(1 << 62), 1 << 62, 500)
        s = np.concatenate([rng.randint(0, 6000, 4000 * scale),
                            rng.randint(-(1 << 62), 1 << 62, 96 * scale)]).astype(np.int64)
        return (*_sorted(keys, valid, n), n, s[rng.permutation(len(s))])
    assert name == "sentinel-padded"
    keys = rng.randint(0, 1 << 20, cap).astype(np.int64)
    m = 3000 * scale
    s = np.full(4096 * scale, I32_MAX - 1, np.int32)
    s[:m] = np.concatenate([keys[rng.randint(0, n, m // 2)], rng.randint(0, 1 << 21, m - m // 2)])
    return (*_sorted(keys, valid, n), n, s)


def reference_probe(sk, sv, n, s):
    """``(head, t_match, s_first)`` of the contract, from a dict of the
    source's least index a key."""
    m, cap = len(s), len(sk)
    first = {}
    for j, k in enumerate(s.tolist()):
        first.setdefault(k, j)
    s_first = np.full(cap, m, np.int32)
    t_match = np.zeros(cap, bool)
    flagged = set()
    for r in range(n):
        j = first.get(int(sk[r]))
        if j is not None:
            s_first[r] = j
            if sv[r]:
                t_match[r] = True
                flagged.add(int(sk[r]))
    s_match = np.array([k in flagged for k in s.tolist()], bool)
    multi = any(s_match[j] and first[k] != j for j, k in enumerate(s.tolist()))
    mc = int(t_match.sum())
    head = np.concatenate([np.array([int(multi), 0] + [(mc >> sh) & 0xFF for sh in (0, 8, 16, 24)],
                                    np.uint8), np.packbits(s_match)])
    return head, t_match, s_first


def tail_case(c: int, case: str, cap: int = 8192):
    rng = np.random.RandomState(3 + c + TAIL_CASES.index(case) * 10 + cap % 1000)
    alive = rng.rand(cap) > 0.3
    mins = rng.rand(c, cap).astype(np.float32)
    maxs = mins + 1
    start, k = {"fresh": (cap - 1500, 1000), "wrap": (-700, 900), "past-cap": (cap - 300, 600),
                "overlap": (2000, 1000)}[case]
    dead = np.full(512, cap, np.int32)
    dead[:400] = rng.choice(cap, 400, replace=False)
    dead[400:406] = [-1, -cap, -cap - 1, cap + 5, 1 << 30, -(1 << 30)]
    if case == "overlap":
        dead[406:450] = rng.choice(np.arange(start, start + k), 44, replace=False)
    lo = rng.rand(c, k).astype(np.float32)
    hi = lo + 0.5
    lo[:, ::7] = np.nan
    return alive, mins, maxs, dead, start, k, lo, hi


def advance_case(rng, cap: int, d: int, case: str, wide: bool = False):
    """See the module docstring."""
    a = max(d // 2, 8)
    assert cap >= 8 * d and cap // 4 > a
    start = int(rng.randint(0, cap // 4 - a))
    runs = np.array([[cap // 4 + 17, a], [cap // 2, max(d // 4, 1)],
                     [cap // 2 + d // 4 + 5, 1]], np.int64)
    taken = np.zeros(cap, bool)
    taken[start:start + a] = True
    for o, n in runs:
        taken[o:o + n] = True
    listed = rng.choice(np.flatnonzero(~taken), d - d // 8, replace=False)
    neg = listed[: d // 16] - cap  # XLA wraps a negative index
    rows = np.concatenate([listed[d // 16:], neg, np.full(d - len(listed), cap)]).astype(np.int32)
    rows = rows[rng.permutation(len(rows))]
    hi = 1 << 40 if wide else 1 << 30
    parts = dict(rows=rows, rows_valid=rng.rand(d) > 0.5, runs=runs,
                 run_valid=np.array([False, True, False]))
    if case != "mirror":
        parts.update(start=start, slice_keys=rng.randint(-hi, hi, a),
                     slice_valid=rng.rand(a) > 0.2)
    if case == "keyed":
        parts["rows_keys"] = rng.randint(-hi, hi, d)
    return parts


def compact_case(case: str, scale: int = 1):
    """K10's inputs at one of :data:`COMPACT_CASES` (see the module's
    docstring), ``70,000 * scale`` rows."""
    rng = np.random.RandomState(COMPACT_CASES.index(case) + 17)
    cap = 70_000 * scale
    n = cap if case == "all" else cap // 2 if case == "n-below-cap" else cap - 777
    perm = np.arange(cap, dtype=np.int32)
    order = rng.permutation(n).astype(np.int32)
    if case == "band":  # rows [1000, 40000) keep their place: neighbours in both orders
        rest = np.setdiff1d(np.arange(n), np.arange(1000, 40_000))
        order = np.arange(n, dtype=np.int32)
        order[rest] = rest[rng.permutation(len(rest))]
    perm[:n] = order
    if case == "none":
        t = np.zeros(cap, bool)
    elif case == "all":
        t = np.ones(cap, bool)
    elif case == "tile-edge":
        t = ((perm >= 32_768) & (perm < 32_868)) | (perm == n - 1)
    elif case == "band":
        t = ((perm >= 1000) & (perm < 40_000)) | (rng.rand(cap) < 0.05)
    else:
        t = rng.rand(cap) < 0.3
    t[n:] = False
    s_first = rng.randint(-1, 1 << 20, cap).astype(np.int32)
    mc = int(t.sum())
    out_cap = mc if case == "exact" else max(mc // 3, 1) if case == "short" else \
        max(64, 1 << max(mc - 1, 0).bit_length())
    return t, s_first, perm, out_cap


def reference_compact(t, s_first, perm, out_cap):
    """K10's contract in numpy: the matched rows' (perm, s_first) in
    ascending perm, the first ``out_cap``, zeros after; (2, out_cap) int32."""
    idx = np.flatnonzero(t)
    order = np.argsort(perm[idx], kind="stable")[:out_cap]
    out = np.zeros((2, out_cap), np.int32)
    out[0, :len(order)] = perm[idx][order]
    out[1, :len(order)] = s_first[idx][order]
    return out


def combine_case(op: str, n: int, k: int, offset: int = 0, seed: int = 0):
    """A flat buffer holding (n, k) rows at element ``offset``: int64
    across the whole range for ``sum`` (its sum wraps), sparse nonzero
    bytes for ``or``."""
    rng = np.random.RandomState(seed + 31 * n + k % 1000 + offset)
    w = n * k + offset + 3
    if op == "sum":
        return rng.randint(I64_MIN, I64_MAX, w, dtype=np.int64)
    return ((rng.rand(w) < 0.05) * rng.randint(1, 256, w)).astype(np.uint8)


def combine_rows(buf, n: int, k: int, offset: int = 0):
    """The (n, k) rows of :func:`combine_case`'s buffer (numpy or torch)."""
    return buf[offset:offset + n * k].reshape(n, k)


def reference_combine(rows: np.ndarray, op: str) -> np.ndarray:
    """The combine's contract in numpy: the wrapping int64 sum, or the
    bytewise OR of the rows."""
    if op == "sum":
        return rows.sum(axis=0, dtype=np.int64)
    return np.bitwise_or.reduce(rows, axis=0).astype(np.uint8)


def zsort_case(case: str) -> np.ndarray:
    """An int64 column for the Z-order sorts (see the module's note)."""
    rng = np.random.RandomState(ZSORT_CASES.index(case) + 7)
    if case == "equal":
        return np.full(5000, -12345, np.int64)
    if case in ("sorted", "reversed"):
        u = np.sort(rng.randint(I64_MIN, I64_MAX, 100_000, dtype=np.int64).view(np.uint64))
        u[10:20] = u[10]  # ties
        u = u if case == "sorted" else u[::-1].copy()
        return u.view(np.int64)
    if case == "narrow":
        return rng.randint(0, 1 << 16, 200_000).astype(np.int64) << 16 | rng.randint(0, 4, 200_000)
    if case == "one":
        return np.array([I64_MIN], np.int64)
    if case == "two":
        return np.array([5, -5], np.int64)
    n = (1 << 22) + 5
    out = rng.randint(I64_MIN, I64_MAX, n, dtype=np.int64)
    out[rng.rand(n) < 0.2] = 42  # ties
    return out


def reference_key_order(key: np.ndarray) -> np.ndarray:
    """The key's stable order as unsigned (JAX's ``morton_order``'s argsort)."""
    return np.argsort(key.view(np.uint64), kind="stable")


def reference_rank(values: np.ndarray) -> np.ndarray:
    """``rank_u16`` of a column: the stable sort's position scaled to
    [0, 2^16), int32."""
    order = np.argsort(values, kind="stable")
    ranks = np.empty(len(values), np.int64)
    ranks[order] = np.arange(len(values))
    return ((ranks * 65535) // max(len(values) - 1, 1)).astype(np.int32)


#: the winner bits K4's streams (``winner_case``)
WINNER_CASES = ["config5", "config6", "random", "one-path", "zipf", "num-paths-1", "all-pad",
                "no-pad"]


def winner_case(case: str, n: int, seed: int = 0):
    """K4's inputs ``(path_id int32 (n,), num_paths)`` for ``case`` of
    :data:`WINNER_CASES` at ``n`` rows (a multiple of 8), pads (-1) at the
    end as ``winner_mask_device`` pads a stream to a power of two:

    * ``config5``: bench config 5's shape: 20 actions a commit over 50,000
      path names of which each version's names are new (``-{v}``), so most
      ids appear once, a few twice, ids in order of first appearance;
    * ``config6``: config 6's log: a million distinct adds, then tails that
      remove and re-add (each id once or twice, in order of first appearance);
    * ``random``: uniform ids over n / 10 paths, 1/64 pads;
    * ``one-path``: every row the same id of n / 4 paths;
    * ``zipf``: zipf-skewed ids over n / 4 paths (a few hot ids own much of
      the stream);
    * ``num-paths-1``: ids 0 and pads only, ``num_paths`` 1;
    * ``all-pad``: no real row;
    * ``no-pad``: every row a real id.
    """
    rng = np.random.RandomState(seed + n)
    if case == "config5":
        num_paths = max(n // 2, 1)
        first = np.arange(n, dtype=np.int64) // 2
        again = rng.rand(n) < 0.1
        pid = np.where(again, rng.randint(0, np.maximum(first, 1)), first)
        pid = np.minimum(pid, num_paths - 1)
    elif case == "config6":
        base = max(n - n // 32, 1)
        num_paths = base + n // 64
        tail = n - base
        pid = np.concatenate([np.arange(base), rng.randint(0, num_paths, tail)])
    elif case == "random":
        num_paths = max(n // 10, 1)
        pid = rng.randint(0, num_paths, n)
        pid[-(n // 64):] = -1 if n >= 64 else pid[-(n // 64):]
    elif case == "one-path":
        num_paths = max(n // 4, 1)
        pid = np.full(n, num_paths - 1)
    elif case == "zipf":
        num_paths = max(n // 4, 1)
        probs = 1.0 / np.arange(1, num_paths + 1, dtype=np.float64)
        pid = rng.choice(num_paths, n, p=probs / probs.sum())
    elif case == "num-paths-1":
        num_paths = 1
        pid = np.where(rng.rand(n) < 0.3, -1, 0)
    elif case == "all-pad":
        num_paths = 5
        pid = np.full(n, -1)
    elif case == "no-pad":
        num_paths = max(n // 3, 1)
        pid = rng.randint(0, num_paths, n)
    else:
        raise KeyError(case)
    pid = pid.astype(np.int32)
    if case not in ("random", "all-pad", "no-pad") and n >= 16:
        pid[-(n // 16):] = -1
    return pid, int(num_paths)


def reference_winner(path_id: np.ndarray) -> np.ndarray:
    """K4's contract in numpy: row i wins when its id is >= 0 and no later
    row has it; packed big-endian, bit 7 - j of byte b is row 8b + j."""
    n = len(path_id)
    win = np.zeros(n, bool)
    valid = np.nonzero(path_id >= 0)[0]
    if len(valid):
        rev = valid[::-1]
        _, first = np.unique(path_id[rev], return_index=True)
        win[rev[first]] = True
    return np.packbits(win)


def _store_sales_bytes(rows: int):
    """Bench config 2's store_sales columns (``bench.py:168-181``, seed 7)
    as (name, PLAIN int64 bytes) and (name, BYTE_STREAM_SPLIT float64
    bytes)."""
    rng = np.random.RandomState(7)
    ints = {"ss_item_sk": rng.permutation(rows * 2)[:rows],
            "ss_customer_sk": rng.randint(0, 1_000_000, rows),
            "ss_sold_date_sk": rng.randint(2450000, 2452000, rows),
            "ss_store_sk": rng.randint(0, 500, rows),
            "ss_quantity": rng.randint(1, 100, rows)}
    floats = {"ss_sales_price": rng.rand(rows) * 100,
              "ss_ext_discount_amt": rng.rand(rows) * 10,
              "ss_net_paid": rng.rand(rows) * 90}
    plain = [(k, v.astype("<i8").tobytes()) for k, v in ints.items()]
    bss = [(k, np.ascontiguousarray(v.astype("<f8").view(np.uint8).reshape(-1, 8).T).tobytes())
           for k, v in floats.items()]
    return plain, bss


def codec_pages(big: bool = True):
    rng = np.random.RandomState(19)
    rows = 32_768 if big else 8_192
    plain, bss = _store_sales_bytes(rows)
    mix = b"".join(b for _, b in plain + bss)
    pages = [("empty", b""), ("one", b"\x07"),
             ("frag-1", rng.randint(0, 4, 65535).astype(np.uint8).tobytes()),
             ("frag", mix[:65536]), ("frag+1", mix[65536:2 * 65536 + 1]),
             ("short-period", b"abcab" * 20_000), ("random", rng.bytes(100_000)),
             ("zeros", bytes(200_000))]
    pages += [(f"literal-{n}", rng.bytes(n)) for n in (60, 61, 62, 63, 64, 256, 65536)]
    pages += [(f"plain-{k}", b) for k, b in plain] + [(f"bss-{k}", b) for k, b in bss]
    for name, size in (("1mib", 1 << 20), ("8mib", 8 << 20)) if big else (("256kib", 1 << 18),):
        reps = -(-size // len(mix))
        pages.append((name, (mix * reps)[:size] if reps > 1 else mix[:size]))
    return pages


def codec_malformed():
    lit = bytes([3 << 2]) + b"abcd"  # a literal of 4 bytes
    good = (bytes([100, (25 - 1) << 2]) + b"x" * 25      # 100 bytes: a literal of 25,
            + bytes([2 | (63 << 2), 25, 0, 2 | (10 << 2), 25, 0]))  # copies of 64 and 11
    return [
        ("truncated", good[:-10], 100),
        ("offset-0", bytes([8]) + lit + bytes([2 | (3 << 2), 0, 0]), 8),
        ("before-page", bytes([8]) + lit + bytes([2 | (3 << 2), 5, 0]), 8),
        ("preamble", good, 99),
        ("overflow", bytes([8]) + lit + bytes([2 | (7 << 2), 4, 0]), 8),
    ]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if not n:
            return bytes(out + bytes([b]))
        out.append(b | 0x80)


class _Stream:
    """A raw Snappy body built element by element, with the bytes it decodes
    to (``out``); ``body(size)`` puts the preamble in front."""

    def __init__(self):
        self.elems = []
        self.out = bytearray()

    def literal(self, data: bytes, nb: int = 0):
        """A literal; ``nb`` length bytes (1-4), or the length in the tag."""
        n = len(data) - 1
        if nb == 0:
            assert n < 60
            self.elems.append(bytes([n << 2]))
        else:
            self.elems.append(bytes([(59 + nb) << 2]) + n.to_bytes(nb, "little"))
        self.elems.append(bytes(data))
        self.out += data

    def copy(self, kind: int, offset: int, length: int):
        """A copy with a 1-, 2- or 4-byte offset (``kind`` 1, 2 or 4)."""
        if kind == 1:
            assert 4 <= length <= 11 and offset < 2048
            self.elems.append(bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF]))
        else:
            assert 1 <= length <= 64
            self.elems.append(bytes([(2 if kind == 2 else 3) | ((length - 1) << 2)])
                              + offset.to_bytes(kind, "little"))
        for _ in range(length):  # byte by byte: an overlapping copy repeats its pattern
            self.out.append(self.out[-offset] if 0 < offset <= len(self.out) else 0)

    def raw(self, data: bytes):
        """Bytes that are no element (a fault)."""
        self.elems.append(bytes(data))

    def body(self, size=None) -> bytes:
        return _varint(len(self.out) if size is None else size) + b"".join(self.elems)


def codec_streams():
    rng = np.random.RandomState(23)
    out = []
    st = _Stream()  # copy-1, copy-2 and copy-4 tags
    st.literal(rng.bytes(64), 1)
    for i in range(3000):
        kind = (1, 2, 4)[i % 3]
        if kind == 1:
            st.copy(1, int(rng.randint(1, min(2048, len(st.out) + 1))), int(rng.randint(4, 12)))
        else:
            reach = min(len(st.out), 65_535 if kind == 2 else len(st.out))
            st.copy(kind, int(rng.randint(1, reach + 1)), int(rng.randint(1, 65)))
        if i % 7 == 0:
            st.literal(rng.bytes(int(rng.randint(1, 20))))
    out.append(("copy-tags", st.body(), bytes(st.out)))
    st = _Stream()  # 2 MiB, copy-4 offsets past 64 KiB
    st.literal(rng.bytes(100_000), 3)
    size = 2 << 20
    while len(st.out) + 64 <= size:
        st.copy(4, int(rng.randint(65_537, len(st.out) + 1)), 64)
        if rng.rand() < 0.05:
            st.copy(2, int(rng.randint(1, 65_536)), int(rng.randint(1, 65)))
    st.literal(rng.bytes(size - len(st.out)))
    out.append(("copy4-far", st.body(), bytes(st.out)))
    st = _Stream()  # every offset 1-63 at every length 4-64
    st.literal(rng.bytes(64), 1)
    for d in range(1, 64):
        for n in range(4, 65):
            st.copy(1 if n <= 11 and (d + n) % 2 else (2 if d % 3 else 4), d, n)
    out.append(("overlap", st.body(), bytes(st.out)))
    st = _Stream()  # literals of 1, 2, 3 and 4 length bytes, one over 64 KiB
    for nb, n in ((1, 61), (1, 256), (2, 257), (2, 65_536), (3, 70_000), (4, 100),
                  (4, 100_000), (0, 1), (0, 60)):
        st.literal(rng.bytes(n), nb)
        st.copy(2, int(rng.randint(1, min(65_536, len(st.out) + 1))), 40)
    out.append(("literal-lengths", st.body(), bytes(st.out)))
    st = _Stream()  # one long run
    st.literal(b"\x2a")
    while len(st.out) < 1 << 20:
        st.copy(2, 1, min(64, (1 << 20) - len(st.out)))
    out.append(("one-run", st.body(), bytes(st.out)))
    return out


def _good_prefix(st: _Stream, rng, elements: int):
    st.literal(rng.bytes(16))
    while len(st.elems) < elements:
        if rng.rand() < 0.3:
            st.literal(rng.bytes(int(rng.randint(1, 8))))
        else:
            st.copy(1, int(rng.randint(1, min(2048, len(st.out) + 1))), int(rng.randint(4, 12)))


def codec_faults():
    rng = np.random.RandomState(29)
    out = []

    def faulty(name, fault, err, elements=40, size_delta=0, tail=True):
        st = _Stream()
        _good_prefix(st, rng, elements)
        fault(st)
        if tail:  # good elements after the fault: none may be written
            for _ in range(50):
                st.copy(1, 1, 11)
        out.append((name, st.body(len(st.out) + size_delta), len(st.out) + size_delta, err))

    faulty("mid-offset-0", lambda st: st.raw(bytes([2 | (7 << 2), 0, 0])), 4)
    faulty("mid-before-page", lambda st: st.raw(bytes([2 | (7 << 2)]) + (len(st.out) + 1)
                                                 .to_bytes(2, "little")), 4)
    faulty("mid-copy4-before", lambda st: st.raw(bytes([3 | (7 << 2)]) + (1 << 31)
                                                  .to_bytes(4, "little")), 4)
    # the size stops 20 bytes into the tail: its first copies fit, then one passes it
    faulty("mid-overflow", lambda st: None, 5, size_delta=-(50 * 11 - 20))
    faulty("mid-literal-past-input", lambda st: st.raw(bytes([59 << 2]) + b"abc"), 3,
           tail=False)
    faulty("mid-tag-past-input", lambda st: st.raw(bytes([3 | (3 << 2), 1, 0])), 3, tail=False)
    faulty("deep-offset", lambda st: st.raw(bytes([2 | (7 << 2), 0, 0])), 4, elements=5000)
    faulty("deep-overflow", lambda st: None, 5, elements=5000, size_delta=-1)
    faulty("short", lambda st: None, 6, elements=300, size_delta=7)
    return out
