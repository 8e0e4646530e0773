"""The page codec on the card: raw Snappy compression (``snappy_compress``)
and decompression (``snappy_decompress``) of a batch of Parquet pages
(``csrc/page_codec.cu``).

Replaces no kernel of the JAX package, which compresses its pages on the
host in Arrow's C++; the port's host codec is Python (``exec/snappy``), so
the work goes to the card. The plain versions are ``exec/snappy``'s
``compress`` and ``decompress``, page by page.

:func:`compress` and :func:`decompress` take a batch: the pages go up in
one pinned upload (a table of offsets, then the bytes), one kernel launch
works on all of them, and one download brings back what the host needs.
The compressor's fragments come back from their fixed slots and the host
writes each page's varint preamble and joins its fragments; the
decompressor's output comes back with one error word a page, and a page
whose word is set raises :class:`~delta_tpu_torch.exec.snappy.SnappyError`
naming its label (the file and the column). The pinned staging buffers are
kept a device and grown up to ``STAGING_CAP``, so a small batch (a small
file's pages) pays no allocation; a batch that needs more goes in chunks of
at most ``STAGING_CAP`` (a launch set each), and a page that needs more
alone stages in buffers freed after its call. Each card has its own lock.
:func:`compress_launch` and :func:`decompress_launch` are the launches
alone, on buffers already on the card.

:data:`device_ms` sums each kernel's device milliseconds over the launch
sets of :func:`compress` and :func:`decompress`: a pair of CUDA events
around each launch, read after the synchronise the launch set makes anyway.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch.exec.snappy import FRAGMENT, SnappyError
from delta_tpu_torch.ops import native

__all__ = ["compress", "decompress", "compress_launch", "decompress_launch", "FRAG_CAP",
           "STAGING_CAP", "fragment_table", "ERRORS", "device_ms"]

#: a fragment's output slot: Snappy's bound 32 + n + n/6 at n = 64 KiB, to 128
FRAG_CAP = 76544

#: the kernel's error words
ERRORS = {1: "a truncated or overlong length preamble",
          2: "a length preamble that disagrees with the page header",
          3: "a tag or a literal that runs past the input",
          4: "a copy whose offset is 0 or reaches before the page",
          5: "output past the page's uncompressed size",
          6: "input that ends before the page's uncompressed size"}

#: the most page-locked host memory a staging buffer keeps between calls,
#: and the most one launch set stages when its batch has more than one page
STAGING_CAP = 64 << 20

#: each kernel's device milliseconds, summed over the wrappers' launch sets
device_ms: Dict[str, float] = {"snappy_compress": 0.0, "snappy_decompress": 0.0}

_locks_guard = threading.Lock()
_locks: Dict[int, threading.Lock] = {}
_pinned: Dict[Tuple[str, int], torch.Tensor] = {}


def _lock(dev: torch.device) -> threading.Lock:
    """The lock of ``dev``'s staging buffers."""
    with _locks_guard:
        return _locks.setdefault(dev.index or 0, threading.Lock())


def _staging(role: str, dev: torch.device, nbytes: int) -> torch.Tensor:
    """A pinned host buffer of at least ``nbytes``: kept for the next call
    up to ``STAGING_CAP``, a buffer of its own (freed after the call) past
    it. The caller holds ``_lock(dev)``."""
    if nbytes > STAGING_CAP:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    key = (role, dev.index or 0)
    buf = _pinned.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(min(STAGING_CAP, max(1 << 20, 1 << (max(nbytes, 1) - 1).bit_length())),
                          dtype=torch.uint8, pin_memory=True)
        _pinned[key] = buf
    return buf


def _chunks(need: Sequence[int]) -> List[range]:
    """Consecutive pages grouped so that each group's staging (the sum of
    ``need``, each page's larger of its upload and download bytes) stays
    within ``STAGING_CAP``; a page that needs more is a group alone."""
    out, first, total = [], 0, 0
    for i, n in enumerate(need):
        if i > first and total + n > STAGING_CAP:
            out.append(range(first, i))
            first, total = i, 0
        total += n
    out.append(range(first, len(need)))
    return out


def _align(n: int) -> int:
    return (n + 15) & ~15


def fragment_table(sizes: Sequence[int]) -> Tuple[np.ndarray, List[range]]:
    """The ``(nfrag, 2)`` int64 table (offset in the concatenated pages,
    length) of the batch's 64 KiB fragments, and each page's fragments."""
    offs, lens, per_page = [], [], []
    base = 0
    for n in sizes:
        first = len(offs)
        for s in range(0, n, FRAGMENT):
            offs.append(base + s)
            lens.append(min(FRAGMENT, n - s))
        per_page.append(range(first, len(offs)))
        base += n
    table = np.empty((len(offs), 2), np.int64)
    table[:, 0] = offs
    table[:, 1] = lens
    return table, per_page


def compress_launch(src: torch.Tensor, frags: torch.Tensor, scratch: torch.Tensor,
                    sizes: torch.Tensor) -> None:
    """``snappy_compress`` on buffers on the card: ``src`` the pages'
    bytes (uint8), ``frags`` the ``(nfrag, 2)`` int64 table, ``scratch``
    ``nfrag * FRAG_CAP`` bytes, ``sizes`` ``(nfrag,)`` int32."""
    nfrag = frags.shape[0]
    if (scratch.numel() < nfrag * FRAG_CAP or sizes.numel() < nfrag
            or sizes.dtype != torch.int32 or frags.dtype != torch.int64):
        raise ValueError("snappy_compress: short scratch or sizes, or a wrong dtype")
    if nfrag:
        native.call("snappy_compress", src.device, src.data_ptr(), frags.data_ptr(), nfrag,
                    scratch.data_ptr(), sizes.data_ptr())
        native.launches["snappy_compress"] += 1


def decompress_launch(src: torch.Tensor, pages: torch.Tensor, out: torch.Tensor,
                      err: torch.Tensor) -> None:
    """``snappy_decompress`` on buffers on the card: ``pages`` the
    ``(npages, 4)`` int64 table (input offset and length in ``src``, output
    offset and length in ``out``), ``err`` ``(npages,)`` int32."""
    npages = pages.shape[0]
    if err.numel() < npages or err.dtype != torch.int32 or pages.dtype != torch.int64:
        raise ValueError("snappy_decompress: a short error buffer or a wrong dtype")
    if npages:
        native.call("snappy_decompress", src.device, src.data_ptr(), pages.data_ptr(), npages,
                    out.data_ptr(), err.data_ptr())
        native.launches["snappy_decompress"] += 1


def _timed(name: str, launch: Callable[[], None]) -> Callable[[], None]:
    """Run ``launch`` between two CUDA events; returns a function that adds
    the device time to ``device_ms[name]`` once the stream is synchronised."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()

    def add() -> None:
        device_ms[name] += start.elapsed_time(end)

    return add


def _put_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _fill(host: np.ndarray, at: int, chunks: Sequence) -> None:
    for c in chunks:
        n = len(c)
        if n:
            host[at:at + n] = np.frombuffer(c, np.uint8)
        at += n


def compress(pages: Sequence, dev: torch.device) -> List[bytes]:
    """Raw Snappy of each page, on the card ``dev``: one launch set a chunk
    of at most ``STAGING_CAP`` staged bytes (see :func:`_chunks`)."""
    sizes = [len(p) for p in pages]
    # a page's staging: its fragments' slots and size words down, which is
    # more than its bytes and table rows up
    need = [-(-n // FRAGMENT) * (FRAG_CAP + 16) for n in sizes]
    out: List[bytes] = []
    for grp in _chunks(need):
        out += _compress_chunk([pages[i] for i in grp], sizes[grp.start:grp.stop], dev)
    return out


def _compress_chunk(pages: Sequence, sizes: List[int], dev: torch.device) -> List[bytes]:
    table, per_page = fragment_table(sizes)
    nfrag = len(table)
    if not nfrag:  # empty pages: the preamble alone
        return [_put_varint(0)] * len(pages)
    t_bytes = _align(table.nbytes)
    up_bytes = t_bytes + sum(sizes)
    s_bytes = _align(4 * nfrag)
    down_bytes = s_bytes + nfrag * FRAG_CAP
    with _lock(dev):
        up = _staging("up", dev, up_bytes)
        host = up.numpy()
        host[:table.nbytes] = table.view(np.uint8).ravel()
        _fill(host, t_bytes, pages)
        d_up = torch.empty(up_bytes, dtype=torch.uint8, device=dev)
        d_up.copy_(up[:up_bytes], non_blocking=True)
        d_out = torch.empty(max(down_bytes, 16), dtype=torch.uint8, device=dev)
        timed = _timed("snappy_compress", lambda: compress_launch(
            d_up[t_bytes:], d_up[:table.nbytes].view(torch.int64).view(-1, 2),
            d_out[s_bytes:], d_out[:4 * nfrag].view(torch.int32)))
        down = _staging("down", dev, down_bytes)
        down[:down_bytes].copy_(d_out[:down_bytes], non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        timed()
        got = down.numpy()
        frag_sizes = got[:4 * nfrag].view(np.int32).tolist()
        out = []
        for n, frags in zip(sizes, per_page):
            parts = [_put_varint(n)]
            for f in frags:
                at = s_bytes + f * FRAG_CAP
                parts.append(got[at:at + frag_sizes[f]].tobytes())
            out.append(b"".join(parts))
    return out


def decompress(bodies: Sequence, sizes: Sequence[int], dev: torch.device,
               labels: Optional[Sequence[str]] = None) -> List[bytes]:
    """Each raw Snappy body decompressed on the card ``dev`` into
    ``sizes[i]`` bytes, one launch set a chunk of at most ``STAGING_CAP``
    staged bytes (see :func:`_chunks`); raises :class:`SnappyError` for the
    first page whose error word is set."""
    lens = [len(b) for b in bodies]
    if max(lens) >= 1 << 31 or max(sizes) >= 1 << 31:
        raise ValueError("snappy_decompress: a page of 2^31 bytes or more")
    out: List[bytes] = []
    # a page's staging: the larger of its body up and its bytes down, and
    # its table row (32 bytes) and error word (4)
    for grp in _chunks([max(a, int(b)) + 36 for a, b in zip(lens, sizes)]):
        out += _decompress_chunk(
            [bodies[i] for i in grp], lens[grp.start:grp.stop], sizes[grp.start:grp.stop], dev,
            None if labels is None else labels[grp.start:grp.stop], grp.start)
    return out


def _decompress_chunk(bodies: Sequence, lens: List[int], sizes: Sequence[int],
                      dev: torch.device, labels: Optional[Sequence[str]],
                      first: int) -> List[bytes]:
    npages = len(bodies)
    table = np.empty((npages, 4), np.int64)
    table[:, 1] = lens
    table[:, 3] = sizes
    table[:, 0] = np.cumsum(table[:, 1]) - table[:, 1]
    table[:, 2] = np.cumsum(table[:, 3]) - table[:, 3]
    t_bytes = _align(table.nbytes)
    up_bytes = t_bytes + sum(lens)
    e_bytes = _align(4 * npages)
    total = int(table[:, 3].sum())
    down_bytes = e_bytes + total
    with _lock(dev):
        up = _staging("up", dev, up_bytes)
        host = up.numpy()
        host[:table.nbytes] = table.view(np.uint8).ravel()
        _fill(host, t_bytes, bodies)
        d_up = torch.empty(up_bytes, dtype=torch.uint8, device=dev)
        d_up.copy_(up[:up_bytes], non_blocking=True)
        d_out = torch.empty(max(down_bytes, 16), dtype=torch.uint8, device=dev)
        timed = _timed("snappy_decompress", lambda: decompress_launch(
            d_up[t_bytes:], d_up[:table.nbytes].view(torch.int64).view(-1, 4),
            d_out[e_bytes:], d_out[:4 * npages].view(torch.int32)))
        down = _staging("down", dev, down_bytes)
        down[:down_bytes].copy_(d_out[:down_bytes], non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        timed()
        got = down.numpy()
        errs = got[:4 * npages].view(np.int32)
        bad = np.flatnonzero(errs)
        if len(bad):
            i = int(bad[0])
            label = labels[i] if labels is not None else f"page {first + i}"
            raise SnappyError(f"{label}: corrupt SNAPPY page: "
                              f"{ERRORS.get(int(errs[i]), f'error {int(errs[i])}')}")
        offs = (e_bytes + table[:, 2]).tolist()
        return [got[o:o + n].tobytes() for o, n in zip(offs, table[:, 3].tolist())]
