"""Raw Snappy streams that the port's compressor never writes, held against
the port's plain decoder (``exec/snappy.decompress``) on the CPU.

The page codec's kernel must decode every valid raw Snappy body, not only
the port's own: a table the JAX package writes (Arrow's snappy) or Spark
writes reaches it. ``tests/torch_kernel_cases.py`` builds the streams
element by element (``codec_streams``: copy-1, -2 and -4 tags, copy-4
offsets past 64 KiB, overlapping copies of every offset 1-63, literals of
1-4 length bytes, one long run) and the faults after a page's 33rd element
(``codec_faults``); ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold
the kernel to the same bytes and error words on the card. Here the plain
decoder, which the CPU path runs, is held to them, and to Google's
compressor's bodies (``pyarrow``'s snappy) of the codec's pages.

Tolerance: exact bytes.
"""
import functools

import pyarrow as pa
import pytest

from delta_tpu_torch.exec import snappy
import torch_kernel_cases
from torch_kernel_cases import CODEC_FAULTS, CODEC_STREAMS, codec_faults, codec_pages

#: built once a process (the 1-2 MiB streams take seconds in Python)
codec_streams = functools.lru_cache(maxsize=None)(torch_kernel_cases.codec_streams)


def _stream(name):
    return [s for s in codec_streams() if s[0] == name][0]


@pytest.mark.parametrize("name", CODEC_STREAMS)
def test_plain_decoder_reads_the_stream(name):
    _, body, want = _stream(name)
    assert snappy.decompress(body) == want
    assert snappy.decompress_pages([body], [len(want)], device="cpu") == [want]


def test_streams_cover_what_they_name():
    """Each stream holds the tags its name promises (a check of the
    builder, so a change to it cannot drop a case unseen)."""
    streams = {n: (b, w) for n, b, w in codec_streams()}

    def tags(body):  # (kind, extra length bytes or offset, length) of every element
        pos = 0
        while body[pos] & 0x80:
            pos += 1
        pos += 1
        out = []
        while pos < len(body):
            t = body[pos]
            kind = t & 3
            if kind == 0:
                ln, nb = t >> 2, 0
                if ln >= 60:
                    nb = ln - 59
                    ln = int.from_bytes(body[pos + 1:pos + 1 + nb], "little")
                out.append((0, nb, ln + 1))
                pos += 1 + nb + ln + 1
            else:
                extra = (0, 1, 2, 4)[kind]
                ln = 4 + ((t >> 2) & 7) if kind == 1 else (t >> 2) + 1
                off = (((t >> 5) << 8) | body[pos + 1]) if kind == 1 else int.from_bytes(
                    body[pos + 1:pos + 1 + extra], "little")
                out.append((kind, off, ln))
                pos += 1 + extra
        return out

    copy_tags = tags(streams["copy-tags"][0])
    assert {k for k, _, _ in copy_tags} == {0, 1, 2, 3}
    assert any(k in (2, 3) and ln < 4 for k, _, ln in copy_tags)
    far = tags(streams["copy4-far"][0])
    assert len(streams["copy4-far"][1]) == 2 << 20
    assert any(k == 3 and off > 65536 for k, off, _ in far)
    overlap = {(off, ln) for k, off, ln in tags(streams["overlap"][0]) if k}
    assert all((d, n) in overlap for d in range(1, 64) for n in range(4, 65))
    lits = [(nb, ln) for k, nb, ln in tags(streams["literal-lengths"][0]) if k == 0]
    assert {nb for nb, _ in lits} == {0, 1, 2, 3, 4} and max(ln for _, ln in lits) > 65536
    assert set(streams["one-run"][1]) == {0x2a} and len(streams["one-run"][1]) == 1 << 20


@pytest.mark.parametrize("name", CODEC_FAULTS)
def test_plain_decoder_refuses_the_fault(name):
    _, body, size, _ = [f for f in codec_faults() if f[0] == name][0]
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(body)
    with pytest.raises(snappy.SnappyError, match="file.parquet: column 'x'"):
        snappy.decompress_pages([snappy.compress(b"ok" * 40), body], [80, size], device="cpu",
                                labels=["a", "file.parquet: column 'x'"])


def _google_pages():
    pages = [(n, p) for n, p in codec_pages(big=False)]
    pages += [(n, w) for n, _, w in codec_streams() if len(w) <= 1 << 20]
    return pages


@pytest.mark.parametrize("name", [n for n, _ in _google_pages()])
def test_plain_decoder_reads_googles_snappy(name):
    """Google's compressor (Arrow's snappy) emits other parses than the
    port's: copy-2 tags where the port's are copy-1, literals split at its
    own bounds; the plain decoder reads them all."""
    page = dict(_google_pages())[name]
    body = pa.compress(page, codec="snappy", asbytes=True)
    assert snappy.decompress(body) == page
    assert pa.decompress(snappy.compress(page), decompressed_size=len(page), codec="snappy",
                         asbytes=True) == page
