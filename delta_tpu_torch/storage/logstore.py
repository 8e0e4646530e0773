"""The local LogStore (the port's own copy of ``delta_tpu.storage.logstore``'s
POSIX store; the object-store and in-memory stores wait for a later slice).

Contract: ``write(overwrite=False)`` is an atomic put-if-absent — the file is
staged under a unique temp name in the same directory and published with
``os.link``, which fails with ``FileExistsError`` when the name exists (the
optimistic-concurrency commit-conflict signal). ``list_from`` lists the
parent directory's names ``>=`` the given name, sorted.
"""
from __future__ import annotations

import os
import uuid
from dataclasses import dataclass
from typing import Iterable, Iterator, List

__all__ = ["FileStatus", "LocalLogStore"]


@dataclass(frozen=True)
class FileStatus:
    path: str
    size: int
    modification_time: int  # millis since epoch

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]


def _strip_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


class LocalLogStore:
    """POSIX filesystem store."""

    def read(self, path: str) -> List[str]:
        """The whole file as lines, without their newlines."""
        with open(_strip_scheme(path), "r", encoding="utf-8", newline="") as f:
            return [line.rstrip("\r\n") for line in f]

    def read_bytes(self, path: str) -> bytes:
        with open(_strip_scheme(path), "rb") as f:
            return f.read()

    def write(self, path: str, lines: Iterable[str], overwrite: bool = False) -> None:
        self.write_bytes(path, "".join(line + "\n" for line in lines).encode("utf-8"),
                         overwrite)

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        """Stage under a unique temp name, then publish: replaced where
        ``overwrite``, else created only if absent (``FileExistsError``)."""
        p = _strip_scheme(path)
        parent = os.path.dirname(p)
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(parent, f".{os.path.basename(p)}.{uuid.uuid4().hex}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            if overwrite:
                os.replace(tmp, p)
            else:
                os.link(tmp, p)  # atomic create-if-absent
        finally:
            try:
                os.unlink(tmp)  # no-op after a successful replace
            except OSError:
                pass

    def exists(self, path: str) -> bool:
        return os.path.exists(_strip_scheme(path))

    def delete(self, path: str) -> bool:
        try:
            os.unlink(_strip_scheme(path))
            return True
        except FileNotFoundError:
            return False

    def list_from(self, path: str) -> Iterator[FileStatus]:
        p = _strip_scheme(path)
        parent = os.path.dirname(p)
        start = os.path.basename(p)
        if not os.path.isdir(parent):
            raise FileNotFoundError(parent)
        for n in sorted(n for n in os.listdir(parent) if n >= start):
            full = os.path.join(parent, n)
            try:
                st = os.stat(full)
            except FileNotFoundError:
                continue
            yield FileStatus(full, st.st_size, int(st.st_mtime * 1000))
