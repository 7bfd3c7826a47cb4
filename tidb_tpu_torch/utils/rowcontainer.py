"""Disk-spillable chunk container (ref: util/chunk/row_container.go +
chunk_in_disk.go): executors accumulate result chunks here; when the query's
memory tracker trips its quota, the container's registered spill action
serializes every held chunk to a temp file with the wire codec and frees the
host memory. Readers stream the chunks back transparently.
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
from typing import Iterator, Optional

from tidb_tpu_torch.utils.chunk import Chunk, decode_chunk, encode_chunk
from tidb_tpu_torch.utils.memory import Tracker, chunk_bytes


class RowContainer:
    def __init__(self, tracker: Optional[Tracker] = None, label: str = "rowcontainer"):
        self.tracker = tracker
        self.label = label
        # spill actions fire from WHATEVER thread trips the shared tracker's
        # quota — all state transitions are serialized on this lock
        self._mu = threading.RLock()
        self._chunks: list[Chunk] = []
        self._mem_bytes = 0
        self._file = None  # spill file (append-mode)
        self._n_disk_chunks = 0
        self.spilled = False
        self._closed = False
        # original per-column dictionary objects: decode creates fresh
        # Dictionary instances, but Column.concat requires identity; codes
        # stay valid because dictionaries are append-only
        self._col_dicts: list = []
        if tracker is not None:
            tracker.register_spill(self.spill)

    def add(self, chunk: Chunk) -> None:
        if not len(chunk):
            return
        with self._mu:
            if self._closed:
                return
            if not self._col_dicts:
                self._col_dicts = [getattr(c, "dictionary", None) for c in chunk.columns]
            if self.spilled:
                self._write(chunk)
                return
            self._chunks.append(chunk)
            n = chunk_bytes(chunk)
            self._mem_bytes += n
        if self.tracker is not None:
            self.tracker.consume(n)  # may fire spill (incl. this container's)

    def spill(self) -> int:
        """Move all in-memory chunks to disk; returns bytes freed."""
        with self._mu:
            if self._closed or (self.spilled and not self._chunks):
                return 0
            if self._file is None:
                fd, path = tempfile.mkstemp(prefix="tidbtpu-spill-")
                os.close(fd)
                self._file = open(path, "w+b")
                os.unlink(path)  # anonymous: space reclaims on close
            for ch in self._chunks:
                self._write(ch)
            self._chunks.clear()
            freed = self._mem_bytes
            self._mem_bytes = 0
            self.spilled = True
        if self.tracker is not None and freed:
            self.tracker.release(freed)
        return freed

    def _write(self, chunk: Chunk) -> None:
        buf = encode_chunk(chunk)
        self._file.write(struct.pack("<Q", len(buf)))
        self._file.write(buf)
        self._n_disk_chunks += 1

    def chunks(self) -> Iterator[Chunk]:
        with self._mu:
            out: list[Chunk] = []
            if self._file is not None:
                self._file.seek(0)
                for _ in range(self._n_disk_chunks):
                    (ln,) = struct.unpack("<Q", self._file.read(8))
                    ch = decode_chunk(self._file.read(ln))
                    for col, dic in zip(ch.columns, self._col_dicts):
                        if dic is not None:
                            col.dictionary = dic
                    out.append(ch)
                self._file.seek(0, 2)  # back to append position
            out.extend(self._chunks)
        yield from out

    def to_chunk(self, schema_cols=None) -> Optional[Chunk]:
        """Concatenate everything (None when empty)."""
        all_chunks = list(self.chunks())
        if not all_chunks:
            return None
        return Chunk.concat(all_chunks) if len(all_chunks) > 1 else all_chunks[0]

    def close(self) -> None:
        with self._mu:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None
            freed, self._mem_bytes = self._mem_bytes, 0
            self._chunks.clear()
        if self.tracker is not None:
            self.tracker.unregister_spill(self.spill)
            if freed:
                self.tracker.release(freed)
