"""External storage abstraction for backup/restore/import artifacts
(ref: br/pkg/storage/storage.go — the S3/GCS/Azure/local seam every BR
component writes through).

Backends here:
- ``LocalStorage`` — a directory on this host (``file://`` or a bare path);
- ``MemStorage`` — an in-process named bucket (``memory://bucket/prefix``),
  the hermetic stand-in for an object store: tests exercise the exact
  ExternalStorage call pattern a cloud backend would see (no egress exists
  in this environment, so real S3/GCS clients are deliberately absent —
  ``open_storage`` names the seam where they plug in).

Every consumer (BACKUP/RESTORE) takes a URL and calls only this interface,
so adding a cloud backend is one class, not a sweep through the tools.
"""

from __future__ import annotations

import os
import threading


class ExternalStorage:
    """The BR storage contract: flat named files under one prefix."""

    def write_file(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def read_file(self, name: str) -> bytes:
        raise NotImplementedError

    def list_files(self) -> list[str]:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        return name in self.list_files()

    def create(self, name: str):
        """Streaming writer context manager (ref: br/pkg/storage Create):
        backends with real file handles stream; others buffer and commit on
        exit. Keeps BACKUP's memory at one row, not one table."""
        store = self

        class _Buffered:
            def __enter__(self):
                self._buf = bytearray()
                return self

            def write(self, data: bytes) -> None:
                self._buf += data

            def __exit__(self, et, ev, tb):
                if et is None:
                    store.write_file(name, bytes(self._buf))
                return False

        return _Buffered()


class LocalStorage(ExternalStorage):
    def __init__(self, root: str):
        self.root = root

    def write_file(self, name: str, data: bytes) -> None:
        # mkdir on WRITE only: opening a storage URL to read a backup must
        # not create directories as a side effect (read-only mounts, typos)
        os.makedirs(self.root, exist_ok=True)
        with open(os.path.join(self.root, name), "wb") as f:
            f.write(data)

    def read_file(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def list_files(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []  # fresh destination: nothing written yet, not an error
        return sorted(
            f for f in os.listdir(self.root) if os.path.isfile(os.path.join(self.root, f))
        )

    def exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self.root, name))

    def create(self, name: str):
        os.makedirs(self.root, exist_ok=True)
        return open(os.path.join(self.root, name), "wb")


# process-wide named buckets: memory://bucket/prefix
_MEM_BUCKETS: dict[str, dict[str, bytes]] = {}
_MEM_MU = threading.Lock()


class MemStorage(ExternalStorage):
    def __init__(self, bucket: str, prefix: str = ""):
        with _MEM_MU:
            self._files = _MEM_BUCKETS.setdefault(bucket, {})
        self.prefix = prefix.strip("/")

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def write_file(self, name: str, data: bytes) -> None:
        with _MEM_MU:
            self._files[self._key(name)] = bytes(data)

    def read_file(self, name: str) -> bytes:
        with _MEM_MU:
            got = self._files.get(self._key(name))
        if got is None:
            raise FileNotFoundError(self._key(name))
        return got

    def list_files(self) -> list[str]:
        p = self.prefix + "/" if self.prefix else ""
        with _MEM_MU:
            return sorted(k[len(p):] for k in self._files if k.startswith(p))


def open_storage(url: str) -> ExternalStorage:
    """URL → backend. ``file:///path`` or a bare path → LocalStorage;
    ``memory://bucket[/prefix]`` → MemStorage. Cloud schemes raise with the
    seam named (this environment has no egress; a deployment registers its
    client here, exactly like br/pkg/storage's scheme dispatch)."""
    if url.startswith("file://"):
        return LocalStorage(url[len("file://"):])
    if url.startswith("memory://"):
        rest = url[len("memory://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError("memory:// URL needs a bucket name")
        return MemStorage(bucket, prefix)
    for scheme in ("s3://", "gs://", "gcs://", "azure://", "azblob://"):
        if url.startswith(scheme):
            raise ValueError(
                f"storage scheme {scheme!r} needs a cloud client registered in "
                "tidb_tpu.tools.storage.open_storage (no egress in this build); "
                "use file:// or memory:// here"
            )
    return LocalStorage(url)
