"""Pluggable external store behind the head's WAL + snapshots.

Counterpart of the reference's GCS store-client layer (reference:
src/ray/gcs/store_client/store_client.h — interface;
redis_store_client.h:111 — the external store that lets a FRESH head
process, possibly on another node, restore the whole cluster state;
in_memory_store_client.h:34 — the default non-HA backend).

Here the store holds two kinds of objects, addressed by flat names:
  - "snapshot":       one atomic blob (the compacted table dump)
  - "wal.<N>":        append-only op-log segments

``FileStoreClient`` roots those names in a directory — put it on shared
storage (NFS/GCS-fuse/…) and any machine can adopt the head role. The
interface is deliberately small so a Redis/ETCD client can slot in
(APPEND for segments, SET for the snapshot) without touching the
persistence logic.
"""

from __future__ import annotations

import abc
import os
import tempfile
from typing import BinaryIO


class StoreClient(abc.ABC):
    """Minimal durable object store for head state."""

    url: str = ""

    @abc.abstractmethod
    def read(self, name: str) -> "bytes | None":
        """Full contents, or None when absent."""

    @abc.abstractmethod
    def write_atomic(self, name: str, blob: bytes) -> None:
        """Replace contents atomically (readers never see a torn blob)."""

    @abc.abstractmethod
    def open_append(self, name: str) -> BinaryIO:
        """Append handle; each .write+.flush must survive process death."""

    @abc.abstractmethod
    def rewrite(self, name: str, blob: bytes) -> None:
        """Truncate-and-replace (WAL torn-tail repair)."""

    @abc.abstractmethod
    def list(self, prefix: str) -> "list[str]":
        """Names with the given prefix."""

    @abc.abstractmethod
    def delete(self, name: str) -> None:
        """Remove (missing is fine)."""


class FileStoreClient(StoreClient):
    """Directory-rooted store. ``legacy_base`` keeps the historical
    on-disk layout (``<base>`` = snapshot, ``<base>.wal.N`` = segments)
    so snapshots written by older heads keep restoring."""

    def __init__(self, root: str, legacy_base: "str | None" = None):
        self.root = os.path.abspath(root)
        self._legacy = legacy_base
        os.makedirs(self.root, exist_ok=True)
        self.url = f"file://{self.root}"
        if legacy_base:
            self.url = f"file://{os.path.abspath(legacy_base)}"

    def _path(self, name: str) -> str:
        if self._legacy:
            base = os.path.abspath(self._legacy)
            return base if name == "snapshot" else f"{base}.{name}"
        return os.path.join(self.root, name)

    def read(self, name: str) -> "bytes | None":
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def write_atomic(self, name: str, blob: bytes) -> None:
        path = self._path(name)
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".gcs-store-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def open_append(self, name: str) -> BinaryIO:
        path = self._path(name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, "ab")

    def rewrite(self, name: str, blob: bytes) -> None:
        with open(self._path(name), "r+b") as f:
            f.write(blob)
            f.truncate(len(blob))

    def list(self, prefix: str) -> "list[str]":
        import glob
        import re

        if self._legacy:
            base = os.path.abspath(self._legacy)
            names = []
            for p in glob.glob(glob.escape(base) + ".*"):
                name = os.path.basename(p)[len(os.path.basename(base)) + 1:]
                if name.startswith(prefix) and re.fullmatch(
                        r"wal\.\d+", name):
                    names.append(name)
            if "snapshot".startswith(prefix) and os.path.exists(base):
                names.append("snapshot")
            return sorted(names)
        try:
            return sorted(n for n in os.listdir(self.root)
                          if n.startswith(prefix))
        except FileNotFoundError:
            return []

    def delete(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except OSError:
            pass


def store_from_uri(uri: str) -> StoreClient:
    """"file:///shared/dir" or a bare directory path -> FileStoreClient.
    (A redis:// scheme would return a RedisStoreClient here.)"""
    if uri.startswith("file://"):
        return FileStoreClient(uri[len("file://"):])
    if "://" in uri:
        raise ValueError(
            f"unsupported external store scheme in {uri!r} "
            f"(supported: file://)")
    return FileStoreClient(uri)
