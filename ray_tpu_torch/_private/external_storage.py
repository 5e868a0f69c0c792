"""External storage backends for object spilling.

Counterpart of the reference's external storage layer
(reference: python/ray/_private/external_storage.py — ExternalStorage ABC
:72, FileSystemStorage :272, ExternalStorageSmartOpenImpl :324 for
S3/GCS-style URIs; selected by the RAY_object_spilling_config JSON).
The head's shm store spills LRU-sealed objects through one of these when
the arena fills; restore pulls bytes back (or serves them straight from
storage for one-shot reads).
"""

from __future__ import annotations

import os
from typing import Any


class ExternalStorage:
    """Spill target ABC. URLs are opaque strings owned by the backend."""

    def spill(self, object_id: str, data: memoryview) -> str:
        raise NotImplementedError

    def restore(self, url: str) -> bytes:
        raise NotImplementedError

    def delete(self, url: str) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        """Best-effort removal of everything this session spilled."""


class FileSystemStorage(ExternalStorage):
    """Local-disk spilling (reference: FileSystemStorage :272)."""

    def __init__(self, directory_path: str):
        self.directory_path = directory_path
        os.makedirs(directory_path, exist_ok=True)
        self._spilled: set[str] = set()

    def spill(self, object_id: str, data: memoryview) -> str:
        path = os.path.join(self.directory_path, object_id)
        with open(path, "wb") as f:
            f.write(data)
        self._spilled.add(path)
        return path

    def restore(self, url: str) -> bytes:
        with open(url, "rb") as f:
            return f.read()

    def delete(self, url: str) -> None:
        self._spilled.discard(url)
        try:
            os.unlink(url)
        except OSError:
            pass

    def destroy(self) -> None:
        # Only THIS session's spill files: the directory may be shared
        # (a user-configured path serving several clusters).
        for path in list(self._spilled):
            self.delete(path)


class SmartOpenStorage(ExternalStorage):
    """URI spilling via smart_open (reference:
    ExternalStorageSmartOpenImpl :324 — S3/GCS/azure URIs). Gated on the
    smart_open package."""

    def __init__(self, uri: str, **open_kwargs: Any):
        try:
            import smart_open  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "object spilling to URIs requires the 'smart_open' package "
                "(pip install smart_open[s3]); use the filesystem backend "
                "otherwise"
            ) from e
        self.uri = uri.rstrip("/")
        self.open_kwargs = open_kwargs

    def _url(self, object_id: str) -> str:
        return f"{self.uri}/{object_id}"

    def spill(self, object_id: str, data: memoryview) -> str:
        import smart_open

        url = self._url(object_id)
        with smart_open.open(url, "wb", **self.open_kwargs) as f:
            f.write(bytes(data))
        return url

    def restore(self, url: str) -> bytes:
        import smart_open

        with smart_open.open(url, "rb", **self.open_kwargs) as f:
            return f.read()

    def delete(self, url: str) -> None:
        try:
            import smart_open  # noqa: F401

            # smart_open has no unified delete; filesystem-path URIs are
            # handled directly, remote URIs are left to bucket lifecycle
            # rules (same stance as the reference).
            if os.path.exists(url):
                os.unlink(url)
        except Exception:
            pass


def setup_external_storage(config: "dict | None",
                           default_dir: str) -> ExternalStorage:
    """Build the configured backend (reference: external_storage.py
    setup_external_storage reading the object_spilling_config JSON):

        {"type": "filesystem", "params": {"directory_path": "/mnt/spill"}}
        {"type": "smart_open", "params": {"uri": "s3://bucket/spill"}}
    """
    if not config:
        return FileSystemStorage(default_dir)
    kind = config.get("type", "filesystem")
    params = dict(config.get("params", {}))
    if kind == "filesystem":
        params.setdefault("directory_path", default_dir)
        return FileSystemStorage(**params)
    if kind == "smart_open":
        return SmartOpenStorage(**params)
    raise ValueError(f"unknown object spilling backend {kind!r}")
