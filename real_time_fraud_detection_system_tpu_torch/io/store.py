"""Object-store abstraction — the port's own copy of the local half of
the JAX package's ``io/store.py``.

- :class:`LocalStore` — a filesystem-backed object store (what a mounted
  volume looks like), the backend of
  :class:`~.checkpoint.StoreCheckpointer` in the port;
- :func:`make_store` — a local path or ``file://`` URL →
  :class:`LocalStore`. ``s3://`` raises: the S3 client needs boto3, which
  the port does not depend on yet (ROADMAP A9).

Missing keys raise ``KeyError`` everywhere.
"""

from __future__ import annotations

import os
from typing import List


class LocalStore:
    """Filesystem object store rooted at a directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        root = os.path.normpath(self.root)
        p = os.path.normpath(os.path.join(root, key))
        if os.path.commonpath([root, p]) != root:
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def head(self, key: str) -> dict:
        """``{"etag", "size"}`` without the body (etag = mtime_ns)."""
        try:
            st = os.stat(self._path(key))
        except FileNotFoundError:
            raise KeyError(key) from None
        return {"etag": str(st.st_mtime_ns), "size": st.st_size}

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def move(self, src: str, dst: str) -> None:
        """Atomic rename within the store."""
        d = self._path(dst)
        os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
        os.replace(self._path(src), d)

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                key = os.path.relpath(os.path.join(dirpath, f), self.root)
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)


def make_store(url: str) -> LocalStore:
    """A local path or ``file://`` URL → :class:`LocalStore`."""
    if url.startswith("s3://"):
        raise NotImplementedError(
            f"S3 object stores are not ported yet (ROADMAP A9; the client "
            f"needs boto3): {url!r}")
    if url.startswith("file://"):
        url = url[len("file://"):]
    elif "://" in url:
        raise ValueError(f"unknown store URL scheme: {url!r}")
    return LocalStore(url)
