"""Object-store abstraction — the port's own copy of the JAX package's
``io/store.py``, the MinIO/S3 artifact layer.

- :class:`LocalStore` — a filesystem-backed object store (what a mounted
  volume looks like);
- :class:`S3Store` — an S3/MinIO client (boto3 is imported only when no
  client is injected, so tests run against a fake without boto3);
- :func:`make_store` — ``s3://bucket[/prefix]`` → :class:`S3Store`, a
  local path or ``file://`` URL → :class:`LocalStore`.

Missing keys raise ``KeyError`` everywhere; callers that tolerate absence
(the reference's 404 path) catch it — see
:func:`~.artifacts.download_model`. Sinks, artifacts, checkpoints, the
model registry and the cold tier all reach a store through
:func:`make_store`.
"""

from __future__ import annotations

import os
from typing import List, Optional


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

    def get_with_meta(self, key: str) -> "tuple[bytes, dict]":
        """Body and ``{"etag", "size"}`` from one read: the open file is
        stat'ed before it is read, so under atomic-replace writers the
        etag describes the bytes returned."""
        try:
            with open(self._path(key), "rb") as f:
                st = os.fstat(f.fileno())
                return f.read(), {"etag": str(st.st_mtime_ns),
                                  "size": st.st_size}
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


_MISSING_CODES = ("404", "NoSuchKey", "NotFound")


def _is_missing(exc: Exception) -> bool:
    """True when an S3 client's exception means "no such key": botocore's
    ``ClientError`` shape (``.response["Error"]["Code"]``), duck-typed so
    fakes work without botocore."""
    err = getattr(exc, "response", None)
    if isinstance(err, dict):
        return err.get("Error", {}).get("Code") in _MISSING_CODES
    return False


def _meta(resp: dict) -> dict:
    """``{"etag", "size"}`` of a GetObject or HeadObject response (the
    last-modified stamp stands in for a missing ETag)."""
    return {"etag": str(resp.get("ETag", "")) or str(
                resp.get("LastModified", "")),
            "size": resp.get("ContentLength")}


class S3Store:
    """S3/MinIO object store. ``client`` is injectable; without one,
    ``client_kwargs`` (``endpoint_url``, credentials, region) go to
    ``boto3.client("s3", ...)``, and a missing boto3 raises ImportError."""

    def __init__(self, bucket: str, prefix: str = "", client=None,
                 **client_kwargs):
        if client is None:
            try:
                import boto3
            except ImportError as e:
                raise ImportError(
                    "boto3 is not installed; use LocalStore for dev, or "
                    "install boto3 (pip install boto3) in production "
                    "images."
                ) from e
            client = boto3.client("s3", **client_kwargs)
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.client = client

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def put(self, key: str, data: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=self._key(key),
                               Body=data)

    def _get(self, key: str) -> dict:
        try:
            return self.client.get_object(Bucket=self.bucket,
                                          Key=self._key(key))
        except Exception as e:
            if _is_missing(e):
                raise KeyError(key) from None
            raise

    @staticmethod
    def _body(obj: dict) -> bytes:
        body = obj["Body"]
        return body.read() if hasattr(body, "read") else body

    def get(self, key: str) -> bytes:
        return self._body(self._get(key))

    def get_with_meta(self, key: str) -> "tuple[bytes, dict]":
        """Body and metadata from the same GetObject response, so the etag
        describes the returned bytes even under a concurrent overwrite."""
        obj = self._get(key)
        return self._body(obj), _meta(obj)

    def exists(self, key: str) -> bool:
        try:
            self.head(key)
            return True
        except KeyError:
            return False

    def head(self, key: str) -> dict:
        """``{"etag", "size"}`` from one HEAD request; KeyError when the
        key is missing."""
        try:
            resp = self.client.head_object(Bucket=self.bucket,
                                           Key=self._key(key))
        except Exception as e:
            if _is_missing(e):
                raise KeyError(key) from None
            raise
        return _meta(resp)

    def delete(self, key: str) -> None:
        self.client.delete_object(Bucket=self.bucket, Key=self._key(key))

    def move(self, src: str, dst: str) -> None:
        """Server-side copy, then delete (S3 has no rename)."""
        self.client.copy_object(
            Bucket=self.bucket, Key=self._key(dst),
            CopySource={"Bucket": self.bucket, "Key": self._key(src)},
        )
        self.client.delete_object(Bucket=self.bucket, Key=self._key(src))

    def list(self, prefix: str = "") -> List[str]:
        full = self._key(prefix)
        keys: List[str] = []
        token: Optional[str] = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": full}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            for item in resp.get("Contents", []):
                k = item["Key"]
                if self.prefix:
                    k = k[len(self.prefix) + 1:]
                keys.append(k)
            if not resp.get("IsTruncated"):
                break
            token = resp.get("NextContinuationToken")
        return sorted(keys)


def make_store(url: str, **kwargs):
    """``s3://bucket[/prefix]`` → :class:`S3Store` (``RTFDS_S3_ENDPOINT``,
    when set and neither ``endpoint_url`` nor ``client`` is given, points
    the client at MinIO); a local path or ``file://`` URL →
    :class:`LocalStore`."""
    if url.startswith("s3://"):
        bucket, _, prefix = url[len("s3://"):].partition("/")
        if ("endpoint_url" not in kwargs and "client" not in kwargs
                and os.environ.get("RTFDS_S3_ENDPOINT")):
            kwargs["endpoint_url"] = os.environ["RTFDS_S3_ENDPOINT"]
        return S3Store(bucket, prefix=prefix, **kwargs)
    if url.startswith("file://"):
        url = url[len("file://"):]
    elif "://" in url:
        raise ValueError(f"unknown store URL scheme: {url!r}")
    return LocalStore(url)
