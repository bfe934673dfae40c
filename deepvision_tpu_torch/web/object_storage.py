"""Object storage: S3-compatible archive for presentations/exports/ops.

Re-implements the reference's ObjectStorageHistoryService
(web/server_modules/object_storage_history.py:11, boto3-backed).  boto3 is
absent here, so the S3 client implements AWS Signature V4 directly over
``requests``; a local-filesystem backend covers zero-egress deployments and
tests.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
from typing import List, Optional
from urllib.parse import quote


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class SigV4S3Client:
    """Minimal S3 client: put/get/list via AWS Signature Version 4."""

    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _sign(self, method: str, path: str, query: str, payload: bytes,
              now: Optional[datetime.datetime] = None) -> dict:
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = self.endpoint.split("://", 1)[-1]
        payload_hash = _sha256_hex(payload)
        canonical_headers = (
            f"host:{host}\nx-amz-content-sha256:{payload_hash}\n"
            f"x-amz-date:{amz_date}\n"
        )
        signed_headers = "host;x-amz-content-sha256;x-amz-date"
        canonical_request = "\n".join([
            method, quote(path), query, canonical_headers, signed_headers,
            payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            _sha256_hex(canonical_request.encode()),
        ])
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(
            k, string_to_sign.encode(), hashlib.sha256
        ).hexdigest()
        auth = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return {
            "Authorization": auth,
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
        }

    def put_object(self, key: str, data: bytes,
                   content_type: str = "application/octet-stream") -> None:
        import requests

        path = f"/{self.bucket}/{key}"
        headers = self._sign("PUT", path, "", data)
        headers["Content-Type"] = content_type
        resp = requests.put(
            self.endpoint + path, data=data, headers=headers, timeout=30
        )
        resp.raise_for_status()

    def get_object(self, key: str) -> bytes:
        import requests

        path = f"/{self.bucket}/{key}"
        headers = self._sign("GET", path, "", b"")
        resp = requests.get(self.endpoint + path, headers=headers, timeout=30)
        resp.raise_for_status()
        return resp.content

    def list_keys(self, prefix: str = "") -> List[str]:
        import re
        import requests

        path = f"/{self.bucket}"
        query = f"list-type=2&prefix={quote(prefix)}"
        headers = self._sign("GET", path, query, b"")
        resp = requests.get(
            f"{self.endpoint}{path}?{query}", headers=headers, timeout=30
        )
        resp.raise_for_status()
        return re.findall(r"<Key>([^<]+)</Key>", resp.text)


class LocalObjectStore:
    """Filesystem backend with the same surface (zero-egress default)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        """Resolve a key STRICTLY inside the root.  Keys are normally
        built from validated names (stores.is_safe_name), but the store
        is also reachable from the sync CLI with operator input —
        absolute keys and dot-dot segments must not escape
        (tests/test_object_storage.py caught ../ writing outside)."""
        raw = key.replace("\\", "/")
        if raw.startswith("/"):
            raise ValueError(f"unsafe object key: {key!r}")
        norm = os.path.normpath(raw)
        if norm.startswith("..") or os.path.isabs(norm):
            raise ValueError(f"unsafe object key: {key!r}")
        path = os.path.join(self.root, norm)
        if os.path.commonpath([os.path.abspath(path),
                               os.path.abspath(self.root)]) != \
                os.path.abspath(self.root):
            raise ValueError(f"unsafe object key: {key!r}")
        return path

    def put_object(self, key: str, data: bytes,
                   content_type: str = "") -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(data)

    def get_object(self, key: str) -> bytes:
        with open(self._path(key), "rb") as fh:
            return fh.read()

    def list_keys(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


class ObjectStorageHistoryService:
    """Archive exports / presentations / ops artifacts; manual history sync
    (reference scripts/sync_object_storage_history.py)."""

    def __init__(self, state):
        cfg = state.resolver
        endpoint = cfg.get_str("OBJECT_STORAGE_ENDPOINT")
        if endpoint:
            self.backend = SigV4S3Client(
                endpoint,
                cfg.get_str("OBJECT_STORAGE_BUCKET", "deepvision"),
                cfg.get_str("OBJECT_STORAGE_ACCESS_KEY"),
                cfg.get_str("OBJECT_STORAGE_SECRET_KEY"),
                cfg.get_str("OBJECT_STORAGE_REGION", "us-east-1"),
            )
        else:
            self.backend = LocalObjectStore(
                os.path.join(state.data_dir, "object_storage")
            )
        self.state = state

    def archive_export(self, report_name: str, asset_id: str,
                       filename: str, data: bytes) -> str:
        key = f"exports/{report_name}/{asset_id}/{filename}"
        self.backend.put_object(key, data)
        return key

    def sync_history(self) -> dict:
        """Backfill all stored export assets into object storage."""
        rows = self.state.meta.query(
            "SELECT asset_id, report_name, filename, content "
            "FROM export_asset_store"
        )
        synced = 0
        for row in rows:
            self.archive_export(
                row["report_name"], row["asset_id"], row["filename"],
                row["content"] if isinstance(row["content"], bytes)
                else (row["content"] or "").encode(),
            )
            synced += 1
        return {"synced": synced}
