"""List-API plumbing: paging params, X-Total-Count, ETag/304, load shed.

Re-implements the reference pagination/ETag layer (page params
web/server.py:5338, X-Total-Count :5362, ETag build/304 :5371-5399,
per-endpoint bounded semaphores + 429 :5400-5432).
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Tuple

from deepvision_tpu_torch.web.http import HTTPError, Request, Response


def paging_params(req: Request, default_size: int = 20,
                  max_size: int = 100) -> Tuple[int, int]:
    try:
        page = max(1, int(req.args.get("page", "1")))
    except ValueError:
        page = 1
    try:
        size = int(req.args.get("page_size", str(default_size)))
    except ValueError:
        size = default_size
    size = max(1, min(size, max_size))
    return page, size


def etag_for(payload) -> str:
    raw = json.dumps(payload, ensure_ascii=False, sort_keys=True)
    return '"' + hashlib.md5(raw.encode("utf-8")).hexdigest() + '"'


def list_response(req: Request, items: list, total: int) -> Response:
    etag = etag_for(items)
    if req.header("If-None-Match") == etag:
        return Response(b"", status=304, headers={"ETag": etag})
    return Response(
        items,
        headers={"ETag": etag, "X-Total-Count": str(total)},
    )


class EndpointGate:
    """Bounded concurrency per endpoint; over-limit requests 429 fast
    (reference per-endpoint semaphores :5418)."""

    def __init__(self, limit: int = 8, retry_after: int = 2):
        self._sem = threading.BoundedSemaphore(limit)
        self.retry_after = retry_after
        self.rejections = 0

    def __enter__(self):
        if not self._sem.acquire(blocking=False):
            self.rejections += 1
            raise HTTPError(
                429,
                {"error": "endpoint overloaded", "retry_after":
                 self.retry_after},
                headers={"Retry-After": str(self.retry_after)},
            )
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False


def build_overload_response(pending: int, running: int,
                            retry_after: int = 2) -> HTTPError:
    """429 + Retry-After + queue snapshot (reference
    build_overload_response web/server.py:5400)."""
    return HTTPError(
        429,
        {
            "error": "系统繁忙，请稍后重试",
            "queue_pending": pending,
            "queue_running": running,
            "retry_after": retry_after,
        },
        headers={"Retry-After": str(retry_after)},
    )
