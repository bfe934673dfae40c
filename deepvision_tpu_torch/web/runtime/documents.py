"""Document ingest: conversion to markdown, chunking, cached AI summaries.

Re-implements the reference ingest path (upload web/server.py:31654,
sha256 converted-cache :6973-7037, converters scripts/convert_doc.py:73-322,
chunking :31411, keyword chunk retrieval :31533, smart summaries
:18119-18583) — but the converters are written from scratch on stdlib:
docx/xlsx/pptx are zip+XML containers; PDF text is extracted from Flate
content streams.  (The reference shells out to pypdf/python-docx/openpyxl/
python-pptx, none of which exist in this image.)
"""

from __future__ import annotations

import hashlib
import io
import re
import zipfile
import zlib
from typing import List, Optional
from xml.etree import ElementTree

SUPPORTED_EXTENSIONS = (
    ".md", ".txt", ".markdown", ".pdf", ".docx", ".xlsx", ".pptx", ".csv",
    ".json",
)


class ConversionError(Exception):
    pass


def sha256_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def content_hash16(text: str) -> str:
    """md5-16 content hash for the summary cache (reference
    get_document_hash web/server.py:18121)."""
    return hashlib.md5(text.encode("utf-8")).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def convert_to_markdown(filename: str, data: bytes) -> str:
    name = filename.lower()
    if name.endswith((".md", ".markdown", ".txt", ".csv", ".json")):
        return data.decode("utf-8", "replace")
    if name.endswith(".docx"):
        conv = _docx_to_markdown
    elif name.endswith(".xlsx"):
        conv = _xlsx_to_markdown
    elif name.endswith(".pptx"):
        conv = _pptx_to_markdown
    elif name.endswith(".pdf"):
        conv = _pdf_to_text
    else:
        raise ConversionError(f"unsupported file type: {filename}")
    try:
        return conv(data)
    except ConversionError:
        raise
    except Exception as e:  # noqa: BLE001 — attacker-supplied bytes:
        # any parser escape (ElementTree.ParseError on malformed XML,
        # zlib.error on corrupt members read AFTER the zip open, struct
        # errors in pdf offsets, recursion limits) is a client-input
        # problem, not a server fault (tests/test_doc_converter_fuzz.py)
        raise ConversionError(
            f"unreadable {filename.rsplit('.', 1)[-1]}: "
            f"{type(e).__name__}: {e}") from e


_W_NS = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"


def _docx_to_markdown(data: bytes) -> str:
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            xml = zf.read("word/document.xml")
    except (zipfile.BadZipFile, KeyError) as e:
        raise ConversionError(f"bad docx: {e}") from e
    root = ElementTree.fromstring(xml)
    lines: List[str] = []
    for para in root.iter(f"{_W_NS}p"):
        texts = [t.text or "" for t in para.iter(f"{_W_NS}t")]
        line = "".join(texts).strip()
        if not line:
            continue
        style = para.find(f"{_W_NS}pPr/{_W_NS}pStyle")
        style_val = style.get(f"{_W_NS}val", "") if style is not None else ""
        m = re.match(r"(?:Heading|heading)(\d)", style_val)
        if m:
            lines.append("#" * min(6, int(m.group(1))) + " " + line)
        else:
            lines.append(line)
    return "\n\n".join(lines)


_S_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _xlsx_to_markdown(data: bytes) -> str:
    try:
        zf = zipfile.ZipFile(io.BytesIO(data))
    except zipfile.BadZipFile as e:
        raise ConversionError(f"bad xlsx: {e}") from e
    shared: List[str] = []
    try:
        root = ElementTree.fromstring(zf.read("xl/sharedStrings.xml"))
        for si in root.iter(f"{_S_NS}si"):
            shared.append("".join(t.text or "" for t in si.iter(f"{_S_NS}t")))
    except KeyError:
        pass
    out: List[str] = []
    sheet_names = [
        n for n in zf.namelist()
        if n.startswith("xl/worksheets/sheet") and n.endswith(".xml")
    ]
    for sheet_path in sorted(sheet_names)[:10]:
        root = ElementTree.fromstring(zf.read(sheet_path))
        out.append(f"## 工作表 {sheet_path.split('/')[-1][:-4]}")
        for row in list(root.iter(f"{_S_NS}row"))[:200]:
            cells = []
            for c in row.iter(f"{_S_NS}c"):
                v = c.find(f"{_S_NS}v")
                val = v.text if v is not None else ""
                if c.get("t") == "s" and val and val.isdigit():
                    idx = int(val)
                    val = shared[idx] if idx < len(shared) else val
                cells.append(val or "")
            if any(cells):
                out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


_P_NS = "{http://schemas.openxmlformats.org/drawingml/2006/main}"


def _pptx_to_markdown(data: bytes) -> str:
    try:
        zf = zipfile.ZipFile(io.BytesIO(data))
    except zipfile.BadZipFile as e:
        raise ConversionError(f"bad pptx: {e}") from e
    slides = sorted(
        n for n in zf.namelist()
        if re.match(r"ppt/slides/slide\d+\.xml$", n)
    )
    out: List[str] = []
    for i, slide_path in enumerate(slides[:100], 1):
        root = ElementTree.fromstring(zf.read(slide_path))
        texts = [t.text or "" for t in root.iter(f"{_P_NS}t")]
        body = "\n".join(t for t in texts if t.strip())
        if body:
            out.append(f"## 第 {i} 页\n{body}")
    return "\n\n".join(out)


# --- PDF: minimal text extraction from content streams --------------------

_PDF_TJ_RE = re.compile(rb"\(((?:[^()\\]|\\.)*)\)\s*Tj")
_PDF_TJ_ARRAY_RE = re.compile(rb"\[((?:[^\[\]])*)\]\s*TJ")
_PDF_STR_RE = re.compile(rb"\(((?:[^()\\]|\\.)*)\)")
_PDF_HEX_RE = re.compile(rb"<([0-9A-Fa-f\s]+)>\s*Tj")


def _pdf_unescape(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == 0x5C and i + 1 < len(raw):  # backslash
            nxt = raw[i + 1]
            mapping = {ord("n"): 10, ord("r"): 13, ord("t"): 9,
                       ord("("): 40, ord(")"): 41, ord("\\"): 92}
            if nxt in mapping:
                out.append(mapping[nxt])
                i += 2
                continue
            if 0x30 <= nxt <= 0x37:  # octal escape
                oct_digits = raw[i + 1:i + 4]
                try:
                    out.append(int(oct_digits, 8) & 0xFF)
                except ValueError:
                    pass
                i += 1 + len(oct_digits)
                continue
            i += 1
            continue
        out.append(ch)
        i += 1
    return bytes(out)


def _pdf_to_text(data: bytes) -> str:
    """Extract text operators from Flate-compressed content streams.

    Covers the common simple-font case (WinAnsi/UTF-8-ish byte strings in
    Tj/TJ).  CID/Identity-encoded PDFs yield partial text; page structure
    is approximated by stream boundaries."""
    chunks: List[str] = []
    for m in re.finditer(rb"stream\r?\n(.*?)\r?\nendstream", data, re.S):
        raw = m.group(1)
        try:
            raw = zlib.decompress(raw)
        except zlib.error:
            pass
        if b"Tj" not in raw and b"TJ" not in raw:
            continue
        parts: List[bytes] = []
        for sm in _PDF_TJ_RE.finditer(raw):
            parts.append(_pdf_unescape(sm.group(1)))
        for am in _PDF_TJ_ARRAY_RE.finditer(raw):
            for sm in _PDF_STR_RE.finditer(am.group(1)):
                parts.append(_pdf_unescape(sm.group(1)))
        for hm in _PDF_HEX_RE.finditer(raw):
            hexstr = re.sub(rb"\s", b"", hm.group(1))
            try:
                parts.append(bytes.fromhex(hexstr.decode()))
            except ValueError:
                pass
        if parts:
            text = b" ".join(parts).decode("utf-8", "replace")
            text = text.replace("�", "").strip()
            if text:
                chunks.append(text)
    if not chunks:
        raise ConversionError(
            "PDF 文本提取失败（可能是扫描件或 CID 编码字体）"
        )
    return "\n\n".join(chunks)


# ---------------------------------------------------------------------------
# Chunking + keyword retrieval (reference :31411, :31533)
# ---------------------------------------------------------------------------

def chunk_markdown_bytes(text: str, chunk_chars: int = 800,
                         max_chunks: int = 256) -> List[str]:
    """Chunks of at most ``3 * chunk_chars`` UTF-8 bytes (about
    ``chunk_chars`` CJK characters), at most ``max_chunks`` of them.

    The rules of the JAX app's C++ chunker (``dv_chunk_markdown``): each
    chunk ends at the last paragraph break (``\n\n``) after half the byte
    budget, else at the last newline there, else at the last UTF-8
    character boundary within the budget; leading whitespace
    (``\n``, space, ``\r``, ``\t``) is stripped and empty chunks are
    dropped.  The separators stay at the start of the next chunk, to be
    stripped there."""
    data = text.encode("utf-8")
    n = len(data)
    budget = chunk_chars * 3
    chunks: List[str] = []
    start = 0
    while start < n and len(chunks) < max_chunks:
        end = start + budget
        if end >= n:
            end = n
        else:
            lo = start + budget // 2
            cand = data.rfind(b"\n\n", lo + 1, end + 2)
            if cand < 0:
                cand = data.rfind(b"\n", lo + 1, end + 1)
            if cand > 0:
                end = cand
            else:
                while end > start and (data[end] & 0xC0) == 0x80:
                    end -= 1
        s = start
        while s < end and data[s] in b"\n \r\t":
            s += 1
        if s < end:
            chunks.append(data[s:end].decode("utf-8", "replace"))
        start = end
    return chunks


def chunk_markdown(text: str, *, chunk_chars: int = 800,
                   overlap: int = 80) -> List[str]:
    if len(text) <= chunk_chars:
        return [text] if text.strip() else []
    chunks = chunk_markdown_bytes(text, chunk_chars)
    if chunks:
        return chunks
    # prefer paragraph boundaries
    paras = re.split(r"\n{2,}", text)
    chunks: List[str] = []
    cur = ""
    for p in paras:
        if len(cur) + len(p) + 2 <= chunk_chars:
            cur = f"{cur}\n\n{p}" if cur else p
        else:
            if cur:
                chunks.append(cur)
            while len(p) > chunk_chars:
                chunks.append(p[:chunk_chars])
                p = p[chunk_chars - overlap:]
            cur = p
    if cur.strip():
        chunks.append(cur)
    return chunks


def select_chunks_for_query(chunks: List[str], query: str,
                            top_k: int = 3, embed_fn=None) -> List[str]:
    """Hybrid chunk retrieval: keyword overlap (reference
    select_reference_material_context :31533) blended with semantic
    cosine ranking when an embedder is available (``embed_fn`` — usually
    ``ModelGateway.embed_texts``; the serving checkpoint doubles as the
    encoder, engine/embedding.py).  Keyword scores catch exact entity
    matches the encoder may miss; cosine catches paraphrases keyword
    overlap misses.  Degrades to keyword-only when embedding is
    unavailable (template backend, quantized params) or fails."""
    tokens = set(re.findall(r"[\w一-鿿]{2,}", query))
    kw = [sum(1 for t in tokens if t in ch) for ch in chunks] \
        if tokens else [0] * len(chunks)
    sem = None
    if embed_fn is not None and chunks:
        try:
            embs = embed_fn(list(chunks) + [query])
        except Exception:  # noqa: BLE001 — retrieval must degrade
            embs = None
        if embs is not None and len(embs) == len(chunks) + 1:
            sem = list(embs[:-1] @ embs[-1])          # cosine (unit vecs)
    if sem is None:
        if not tokens:
            return chunks[:top_k]
        scored = sorted(zip(kw, chunks), key=lambda t: -t[0])
        return ([ch for s, ch in scored[:top_k] if s > 0]
                or chunks[:1])
    kw_max = max(kw) or 1
    blended = [0.5 * (k / kw_max) + 0.5 * float(s)
               for k, s in zip(kw, sem)]
    order = sorted(range(len(chunks)), key=lambda i: -blended[i])
    return [chunks[i] for i in order[:top_k]]


# ---------------------------------------------------------------------------
# Summaries (reference summarize_document :18210, cache :18127-18208)
# ---------------------------------------------------------------------------

class DocumentPipeline:
    def __init__(self, meta, gateway, *, summary_min_chars: int = 1400,
                 summary_target_chars: int = 700, metrics=None):
        self.meta = meta
        self.gateway = gateway
        self.summary_min_chars = summary_min_chars
        self.summary_target_chars = summary_target_chars
        self.metrics = metrics

    # -- converted cache (sha256-keyed; reference :6973-7037) ------------
    def convert_cached(self, filename: str, data: bytes) -> str:
        digest = sha256_of(data)
        cached = self.meta.kv_get(
            "converted_cache_store", "content_sha256", digest, "markdown"
        )
        if cached is not None:
            if self.metrics:
                self.metrics.incr("doc_convert.cache_hit")
            return cached
        markdown = convert_to_markdown(filename, data)
        self.meta.execute(
            "INSERT INTO converted_cache_store (content_sha256, markdown, "
            "source_name, created_at) VALUES (?, ?, ?, ?) "
            "ON CONFLICT(content_sha256) DO UPDATE SET "
            "markdown = excluded.markdown",
            (digest, markdown, filename,
             __import__("time").strftime("%Y-%m-%dT%H:%M:%SZ")),
        )
        if self.metrics:
            self.metrics.incr("doc_convert.cache_miss")
        return markdown

    # -- summary cache ---------------------------------------------------
    def summarize_cached(self, doc_name: str, content: str) -> Optional[str]:
        if len(content) <= self.summary_min_chars:
            return None
        h = content_hash16(content)
        cached = self.meta.kv_get(
            "summary_cache_store", "content_hash", h, "summary"
        )
        if cached is not None:
            if self.metrics:
                self.metrics.incr("doc_summary.cache_hit")
            return cached
        try:
            summary = self.gateway.call_model(
                f"请将以下文档压缩为不超过{self.summary_target_chars}字的要点"
                f"摘要，保留关键数据与结论：\n\n{content[:6000]}",
                call_type="doc_summary",
                context={"doc_name": doc_name, "content": content[:2000]},
            )
        except Exception:
            return None
        self.meta.execute(
            "INSERT INTO summary_cache_store (content_hash, summary, "
            "doc_name, created_at) VALUES (?, ?, ?, ?) "
            "ON CONFLICT(content_hash) DO UPDATE SET summary = excluded.summary",
            (h, summary, doc_name,
             __import__("time").strftime("%Y-%m-%dT%H:%M:%SZ")),
        )
        if self.metrics:
            self.metrics.incr("doc_summary.cache_miss")
        return summary

    def summaries_stats(self) -> dict:
        """Summary-cache payload (reference get_summaries_info
        web/server.py:44948-44981)."""
        row = self.meta.query_one(
            "SELECT COUNT(*) AS n, COALESCE(SUM(LENGTH(summary)), 0) AS bytes "
            "FROM summary_cache_store"
        )
        size = int(row["bytes"] or 0)
        return {
            "cache_enabled": True,
            "threshold": self.summary_min_chars,
            "target_length": self.summary_target_chars,
            "cached_count": int(row["n"] or 0),
            "cache_size_bytes": size,
            "cache_size_kb": round(size / 1024, 2),
            # legacy keys kept for earlier consumers
            "count": int(row["n"] or 0),
            "total_chars": size,
        }

    def clear_summaries(self) -> int:
        row = self.meta.query_one(
            "SELECT COUNT(*) AS n FROM summary_cache_store"
        )
        self.meta.execute("DELETE FROM summary_cache_store")
        return row["n"]

    # -- ingest entry ----------------------------------------------------
    def ingest(self, filename: str, data: bytes) -> dict:
        markdown = self.convert_cached(filename, data)
        chunks = chunk_markdown(markdown)
        summary = self.summarize_cached(filename, markdown)
        return {
            "name": filename,
            "content": markdown[:20000],
            "chunks": chunks[:50],
            "summary": summary,
            "sha256": sha256_of(data),
            "char_count": len(markdown),
        }
