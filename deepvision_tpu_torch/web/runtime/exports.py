"""Export generators: Markdown -> docx / PDF, written from scratch.

The reference exports .docx/PDF client-side via vendored JS (web/app.js:
4302-4392) and renders the server-side appendix PDF with reportlab + PIL
CJK image pages (web/server.py:34155-34431).  Neither reportlab nor
python-docx exists in this image, so both writers are implemented directly:

* docx: a .docx is a zip of OOXML parts — emit [Content_Types].xml,
  _rels, and word/document.xml with styled paragraphs.
* PDF: hand-written PDF objects using the non-embedded ``STSong-Light`` CID
  font with ``UniGB-UCS2-H`` encoding (UTF-16BE text), the standard
  no-embed route for CJK; viewers substitute a local CJK face.
"""

from __future__ import annotations

import io
import re
import zipfile
from typing import List, Tuple

# ---------------------------------------------------------------------------
# Markdown -> paragraph model
# ---------------------------------------------------------------------------

def markdown_to_paragraphs(markdown: str) -> List[Tuple[str, str]]:
    """Returns [(style, text)]; style in h1/h2/h3/bullet/body/code."""
    out: List[Tuple[str, str]] = []
    in_code = False
    for line in markdown.splitlines():
        if line.strip().startswith("```"):
            in_code = not in_code
            continue
        if in_code:
            out.append(("code", line))
            continue
        m = re.match(r"^(#{1,6})\s+(.*)", line)
        if m:
            level = min(3, len(m.group(1)))
            out.append((f"h{level}", _strip_md(m.group(2))))
            continue
        m = re.match(r"^\s*(?:[-*]|\d+\.)\s+(.*)", line)
        if m:
            out.append(("bullet", _strip_md(m.group(1))))
            continue
        if line.strip():
            out.append(("body", _strip_md(line.strip())))
    return out


def _strip_md(text: str) -> str:
    text = re.sub(r"\*\*([^*]+)\*\*", r"\1", text)
    text = re.sub(r"\*([^*]+)\*", r"\1", text)
    text = re.sub(r"`([^`]+)`", r"\1", text)
    text = re.sub(r"\[([^\]]+)\]\([^)]*\)", r"\1", text)
    return text


# ---------------------------------------------------------------------------
# DOCX writer
# ---------------------------------------------------------------------------

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/word/document.xml" ContentType="application/vnd.openxmlformats-officedocument.wordprocessingml.document.main+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="word/document.xml"/>
</Relationships>"""

_STYLE_MAP = {
    "h1": ("48", "1"), "h2": ("36", "1"), "h3": ("28", "1"),
    "body": ("22", "0"), "bullet": ("22", "0"), "code": ("18", "0"),
}


def _xml_escape(text: str) -> str:
    return (
        text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    )


def markdown_to_docx(markdown: str) -> bytes:
    paras = markdown_to_paragraphs(markdown)
    body_parts = []
    for style, text in paras:
        size, bold = _STYLE_MAP.get(style, ("22", "0"))
        prefix = "· " if style == "bullet" else ""
        rpr = f'<w:rPr><w:sz w:val="{size}"/>'
        if bold == "1":
            rpr += "<w:b/>"
        rpr += "</w:rPr>"
        body_parts.append(
            f"<w:p><w:r>{rpr}<w:t xml:space=\"preserve\">"
            f"{_xml_escape(prefix + text)}</w:t></w:r></w:p>"
        )
    document = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<w:document xmlns:w="http://schemas.openxmlformats.org/'
        'wordprocessingml/2006/main"><w:body>'
        + "".join(body_parts)
        + "<w:sectPr/></w:body></w:document>"
    )
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", _CONTENT_TYPES)
        zf.writestr("_rels/.rels", _RELS)
        zf.writestr("word/document.xml", document)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# PDF writer (CJK via non-embedded STSong-Light / UniGB-UCS2-H)
# ---------------------------------------------------------------------------

_PAGE_W, _PAGE_H = 595, 842  # A4 in points
_MARGIN = 56
_LINE_H = {"h1": 26, "h2": 21, "h3": 18, "body": 15, "bullet": 15, "code": 13}
_FONT_SIZE = {"h1": 18, "h2": 15, "h3": 13, "body": 10.5, "bullet": 10.5,
              "code": 9}


def _utf16be_hex(text: str) -> str:
    return text.encode("utf-16-be").hex().upper()


def _wrap(text: str, size: float) -> List[str]:
    # CJK-aware width estimate: fullwidth chars ~= size, ASCII ~= size/2.
    max_width = _PAGE_W - 2 * _MARGIN
    lines, cur, cur_w = [], "", 0.0
    for ch in text:
        w = size if ord(ch) > 0x2E80 else size * 0.55
        if cur_w + w > max_width and cur:
            lines.append(cur)
            cur, cur_w = "", 0.0
        cur += ch
        cur_w += w
    if cur:
        lines.append(cur)
    return lines or [""]


def markdown_to_pdf(markdown: str, title: str = "") -> bytes:
    paras = markdown_to_paragraphs(markdown)
    # layout into pages of content streams
    pages: List[List[str]] = []
    ops: List[str] = []
    y = _PAGE_H - _MARGIN

    def flush():
        nonlocal ops, y
        if ops:
            pages.append(ops)
        ops = []
        y = _PAGE_H - _MARGIN

    for style, text in paras:
        size = _FONT_SIZE[style]
        lh = _LINE_H[style]
        prefix = "· " if style == "bullet" else ""
        for line in _wrap(prefix + text, size):
            if y < _MARGIN + lh:
                flush()
            ops.append(
                f"BT /F1 {size} Tf {_MARGIN} {y - lh} Td "
                f"<{_utf16be_hex(line)}> Tj ET"
            )
            y -= lh
        if style.startswith("h"):
            y -= 6
    flush()
    if not pages:
        pages = [[f"BT /F1 12 Tf {_MARGIN} {_PAGE_H - _MARGIN - 20} Td "
                  f"<{_utf16be_hex(title or '(empty)')}> Tj ET"]]

    # assemble PDF objects
    objects: List[bytes] = []

    def add(obj: bytes) -> int:
        objects.append(obj)
        return len(objects)  # 1-based object number

    font_desc = add(
        b"<< /Type /FontDescriptor /FontName /STSong-Light /Flags 4 "
        b"/FontBBox [-25 -254 1000 880] /ItalicAngle 0 /Ascent 880 "
        b"/Descent -254 /CapHeight 880 /StemV 93 >>"
    )
    cid_font = add(
        (
            "<< /Type /Font /Subtype /CIDFontType0 /BaseFont /STSong-Light "
            "/CIDSystemInfo << /Registry (Adobe) /Ordering (GB1) "
            "/Supplement 5 >> "
            f"/FontDescriptor {font_desc} 0 R /DW 1000 "
            "/W [1 95 500] >>"
        ).encode()
    )
    font = add(
        (
            "<< /Type /Font /Subtype /Type0 /BaseFont /STSong-Light "
            "/Encoding /UniGB-UCS2-H "
            f"/DescendantFonts [{cid_font} 0 R] >>"
        ).encode()
    )

    page_obj_nums = []
    content_obj_nums = []
    for page_ops in pages:
        stream = "\n".join(page_ops).encode()
        content_obj_nums.append(
            add(
                b"<< /Length " + str(len(stream)).encode() + b" >>\nstream\n"
                + stream + b"\nendstream"
            )
        )
    pages_obj_num = len(objects) + len(pages) + 1
    for content_num in content_obj_nums:
        page_obj_nums.append(
            add(
                (
                    f"<< /Type /Page /Parent {pages_obj_num} 0 R "
                    f"/MediaBox [0 0 {_PAGE_W} {_PAGE_H}] "
                    f"/Resources << /Font << /F1 {font} 0 R >> >> "
                    f"/Contents {content_num} 0 R >>"
                ).encode()
            )
        )
    kids = " ".join(f"{n} 0 R" for n in page_obj_nums)
    pages_obj = add(
        (
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_obj_nums)} >>"
        ).encode()
    )
    assert pages_obj == pages_obj_num
    catalog = add(f"<< /Type /Catalog /Pages {pages_obj} 0 R >>".encode())

    # serialize with xref
    out = io.BytesIO()
    out.write(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = [0]
    for i, obj in enumerate(objects, 1):
        offsets.append(out.tell())
        out.write(f"{i} 0 obj\n".encode())
        out.write(obj)
        out.write(b"\nendobj\n")
    xref_pos = out.tell()
    out.write(f"xref\n0 {len(objects) + 1}\n".encode())
    out.write(b"0000000000 65535 f \n")
    for off in offsets[1:]:
        out.write(f"{off:010d} 00000 n \n".encode())
    out.write(
        (
            f"trailer\n<< /Size {len(objects) + 1} /Root {catalog} 0 R >>\n"
            f"startxref\n{xref_pos}\n%%EOF\n"
        ).encode()
    )
    return out.getvalue()
