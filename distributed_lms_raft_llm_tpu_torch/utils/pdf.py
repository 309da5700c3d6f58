"""Minimal PDF text extraction and generation — stdlib only.

The port's copy of `distributed_lms_raft_llm_tpu/utils/pdf.py`,
its logic as it is.

The reference extracts assignment text with PyPDF2 at upload time
(reference: GUI_RAFT_LLM_SourceCode/lms_server.py:21-27, used in Post
:918) to feed the BERT relevance gate. This image has no PDF library, so we
implement the small subset needed: walk the file's stream objects,
FlateDecode (zlib) where declared, and collect the text-showing operators
(`Tj`, `'`, and `TJ` arrays) from content streams. Covers the simple
text-based PDFs an LMS deals in; image-only/encrypted PDFs yield "".

`make_pdf` produces a valid single-page PDF from text — used by tests and
the demo client so the whole upload→extract→gate path runs hermetically.
"""

from __future__ import annotations

import re
import zlib
from typing import List

_STREAM_RE = re.compile(rb"<<(.*?)>>\s*stream\r?\n(.*?)\r?\nendstream", re.S)
# () string arguments of text-showing operators, including TJ arrays.
_TJ_RE = re.compile(rb"\((?:\\.|[^\\()])*\)\s*(?:Tj|')|\[(?:[^\]]*)\]\s*TJ")
_STR_RE = re.compile(rb"\((?:\\.|[^\\()])*\)")

_ESCAPES = {
    ord("n"): b"\n", ord("r"): b"\r", ord("t"): b"\t", ord("b"): b"\b",
    ord("f"): b"\f", ord("("): b"(", ord(")"): b")", ord("\\"): b"\\",
}


def _unescape(raw: bytes) -> bytes:
    """Decode PDF string escapes left-to-right, one escape at a time
    (a sequential replace() pass would mis-decode e.g. br'\\\\n')."""
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        c = raw[i]
        if c != 0x5C or i + 1 >= n:  # not a backslash, or trailing one
            out.append(c)
            i += 1
            continue
        nxt = raw[i + 1]
        if nxt in _ESCAPES:
            out += _ESCAPES[nxt]
            i += 2
        elif 0x30 <= nxt <= 0x37:  # octal escape, up to 3 digits
            j = i + 1
            digits = b""
            while j < n and len(digits) < 3 and 0x30 <= raw[j] <= 0x37:
                digits += raw[j : j + 1]
                j += 1
            out.append(int(digits, 8) & 0xFF)
            i = j
        else:  # unknown escape: PDF says drop the backslash
            out.append(nxt)
            i += 2
    return bytes(out)


def _text_from_content(content: bytes) -> List[str]:
    parts: List[str] = []
    for m in _TJ_RE.finditer(content):
        for s in _STR_RE.finditer(m.group(0)):
            raw = _unescape(s.group(0)[1:-1])
            text = raw.decode("latin-1", errors="replace")
            if text:
                parts.append(text)
    return parts


def extract_text(data: bytes) -> str:
    """Best-effort text of a PDF byte string ("" when nothing extractable)."""
    if not data.startswith(b"%PDF"):
        return ""
    parts: List[str] = []
    for m in _STREAM_RE.finditer(data):
        header, body = m.group(1), m.group(2)
        if b"FlateDecode" in header:
            try:
                body = zlib.decompress(body)
            except zlib.error:
                continue
        parts.extend(_text_from_content(body))
    return " ".join(parts).strip()


def extract_text_from_file(path: str) -> str:
    with open(path, "rb") as f:
        return extract_text(f.read())


def make_pdf(text: str, *, title: str = "document") -> bytes:
    """A valid, minimal one-page PDF showing `text` (Helvetica, one line per
    \\n). Round-trips through extract_text."""
    lines = text.split("\n")
    shows = []
    y = 760
    for line in lines:
        esc = line.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        shows.append(f"BT /F1 12 Tf 60 {y} Td ({esc}) Tj ET")
        y -= 16
    content = "\n".join(shows).encode("latin-1", errors="replace")

    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Resources << /Font << /F1 5 0 R >> >> /Contents 4 0 R >>",
        b"<< /Length %d >>\nstream\n%s\nendstream" % (len(content), content),
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = [0]
    for i, obj in enumerate(objs, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + obj + b"\nendobj\n"
    xref_pos = len(out)
    out += b"xref\n0 %d\n" % (len(objs) + 1)
    out += b"0000000000 65535 f \n"
    for off in offsets[1:]:
        out += b"%010d 00000 n \n" % off
    out += (
        b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
        % (len(objs) + 1, xref_pos)
    )
    return bytes(out)
