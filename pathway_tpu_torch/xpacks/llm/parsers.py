"""Document parsers (reference: python/pathway/xpacks/llm/parsers.py).

Parsers are UDFs `bytes -> list[tuple[str, dict]]` (text, metadata).

Design notes vs the reference:
- The reference delegates partitioning to the `unstructured` package and
  chunks its Element objects (parsers.py:87-330).  Here the five chunking
  modes (single / elements / paged / by_title / basic) are implemented
  natively over a light element model, with `unstructured` used for
  partitioning when installed and a built-in partitioner (plain text,
  markdown, HTML via bs4) otherwise — parsing stays real without the
  optional dependency.
- PypdfParser (reference parsers.py:1019-1093) keeps the pypdf extraction
  when available and adds the same text cleanup pass (de-hyphenation,
  wrapped-line joining, whitespace collapse); a built-in extractor covers
  simple Flate/plain PDFs so the parser works on real bytes either way.
- DoclingParser genuinely attempts the docling import and converts when
  present (reference parsers.py:334-672).
Parsers run host-side; the device path starts downstream at the embedder.
"""

from __future__ import annotations

import inspect
import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from pathway_tpu_torch.internals.udfs import UDF


class Utf8Parser(UDF):
    """reference: parsers.py Utf8Parser:48."""

    def __init__(self):
        # batched: one Python call per engine batch, not per document —
        # this parser sits on the bulk-ingest hot path (SURVEY §3.4)
        super().__init__(
            return_type=list, deterministic=True, max_batch_size=65536
        )

        def parse(contents_batch: list) -> list:
            out = []
            for contents in contents_batch:
                if isinstance(contents, str):
                    text = contents
                else:
                    text = contents.decode("utf-8", errors="replace")
                out.append([(text, {})])
            return out

        self.func = parse


# kept name from older reference versions
ParseUtf8 = Utf8Parser


# ---------------------------------------------------------------------------
# Element model + built-in partitioner
# ---------------------------------------------------------------------------


@dataclass
class Element:
    """Light analogue of unstructured's Element: text + category + meta."""

    text: str
    category: str = "NarrativeText"  # Title | ListItem | NarrativeText | ...
    page_number: Optional[int] = None
    metadata: dict = field(default_factory=dict)

    def to_meta(self) -> dict:
        meta = {"category": self.category, **self.metadata}
        if self.page_number is not None:
            meta["page_number"] = self.page_number
        return meta


_MD_HEADING = re.compile(r"^(#{1,6})\s+(.*)$")
_PAGE_BREAK = "\x0c"


def _partition_text(text: str) -> List[Element]:
    """Plain text / markdown: blank-line separated blocks; markdown
    headings and short ALL-CAPS lines become Title elements; form feeds
    advance the page number."""
    elements: List[Element] = []
    page = 1
    for page_chunk in text.split(_PAGE_BREAK):
        for block in re.split(r"\n\s*\n", page_chunk):
            block = block.strip()
            if not block:
                continue
            lines = block.splitlines()
            m = _MD_HEADING.match(lines[0])
            if m and len(lines) == 1:
                elements.append(Element(m.group(2).strip(), "Title", page))
                continue
            first = lines[0].strip()
            if (
                len(lines) == 1
                and 0 < len(first) <= 80
                and first == first.upper()
                and any(c.isalpha() for c in first)
                and not first.endswith((".", ":", ";", ","))
            ):
                elements.append(Element(first, "Title", page))
                continue
            if block.lstrip().startswith(("- ", "* ", "+ ")) or re.match(
                r"^\d+[.)]\s", block.lstrip()
            ):
                for line in lines:
                    line = line.strip()
                    if line:
                        elements.append(
                            Element(
                                re.sub(r"^([-*+]|\d+[.)])\s+", "", line),
                                "ListItem",
                                page,
                            )
                        )
                continue
            elements.append(
                Element(" ".join(block.split()), "NarrativeText", page)
            )
        page += 1
    return elements


_HTML_TITLE_TAGS = {"h1", "h2", "h3", "h4", "h5", "h6"}
_HTML_BLOCK_TAGS = _HTML_TITLE_TAGS | {"p", "li", "td", "pre", "blockquote"}


def _partition_html(markup: str) -> List[Element]:
    try:
        from bs4 import BeautifulSoup
    except ImportError:
        # degrade without bs4: strip tags, keep the text blocks
        text = re.sub(r"<(script|style)\b.*?</\1>", " ", markup, flags=re.S | re.I)
        text = re.sub(r"<br\s*/?>|</(p|div|li|h[1-6])>", "\n\n", text, flags=re.I)
        text = re.sub(r"<[^>]+>", " ", text)
        import html as html_mod

        return _partition_text(html_mod.unescape(text))

    soup = BeautifulSoup(markup, "html.parser")
    for tag in soup(["script", "style"]):
        tag.decompose()
    elements: List[Element] = []
    for tag in soup.find_all(_HTML_BLOCK_TAGS):
        text = " ".join(tag.get_text(" ", strip=True).split())
        if not text:
            continue
        if tag.name in _HTML_TITLE_TAGS:
            cat = "Title"
        elif tag.name == "li":
            cat = "ListItem"
        else:
            cat = "NarrativeText"
        elements.append(Element(text, cat, metadata={"tag": tag.name}))
    if not elements:
        text = " ".join(soup.get_text(" ", strip=True).split())
        if text:
            elements.append(Element(text))
    return elements


def partition_builtin(contents: bytes | str) -> List[Element]:
    """Dependency-free partitioner: sniffs HTML, falls back to
    text/markdown block parsing."""
    if isinstance(contents, bytes):
        text = contents.decode("utf-8", errors="replace")
    else:
        text = contents
    sniff = text[:512].lstrip().lower()
    if sniff.startswith(("<!doctype html", "<html")) or "<body" in sniff:
        return _partition_html(text)
    if re.search(r"<(p|h[1-6]|li)\b", sniff):
        return _partition_html(text)
    return _partition_text(text)


# ---------------------------------------------------------------------------
# Chunking modes (reference: parsers.py UnstructuredParser._chunk:176-233)
# ---------------------------------------------------------------------------

CHUNKING_MODES = ("single", "elements", "paged", "by_title", "basic")


def _combine_metadata(left: dict, right: dict) -> dict:
    out = dict(left)
    for k, v in right.items():
        if k in out and out[k] != v:
            prev = out[k]
            if isinstance(prev, list):
                if v not in prev:
                    out[k] = prev + [v]
            else:
                out[k] = [prev, v]
        else:
            out[k] = v
    return out


def chunk_elements_basic(
    elements: List[Element], *, max_characters: int = 500, **_kw
) -> List[Tuple[str, dict]]:
    """Greedy packing of consecutive elements up to max_characters
    (unstructured's chunk_elements in spirit); an oversized element is
    hard-split at the boundary."""
    chunks: List[Tuple[str, dict]] = []
    buf: List[str] = []
    meta: dict = {}
    size = 0

    def flush():
        nonlocal buf, meta, size
        if buf:
            chunks.append(("\n\n".join(buf), meta))
        buf, meta, size = [], {}, 0

    for el in elements:
        text = el.text
        while len(text) > max_characters:
            flush()
            chunks.append((text[:max_characters], el.to_meta()))
            text = text[max_characters:]
        if not text:
            continue
        if size and size + len(text) + 2 > max_characters:
            flush()
        buf.append(text)
        meta = _combine_metadata(meta, el.to_meta())
        size += len(text) + 2
    flush()
    return chunks


def chunk_elements_by_title(
    elements: List[Element], *, max_characters: int = 2000, **_kw
) -> List[Tuple[str, dict]]:
    """New chunk at every Title element; oversized sections split by the
    basic packer (unstructured's chunk_by_title in spirit)."""
    sections: List[List[Element]] = []
    cur: List[Element] = []
    for el in elements:
        if el.category == "Title" and cur:
            sections.append(cur)
            cur = []
        cur.append(el)
    if cur:
        sections.append(cur)
    out: List[Tuple[str, dict]] = []
    for section in sections:
        joined = "\n\n".join(e.text for e in section)
        meta: dict = {}
        for e in section:
            meta = _combine_metadata(meta, e.to_meta())
        if len(joined) <= max_characters:
            out.append((joined, meta))
        else:
            out.extend(
                chunk_elements_basic(section, max_characters=max_characters)
            )
    return out


def chunk_elements_paged(elements: List[Element]) -> List[Tuple[str, dict]]:
    text_by_page: dict = {}
    meta_by_page: dict = {}
    for el in elements:
        page = el.page_number if el.page_number is not None else 1
        text_by_page[page] = text_by_page.get(page, "") + el.text + "\n\n"
        meta_by_page[page] = _combine_metadata(
            meta_by_page.get(page, {}), el.to_meta()
        )
    return [
        (text_by_page[p], meta_by_page[p]) for p in sorted(text_by_page)
    ]


def chunk(
    elements: List[Element], mode: str, **chunking_kwargs
) -> List[Tuple[str, dict]]:
    if mode == "elements":
        return [(el.text, el.to_meta()) for el in elements]
    if mode == "paged":
        return chunk_elements_paged(elements)
    if mode == "by_title":
        return chunk_elements_by_title(elements, **chunking_kwargs)
    if mode == "basic":
        return chunk_elements_basic(elements, **chunking_kwargs)
    if mode == "single":
        meta: dict = {}
        for el in elements:
            meta = _combine_metadata(meta, el.to_meta())
        return [("\n\n".join(el.text for el in elements), meta)]
    raise ValueError(
        f"chunking_mode must be one of {CHUNKING_MODES}, got {mode!r}"
    )


class UnstructuredParser(UDF):
    """reference: parsers.py UnstructuredParser:87-330.

    Partitioning uses the `unstructured` package when installed; the
    built-in partitioner (text/markdown/HTML) otherwise.  All five
    chunking modes run natively either way."""

    def __init__(
        self,
        chunking_mode: str = "single",
        mode: str | None = None,  # old reference keyword
        post_processors: list | None = None,
        chunking_kwargs: dict | None = None,
        **unstructured_kwargs,
    ):
        super().__init__(return_type=list, deterministic=True)
        chunking_mode = mode or chunking_mode
        if chunking_mode not in CHUNKING_MODES:
            raise ValueError(
                f"Got {chunking_mode!r} for `chunking_mode`, but should "
                f"be one of {CHUNKING_MODES}"
            )
        self.chunking_mode = chunking_mode
        self.chunking_kwargs = chunking_kwargs or {}
        self.post_processors = post_processors or []
        self.kwargs = unstructured_kwargs

        def parse(contents: bytes) -> list:
            elements = self._partition(contents)
            docs = chunk(
                elements, self.chunking_mode, **self.chunking_kwargs
            )
            for proc in self.post_processors:
                docs = [(proc(text), meta) for text, meta in docs]
            return docs

        self.func = parse

    def _partition(self, contents: bytes) -> List[Element]:
        try:
            from unstructured.partition.auto import partition
        except ImportError:
            return partition_builtin(contents)
        import io

        raw = partition(file=io.BytesIO(contents), **self.kwargs)
        out = []
        for el in raw:
            meta = (
                el.metadata.to_dict()
                if getattr(el, "metadata", None) is not None
                else {}
            )
            out.append(
                Element(
                    str(el),
                    getattr(el, "category", "NarrativeText"),
                    meta.get("page_number"),
                    meta,
                )
            )
        return out


class ParseUnstructured(UnstructuredParser):
    """Deprecated alias kept from older reference versions."""


# ---------------------------------------------------------------------------
# PDF
# ---------------------------------------------------------------------------

_HYPHEN_BREAK = re.compile(r"(\w)-\n(\w)")
_LINE_WRAP = re.compile(r"(?<![.!?:;])\n(?!\n)")


def clean_pdf_text(text: str) -> str:
    """Extracted-PDF cleanup (reference: PypdfParser's cleanup pass):
    rejoin hyphenated line breaks, unwrap mid-sentence newlines, collapse
    runs of spaces, keep paragraph breaks."""
    text = _HYPHEN_BREAK.sub(r"\1\2", text)
    text = _LINE_WRAP.sub(" ", text)
    lines = [" ".join(ln.split()) for ln in text.split("\n")]
    return "\n".join(ln for ln in lines if ln).strip()


_PDF_STREAM = re.compile(rb"stream\r?\n(.*?)endstream", re.S)
_PDF_TEXT_OP = re.compile(
    rb"\((?:[^()\\]|\\.)*\)\s*Tj|\[((?:[^\[\]\\]|\\.)*)\]\s*TJ", re.S
)
_PDF_STR = re.compile(rb"\((?:[^()\\]|\\.)*\)", re.S)


def _pdf_unescape(raw: bytes) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            mapped = {
                b"n": "\n", b"r": "\r", b"t": "\t",
                b"(": "(", b")": ")", b"\\": "\\",
            }.get(nxt)
            if mapped is not None:
                out.append(mapped)
                i += 2
                continue
            if nxt in b"01234567":  # octal escape: 1-3 octal digits
                j = 1
                while j < 3 and raw[i + 1 + j : i + 2 + j] in (
                    b"0", b"1", b"2", b"3", b"4", b"5", b"6", b"7",
                ):
                    j += 1
                out.append(chr(int(raw[i + 1 : i + 1 + j], 8) & 0xFF))
                i += 1 + j
                continue
            # unknown escape (incl. \8, \9): backslash is dropped
            out.append(nxt.decode("latin-1"))
            i += 2
            continue
        out.append(c.decode("latin-1"))
        i += 1
    return "".join(out)


def extract_pdf_text_builtin(contents: bytes) -> List[str]:
    """Minimal text extraction for simple PDFs: inflate Flate streams,
    read Tj/TJ show-text operators per content stream.  Covers plain
    generator output (our test fixtures, simple exports); complex
    encodings need pypdf."""
    import zlib

    pages: List[str] = []
    for m in _PDF_STREAM.finditer(contents):
        data = m.group(1)
        if b"Tj" not in data and b"TJ" not in data:
            try:
                data = zlib.decompress(data)
            except Exception:  # noqa: BLE001 — not Flate / not text
                continue
        if b"Tj" not in data and b"TJ" not in data:
            continue
        parts: List[str] = []
        for op in _PDF_TEXT_OP.finditer(data):
            if op.group(1) is not None:  # TJ array: strings + kern numbers
                for s in _PDF_STR.finditer(op.group(1)):
                    parts.append(_pdf_unescape(s.group(0)[1:-1]))
            else:
                s = _PDF_STR.search(op.group(0))
                if s:
                    parts.append(_pdf_unescape(s.group(0)[1:-1]))
        if parts:
            pages.append("\n".join(parts))
    return pages


class PypdfParser(UDF):
    """reference: parsers.py PypdfParser:1019-1093 — pypdf extraction +
    cleanup pass; built-in extractor for simple PDFs when pypdf is
    absent."""

    def __init__(self, apply_text_cleanup: bool = True):
        super().__init__(return_type=list, deterministic=True)
        self.apply_text_cleanup = apply_text_cleanup

        def parse(contents: bytes) -> list:
            texts = self._extract(contents)
            out = []
            for i, text in enumerate(texts):
                if self.apply_text_cleanup:
                    text = clean_pdf_text(text)
                out.append((text, {"page": i}))
            return out

        self.func = parse

    def _extract(self, contents: bytes) -> List[str]:
        try:
            import io

            from pypdf import PdfReader
        except ImportError:
            return extract_pdf_text_builtin(contents)
        reader = PdfReader(io.BytesIO(contents))
        return [page.extract_text() or "" for page in reader.pages]


class DoclingParser(UDF):
    """reference: parsers.py DoclingParser:334-672 — requires docling
    (genuinely gated: the import is attempted at parse time)."""

    def __init__(self, chunk: bool = True, **converter_kwargs):
        super().__init__(return_type=list, deterministic=True)
        self.chunk = chunk
        self.converter_kwargs = converter_kwargs

        def parse(contents: bytes) -> list:
            try:
                from docling.document_converter import DocumentConverter
            except ImportError as exc:
                raise ImportError(
                    "DoclingParser requires the docling package"
                ) from exc
            import io

            converter = DocumentConverter(**self.converter_kwargs)
            result = converter.convert(io.BytesIO(contents))
            doc = result.document
            if self.chunk:
                try:
                    from docling.chunking import HybridChunker

                    chunks = HybridChunker().chunk(doc)
                    return [
                        (c.text, dict(getattr(c, "meta", {}) or {}))
                        for c in chunks
                    ]
                except ImportError:
                    pass
            return [(doc.export_to_markdown(), {})]

        self.func = parse


class ImageParser(UDF):
    """reference: parsers.py ImageParser:676 — vision-LLM description of
    images. The image decodes via PIL (dimensions/format land in the chunk
    metadata); the text is the configured LLM's description of the
    base64-encoded image, so any chat wrapper with vision support (or a
    test fake) plugs in."""

    def __init__(self, llm=None, prompt: str | None = None, **kwargs):
        super().__init__(return_type=list, deterministic=False)
        self.llm = llm
        self.prompt = prompt or "Describe this image."

        def parse(contents: bytes) -> list:
            import base64
            import io

            meta: dict = {}
            mime = "image/png"
            try:
                from PIL import Image

                with Image.open(io.BytesIO(contents)) as img:
                    meta = {
                        "width": img.width,
                        "height": img.height,
                        "format": img.format,
                    }
                    if img.format:
                        mime = f"image/{img.format.lower()}"
            except Exception:  # noqa: BLE001 — undecodable: still try llm
                pass
            if self.llm is None:
                raise ValueError(
                    "ImageParser needs llm= (a vision-capable chat wrapper)"
                )
            b64 = base64.b64encode(contents).decode()
            messages = [
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": self.prompt},
                        {
                            "type": "image_url",
                            "image_url": {
                                "url": f"data:{mime};base64,{b64}"
                            },
                        },
                    ],
                }
            ]
            text = self.llm.func(messages)
            if inspect.isawaitable(text):
                import asyncio
                import concurrent.futures

                try:
                    asyncio.get_running_loop()
                except RuntimeError:
                    text = asyncio.run(text)
                else:
                    with concurrent.futures.ThreadPoolExecutor(1) as pool:
                        text = pool.submit(asyncio.run, text).result()
            return [(text, meta)]

        self.func = parse


class SlideParser(ImageParser):
    """reference: parsers.py SlideParser:830."""
