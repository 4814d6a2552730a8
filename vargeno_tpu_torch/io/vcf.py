"""Jax-free copy of ``vargeno_tpu/io/vcf.py``.

VCF row parsing replicating the reference's dictgen semantics.

Mirrors make_snp_dict_from_vcf's line handling (src/dictgen.c:561-780):
tab splitting, 'chr' prefix normalization, single-base REF/ALT filters, and
the CAF allele-frequency extraction including its cross-line ``freq_index``
persistence quirk (src/dictgen.c:599-735: ``freq_index`` is searched per line
but *retained* from the previous line when a line has no CAF key).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional


@dataclasses.dataclass
class VcfRow:
    chrom: str       # raw CHROM column
    pos1: int        # 1-based POS
    ref: str         # raw REF column
    alt: str         # raw ALT column
    info: str        # raw INFO column
    line: str        # full raw line (for the rewrite path)


def iter_vcf_rows(path: str) -> Iterator[VcfRow]:
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line or line[0] == "#" or line[0] == "\n":
                continue
            cols = line.rstrip("\r\n").split("\t")
            if len(cols) < 8:
                cols = cols + [""] * (8 - len(cols))
            try:
                pos1 = int(cols[1])
            except ValueError as e:
                from ..errors import VcfError

                raise VcfError(
                    f"{path}:{lineno}: malformed VCF row -- POS column is "
                    f"{cols[1]!r}, expected an integer (columns must be "
                    f"tab-separated: CHROM POS ID REF ALT ...)") from e
            yield VcfRow(
                chrom=cols[0], pos1=pos1, ref=cols[3], alt=cols[4],
                info=cols[7], line=line)


def _split_info_tokens_slow(info: str):
    """Literal character-walk mirror of vcf_split_line (the executable spec;
    kept as the oracle for split_info_tokens' property test)."""
    tokens = []
    i = 0
    n = len(info)
    while i < n and info[i] not in " \t\n":
        start = i
        while i < n and info[i] not in ";=":
            if info[i] in " \t\n":
                break
            i += 1
        tokens.append((info[start:i], start))
        i += 1
    return tokens


def split_info_tokens(info: str):
    """Mirror of vcf_split_line (src/dictgen.c:542-558): token start offsets
    of substrings delimited by ';' or '=' within the INFO field, stopping at
    the first whitespace.

    Returns a list of (token_text, start_offset) pairs, where token_text runs
    to the next delimiter (the C code stores bare pointers; consumers like
    atof stop at the first non-numeric char themselves). Equivalent to
    ``_split_info_tokens_slow`` but via C-speed str.split (INFO fields at
    dbSNP scale make the per-character walk the parse bottleneck); INFO
    containing whitespace (spec-invalid, quirky C handling) falls back to
    the literal walker.
    """
    if not info:
        return []
    if " " in info or "\t" in info or "\n" in info:
        return _split_info_tokens_slow(info)
    tokens = []
    start = 0
    for part in info.replace("=", ";").split(";"):
        tokens.append((part, start))
        start += len(part) + 1
    if info[-1] in ";=":
        tokens.pop()
    return tokens


def _atof_prefix(s: str) -> float:
    """C atof: parse the longest numeric prefix, 0.0 if none."""
    i = 0
    n = len(s)
    if i < n and s[i] in "+-":
        i += 1
    seen_digit = False
    while i < n and s[i].isdigit():
        i += 1
        seen_digit = True
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit():
            i += 1
            seen_digit = True
    if seen_digit and i < n and s[i] in "eE":
        j = i + 1
        if j < n and s[j] in "+-":
            j += 1
        if j < n and s[j].isdigit():
            while j < n and s[j].isdigit():
                j += 1
            i = j
    return float(s[:i]) if seen_digit else 0.0


class CafExtractor:
    """Stateful CAF=p,q extractor with the reference's persistence quirk.

    Reference behavior per line (src/dictgen.c:707-735): tokenize INFO; scan
    all tokens for one equal to "CAF" (prefix match); if found, freq_index is
    set to the *following* token. If never found on any line so far
    (freq_index still -1), has_freq becomes false permanently and all later
    rows use 0.5/0.5. If found on an earlier line but absent on this one,
    the stale freq_index is used to read whatever token sits at that slot.
    freq2 is parsed from the text after the first ',' at-or-after the token
    start (the C code scans the raw line buffer for ',').
    """

    def __init__(self):
        self.freq_index = -1
        self.has_freq = True

    def extract(self, info: str) -> tuple[float, float]:
        freq1, freq2 = 0.5, 0.5
        if not self.has_freq:
            return freq1, freq2
        tokens = split_info_tokens(info)
        for i, (tok, _off) in enumerate(tokens):
            if tok.startswith("CAF"):
                self.freq_index = i + 1
        if self.freq_index == -1:
            self.has_freq = False
            return freq1, freq2
        if self.freq_index >= len(tokens):
            # C would read a NULL pointer here; only reachable with a stale
            # index beyond this line's token count. Treat as no-freq.
            return 0.0, 0.0
        tok, off = tokens[self.freq_index]
        freq1 = _atof_prefix(tok)
        comma = info.find(",", off)
        freq2 = _atof_prefix(info[comma + 1:]) if comma >= 0 else 0.0
        return freq1, freq2


def encode_freq(f: float) -> int:
    """(uint8_t)(freq * 0xff) with C float32 arithmetic
    (src/dictgen.c:737-738)."""
    import numpy as np

    v = np.float32(f) * np.float32(255.0)
    return int(np.uint8(v))
