"""Jax-free copy of ``vargeno_tpu/io/fasta.py``.

FASTA parsing with both of the reference's (different!) parser semantics.

The reference feeds its dictionaries and its Bloom filters from two separate
parsers whose behavior differs (SURVEY.md §6.1 item 12):

- ``parse_dict_style`` mirrors src/fasta_parser.c: sequence-record names are
  truncated at 64 chars / '|' / whitespace, and sequence characters are
  normalized to upper-case A/C/G/T with everything else mapped to N
  (src/fasta_parser.c:7-25,59-75).

- ``parse_bf_style`` mirrors BFGenerator::readFasta (src/generate_bf.cc:18-73):
  the name is the *full* header after '>', and the sequence is kept raw
  (case and unusual characters preserved).

Both are implemented on top of one raw scan so the file is read once.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.kmer import np_codes_from_bytes

MAX_GENOME_NAME_LENGTH = 64


@dataclasses.dataclass
class Seq:
    name: str          # dict-style truncated name
    full_name: str     # bf-style full header
    raw: bytes         # raw sequence bytes (newlines removed, case kept)

    @property
    def size(self) -> int:
        return len(self.raw)

    def codes_normalized(self) -> np.ndarray:
        """uint8 codes with non-ACGT mapped to N(4) — dict-parser view."""
        c = np_codes_from_bytes(self.raw)
        return np.where(c > 4, np.uint8(4), c)

    def codes_raw(self) -> np.ndarray:
        """uint8 codes where non-ACGTN stays 7 (BASE_X) — bf-parser view,
        where encode_kmer would abort on such characters (src/util.c:103)."""
        return np_codes_from_bytes(self.raw)


def _truncate_name(header: str) -> str:
    """Name truncation of src/fasta_parser.c:62-75."""
    out = []
    for ch in header:
        if ch == "|" or ch.isspace() or len(out) == MAX_GENOME_NAME_LENGTH:
            break
        out.append(ch)
    return "".join(out)


def parse_fasta(path: str) -> List[Seq]:
    seqs: List[Seq] = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        gt = data.find(b">", pos)
        if gt < 0:
            break
        nl = data.find(b"\n", gt)
        if nl < 0:
            nl = n
        header = data[gt + 1 : nl].decode("latin-1")
        nxt = data.find(b">", nl + 1)
        if nxt < 0:
            nxt = n
        body = data[nl + 1 : nxt].replace(b"\n", b"")
        # readFasta uses getline which also strips nothing else; parse_fasta
        # counts every non-'\n' char as sequence. Both keep '\r' etc.
        seqs.append(Seq(name=_truncate_name(header), full_name=header, raw=body))
        pos = nxt
    return seqs


def chrlens_text(seqs: List[Seq]) -> str:
    """The .chrlens sidecar: 'name length' per chromosome, dict-style names
    (reference: src/qv.cc:2344-2346)."""
    return "".join(f"{s.name} {s.size}\n" for s in seqs)


def parse_chrlens(path: str):
    """Load .chrlens; names truncated at 32 chars as in src/qv.cc:486-496."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            i = 0
            while i < len(line) and not line[i].isspace() and i < 32:
                i += 1
            name = line[:i]
            rest = line[i:].strip()
            out.append((name, int(rest.split()[0])))
    return out
