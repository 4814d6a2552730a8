"""Port of ``vargeno_tpu/finalize.py``, with the calls as an array table.

Shared final stage: pileup counts -> genotype calls -> the call table the
VCF rewrite reads.

Mirrors the call loop (src/qv.cc:1573-1626): for every pileup entry with
ref != alt, in ascending position order, call the genotype model and place
the site on its chromosome with the .chrlens table (the chromosome walk
uses `index > len`, src/qv.cc:1592). The reference keys each call by the
string 'chromname$localpos'; the table holds the same (chromosome, local
position) pairs as arrays, and the rewrite matches them in the same way
(``io/vcf_writer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from .config import GTYPE_ALT, GTYPE_HET, GTYPE_NONE, GTYPE_REF, GenoConfig
from .model.calling import call_genotypes

# genotype -> the character the reference writes into its call map
_GCHAR = np.zeros(256, np.uint8)
_GCHAR[[GTYPE_REF, GTYPE_HET, GTYPE_ALT]] = [ord("0"), ord("1"), ord("2")]


@dataclasses.dataclass
class CallTable:
    """The called sites in ascending site order; a (chromosome, local
    position) pair may repeat, and then the last row wins, as a later
    insert into the reference's map replaces an earlier one."""
    names: Tuple[str, ...]   # chromosome names, .chrlens order
    chrom: np.ndarray        # (n,) int32 index into ``names``
    pos: np.ndarray          # (n,) int64 local position
    gchar: np.ndarray        # (n,) uint8 genotype character, b'0'|b'1'|b'2'
    gq: np.ndarray           # (n,) int32

    def as_dict(self) -> Dict[str, Tuple[str, int]]:
        """The reference's map, 'chromname$localpos' -> (genotype char,
        GQ): what the Python rewrite reads."""
        return {f"{self.names[c]}${p}": (chr(g), q) for c, p, g, q in zip(
            self.chrom.tolist(), self.pos.tolist(), self.gchar.tolist(),
            self.gq.tolist())}

    # The table read and edited by the reference's keys, for a caller that
    # handles the calls as that map: a key names the last row of its
    # chromosome name and local position.
    def __iter__(self):
        return iter(self.as_dict())

    def _row(self, key: str) -> int:
        name, _, local = key.rpartition("$")
        if local.isascii() and local.isdigit() and str(int(local)) == local:
            ids = [i for i, n in enumerate(self.names) if n == name]
            hit = np.flatnonzero(np.isin(self.chrom, ids)
                                 & (self.pos == int(local)))
            if hit.size:
                return int(hit[-1])
        raise KeyError(key)

    def __getitem__(self, key: str) -> Tuple[str, int]:
        r = self._row(key)
        return chr(self.gchar[r]), int(self.gq[r])

    def __setitem__(self, key: str, call: Tuple[str, int]) -> None:
        r = self._row(key)
        self.gchar[r], self.gq[r] = ord(call[0]), call[1]


def locate(lens: Sequence[int], index: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(chromosome, local position) of global positions ``index`` over
    chromosome lengths ``lens``: the reference's walk, which leaves an
    index equal to a chromosome's length in that chromosome and puts an
    index past the last one in the last, with the surplus as its local
    position."""
    ends = np.cumsum(np.asarray(lens, np.int64))
    j = np.searchsorted(ends, index, side="left")
    starts = np.concatenate([[0], ends])
    return (np.minimum(j, len(ends) - 1).astype(np.int32),
            index - starts[j])


def finalize_calls(chrlens, site_pos: np.ndarray, site_ref: np.ndarray,
                   site_alt: np.ndarray, site_rf: np.ndarray,
                   site_af: np.ndarray, ref_cnt: np.ndarray,
                   alt_cnt: np.ndarray, config: GenoConfig) -> CallTable:
    """site arrays must be ascending in position; counts already saturated
    semantics are handled here via clipping (increments are monotone)."""
    sel = site_ref != site_alt
    r = np.clip(ref_cnt[sel], 0, config.max_cov)
    a = np.clip(alt_cnt[sel], 0, config.max_cov)
    calls = call_genotypes(r, a, site_rf[sel], site_af[sel], config)
    keep = calls.genotype != GTYPE_NONE
    chrom, local = locate([n for _, n in chrlens],
                          np.asarray(site_pos, np.int64)[sel][keep])
    return CallTable(tuple(name for name, _ in chrlens), chrom, local,
                     _GCHAR[calls.genotype[keep]],
                     calls.gq[keep].astype(np.int32))
