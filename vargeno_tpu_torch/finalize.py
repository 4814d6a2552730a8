"""Jax-free copy of ``vargeno_tpu/finalize.py``.

Shared final stage: pileup counts -> genotype calls -> output VCF map.

Mirrors the call loop (src/qv.cc:1573-1626): for every pileup entry with
ref != alt, in ascending position order, call the genotype model and key the
result by 'chromname$localpos' using the .chrlens chromosome table (the
chromosome walk uses `index > len`, src/qv.cc:1592).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .config import GTYPE_ALT, GTYPE_HET, GTYPE_NONE, GTYPE_REF, GenoConfig
from .model.calling import call_genotypes


def global_to_chrom(chrlens: List[Tuple[str, int]], index: int
                    ) -> Tuple[str, int]:
    j = 0
    while j < len(chrlens) and index > chrlens[j][1]:
        index -= chrlens[j][1]
        j += 1
    name = chrlens[j][0] if j < len(chrlens) else chrlens[-1][0]
    return name, index


def finalize_calls(chrlens, site_pos: np.ndarray, site_ref: np.ndarray,
                   site_alt: np.ndarray, site_rf: np.ndarray,
                   site_af: np.ndarray, ref_cnt: np.ndarray,
                   alt_cnt: np.ndarray, config: GenoConfig
                   ) -> Dict[str, Tuple[str, int]]:
    """site arrays must be ascending in position; counts already saturated
    semantics are handled here via clipping (increments are monotone)."""
    sel = site_ref != site_alt
    r = np.clip(ref_cnt[sel], 0, config.max_cov)
    a = np.clip(alt_cnt[sel], 0, config.max_cov)
    calls = call_genotypes(r, a, site_rf[sel], site_af[sel], config)
    out: Dict[str, Tuple[str, int]] = {}
    gchar = {GTYPE_REF: "0", GTYPE_HET: "1", GTYPE_ALT: "2"}
    for p, g, q in zip(site_pos[sel], calls.genotype, calls.gq):
        if g == GTYPE_NONE:
            continue
        name, local = global_to_chrom(chrlens, int(p))
        out[f"{name}${local}"] = (gchar[int(g)], int(q))
    return out
