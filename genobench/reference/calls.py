"""The reference's calls and output lines: VarGeno's genotype model
(choose_best_genotype, qv.cc:1789-1848) in float64, and the row its VCF
rewrite (qv.cc:1628-1747) writes for a called site.

  g0 = (1-e)^r e^a,  g1 = 0.5^(r+a),  g2 = e^r (1-e)^a      (e = 0.01)
  priors p^2, 1 - p^2 - q^2, q^2 with p, q = CAF bytes / 255
  GT = the strictly largest prior x likelihood (ties fall to ALT)
  GQ = (int)(-10 ln(posterior x Poisson(r + a; 7.1)))
  no call at (0, 0) and (63, 63)

``dtype`` = float32 computes the same in single precision (a control).
"""

from __future__ import annotations

import math

import numpy as np

ERR_RATE = 0.01
AVG_COV = 7.1
MAX_COV = 63
GT_TEXT = {1: "0/0", 3: "0/1", 2: "1/1"}   # REF, HET, ALT


def call(r, a, rf, af, dtype=np.float64):
    """(genotype 0 none / 1 ref / 2 alt / 3 het, GQ) arrays."""
    r = np.asarray(r, np.int64)
    a = np.asarray(a, np.int64)
    f = np.dtype(dtype).type
    e, one = f(ERR_RATE), f(1.0)
    rr, aa = r.astype(dtype), a.astype(dtype)
    g0 = np.power(one - e, rr) * np.power(e, aa)
    g1 = np.power(f(0.5), rr + aa)
    g2 = np.power(e, rr) * np.power(one - e, aa)
    p = np.asarray(rf, dtype) / f(255.0)
    q = np.asarray(af, dtype) / f(255.0)
    pg0, pg1, pg2 = p * p * g0, (one - p * p - q * q) * g1, q * q * g2
    total = pg0 + pg1 + pg2
    pois = np.array([math.exp(-AVG_COV) * AVG_COV ** i
                     / math.exp(math.lgamma(i + 1.0))
                     for i in range(2 * MAX_COV + 1)], dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        gt = np.where((pg0 > pg1) & (pg0 > pg2), 1,
                      np.where((pg1 > pg0) & (pg1 > pg2), 3, 2))
        conf = np.where(gt == 1, pg0, np.where(gt == 3, pg1, pg2)) / total
        conf = conf * pois[np.clip(r + a, 0, 2 * MAX_COV)]
        gq = np.where(conf > 0, -f(10.0) * np.log(conf), f(0.0))
    none = ((r == 0) & (a == 0)) | ((r == MAX_COV) & (a == MAX_COV))
    gt = np.where(none, 0, gt)
    gq = np.where(none, 0, gq.astype(np.int32))
    return gt, gq


def lines(snp_rows: list, counts: np.ndarray, rf, af,
          dtype=np.float64) -> list:
    """The output row of each site (None where it is not called), from its
    input VCF row, its (REF, ALT) counts and its CAF bytes."""
    gt, gq = call(np.minimum(counts[:, 0], MAX_COV),
                  np.minimum(counts[:, 1], MAX_COV), rf, af, dtype)
    return [None if g == 0 else f"{row}\tGT:GQ\t{GT_TEXT[int(g)]}:{int(q)}"
            for row, g, q in zip(snp_rows, gt.tolist(), gq.tolist())]
