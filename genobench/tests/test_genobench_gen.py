"""The generator writes the same bytes for a seed and other bytes for
another, at the same sizes."""

import hashlib
import os

import numpy as np
import pytest

from genobench import gen
from genobench.reference.oracle import QUALITY_SCORE
from genobench.tests.tiny import CELLS, tiny_cell


def digests(cell, seed, tmp):
    os.makedirs(tmp, exist_ok=True)
    p = gen.make_inputs(seed, cell.config, cell.mix, str(tmp))
    out = []
    for path in (p.fasta, p.vcf, p.fastq):
        with open(path, "rb") as f:
            data = f.read()
        out.append((hashlib.sha256(data).hexdigest(), data.count(b"\n")))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_bytes(name, tmp_path):
    cell = tiny_cell(name)
    a = digests(cell, 2**31 + 5, tmp_path / "a")
    b = digests(cell, 2**31 + 5, tmp_path / "b")
    c = digests(cell, 17, tmp_path / "c")
    assert a == b
    for x, y in zip(a, c):
        assert x[0] != y[0]   # other bytes
        assert x[1] == y[1]   # the same lines: the same sizes


def test_fastq_shape(tmp_path):
    cell = tiny_cell(CELLS[0])
    p = gen.make_inputs(3, cell.config, cell.mix, str(tmp_path))
    with open(p.fastq, "rb") as f:
        lines = f.read().split(b"\n")[:-1]
    assert len(lines) == 4 * gen.n_reads(cell.config, cell.mix)
    seqs, quals = lines[1::4], lines[3::4]
    assert {len(s) for s in seqs} == {cell.mix["read_len"]}
    assert set(b"".join(seqs)) <= set(b"ACGT")
    hi, lo, _, _ = gen.quality_levels(cell.mix)
    q = b"".join(quals)
    assert set(q) == {hi, lo}
    # the low level lies below the neighbour search's threshold, the high
    # one at or above it; the low share is the mix's, at every position
    assert lo < QUALITY_SCORE <= hi
    low = np.frombuffer(q, np.uint8).reshape(len(quals), -1) == lo
    assert abs(low.mean() - (1 - cell.mix["high_share"])) < 0.01
    assert abs(low[:, :3].mean() - (1 - cell.mix["high_share"])) < 0.02


def test_quality_levels():
    """The two levels' Phred errors average to the mix's error rate."""
    mix = {"high_q": 30, "high_share": 0.8, "error_rate": 0.0026}
    hi, lo, p_high, p_low = gen.quality_levels(mix)
    assert (hi, lo) == (33 + 30, 33 + 20)
    assert abs(0.8 * p_high + 0.2 * p_low - 0.0026) < 1e-12
    with pytest.raises(ValueError):
        gen.quality_levels(dict(mix, error_rate=0.0005))


def test_miscalls_follow_quality(tmp_path):
    """Reads carry the mix's error rate: against the genome they came
    from, a base differs where a SNP or a miscall put it."""
    cell = tiny_cell(CELLS[0])
    cfg = dict(cell.config, snps=1, families=None)
    mix = dict(cell.mix, rc_frac=0.0, coverage=40.0, error_rate=0.01)
    p = gen.make_inputs(7, cfg, mix, str(tmp_path))
    with open(p.fasta, "rb") as f:
        g = b"".join(f.read().split(b"\n")[1:])
    with open(p.fastq, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    gen_arr = np.frombuffer(g, np.uint8)
    L = mix["read_len"]
    win = np.lib.stride_tricks.sliding_window_view(gen_arr, L)
    # each read's start: its best match among the genome's windows of a
    # few of its k-mers is exact enough at 1 % error; count mismatches on
    # reads found by their first 24 bases
    index = {bytes(win[i, :24]): i for i in range(win.shape[0])}
    diffs = n = 0
    for s in seqs[:2000]:
        i = index.get(s[:24])
        if i is None:
            continue
        diffs += int((np.frombuffer(s, np.uint8) != win[i]).sum())
        n += L
    assert n > 1000 * L
    assert 0.006 < diffs / n < 0.014
