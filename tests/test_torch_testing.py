"""The port's ``make_synthetic`` / ``build_synth_index`` against the JAX
package's: byte-identical FASTA, VCF and FASTQ from the same seed, and every
array of the two indexes equal (dictionaries, Bloom filters, sites, SNP
locations, chromosome lengths)."""

import dataclasses
import os

import numpy as np
import pytest

from vargeno_tpu import testing as j_testing
from vargeno_tpu_torch import testing
from vargeno_tpu_torch.tools.fuzz_diff import draw_case

CASES = {
    # tests/test_more_coverage.py's fixture: one chromosome, 160 bp reads
    21: dict(sizes=(30_000,), n_snps=25, n_reads=600, read_len=160),
    # the fuzz tool's draw for seed 3: two chromosomes, error rate 0.6
    3: draw_case(3, big=False)["synth"],
}


def _assert_same(a, b, path):
    if dataclasses.is_dataclass(a):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("seed", sorted(CASES))
def test_make_synthetic_matches_jax(seed, tmp_path):
    kw = CASES[seed]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = testing.make_synthetic(seed=seed, tmpdir=str(tmp_path / "port"),
                                 **kw)
    want = j_testing.make_synthetic(seed=seed, tmpdir=str(tmp_path / "jax"),
                                    **kw)
    for g, w in zip(got[1:], want[1:]):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as f, open(w, "rb") as h:
            assert f.read() == h.read(), os.path.basename(g)
    index, j_index = got[0], want[0]
    assert index.sites.pos.size > 0 and index.ref.kmers.size > 0
    assert len(index.chrlens) == len(kw["sizes"])
    _assert_same(index, j_index, "index")
