"""The calls as a table and the VCF rewrite as one native pass, against the
reference's per-site loops (the JAX package's ``finalize_calls``, which
keys every call by 'chromname$localpos' in a dict, and its
``write_calls_vcf``, which rewrites line by line).

The native pass must write the loop's bytes for every input the loop
accepts, and decline where the loop raises, so that the port's
``write_calls_vcf`` then raises as the loop does. The port's own loop
(``rewrite_loop``, the fallback) is held to the same bytes.
"""

import os

import numpy as np
import pytest

from vargeno_tpu.finalize import finalize_calls as ref_finalize_calls
from vargeno_tpu.finalize import global_to_chrom
from vargeno_tpu.io.vcf_writer import write_calls_vcf as ref_rewrite
from vargeno_tpu.model.calling import call_genotypes as ref_call_genotypes
from vargeno_tpu_torch import native
from vargeno_tpu_torch.config import GTYPE_NONE, GenoConfig
from vargeno_tpu_torch.finalize import CallTable, finalize_calls, locate
from vargeno_tpu_torch.io import vcf_writer


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native library unavailable (no g++)")


def table(names, rows):
    """A CallTable of rows (chrom, local, genotype char, gq)."""
    c, p, g, q = zip(*rows) if rows else ((), (), (), ())
    return CallTable(tuple(names), np.array(c, np.int32),
                     np.array(p, np.int64),
                     np.array([ord(x) for x in g], np.uint8),
                     np.array(q, np.int32))


def calls_dict(names, rows):
    """The reference's map of the same rows, built in row order."""
    return {f"{names[c]}${p}": (g, q) for c, p, g, q in rows}


def run_reference(path, out, names, rows):
    """(output bytes, None) or (None, exception type) of the reference's
    loop."""
    try:
        ref_rewrite(path, out, calls_dict(names, rows))
    except Exception as e:   # the loop's error is the expected outcome
        return None, type(e)
    with open(out, "rb") as f:
        return f.read(), None


def check(tmp_path, data: bytes, names, rows, expect_native=True):
    """Native pass, the port's entry and its fallback against the
    reference's loop on one input."""
    src = str(tmp_path / "in.vcf")
    with open(src, "wb") as f:
        f.write(data)
    want, err = run_reference(src, str(tmp_path / "ref.vcf"), names, rows)
    t = table(names, rows)
    got = native.vcf_rewrite(data, t.names, t.chrom, t.pos, t.gchar, t.gq)
    out = str(tmp_path / "out.vcf")
    if err is not None:
        assert got is None   # the pass declines where the loop raises
        with pytest.raises(err):
            vcf_writer.write_calls_vcf(src, out, t)
        with pytest.raises(err):
            vcf_writer.rewrite_loop(src, out, t.as_dict())
        return err
    if expect_native:
        assert got is not None
    if got is not None:
        assert bytes(got) == want
    path = vcf_writer.write_calls_vcf(src, out, t)
    assert path == ("native" if got is not None else "fallback")
    with open(out, "rb") as f:
        assert f.read() == want
    vcf_writer.rewrite_loop(src, out, t.as_dict())
    with open(out, "rb") as f:
        assert f.read() == want
    return path


HEAD = (b"##fileformat=VCFv4.0\n"
        b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
WIDE_HEAD = (b"##fileformat=VCFv4.0\n"
             b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
FMT_HEAD = (b'##fileformat=VCFv4.0\n'
            b'##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
            b'##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="GQ">\n'
            b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")


def row(chrom, pos, *rest):
    cols = [chrom, pos, "rs1", "A", "C", ".", ".", "RS=1"] + list(rest)
    return "\t".join(cols).encode()


NAMES = ["chr1", "chr2", "3", "c4"]
ROWS = [(0, 5, "0", 40), (0, 7, "1", 12), (1, 5, "2", 3), (2, 9, "1", 7),
        (3, 11, "0", 0)]

# (name, input bytes, names, rows, native expected): each outcome against
# the reference's loop, which raises on the last cases
CASES = [
    ("chromosomes_and_prefixes", HEAD + b"\n".join([
        row("chr1", "5"), row("1", "7"), row("chr2", "5"), row("2", "6"),
        row("3", "9"), row("c4", "11"), row("chr3", "9")]) + b"\n",
     NAMES, ROWS, True),
    ("crlf_lone_cr_blank", HEAD.replace(b"\n", b"\r\n") + row("chr1", "5")
     + b"\r\n\r\n" + row("1", "7") + b"\r\r" + row("chr2", "5") + b"\n\n"
     + row("chr1", "6") + b"\r", NAMES, ROWS, True),
    ("no_final_newline", HEAD + row("chr1", "5") + b"\n" + row("chr1", "7"),
     NAMES, ROWS, True),
    ("uncalled_and_duplicate_keys", HEAD + row("chr1", "5") + b"\n"
     + row("chr1", "6") + b"\n" + row("chr2", "5") + b"\n",
     ["chr1", "chr2", "chr1"],
     [(0, 5, "0", 1), (0, 5, "2", 2), (1, 5, "1", 3), (2, 5, "1", 99)],
     True),
    ("pos_as_text", HEAD + b"\n".join([
        row("chr1", "007"), row("chr1", "7"), row("chr1", "+7"),
        row("chr1", " 7"), row("chr1", "0"), row("chr1", "00"),
        row("chr1", "")]) + b"\n",
     ["chr1"], [(0, 7, "1", 5), (0, 0, "2", 6)], True),
    ("past_last_chromosome", HEAD + row("chr2", "130") + b"\n",
     ["chr1", "chr2"],
     [(1, 130, "2", 9)], True),
    ("dollar_in_names", HEAD + row("chrA$B", "5") + b"\n"
     + row("chrA", "B$5") + b"\n" + row("chrA", "5$") + b"\n",
     ["chrA$B", "chrA"], [(0, 5, "1", 8), (1, 5, "0", 4)], True),
    ("wide_header", WIDE_HEAD + row("chr1", "5", "DP", "7") + b"\n"
     + row("chr1", "7", "DP", "7", "x", "y") + b"\n", NAMES, ROWS, True),
    ("declared_gt_gq", FMT_HEAD + row("chr1", "5", "GT:GQ:DP", "./.:.:9")
     + b"\n" + row("chr1", "7", "GT:GQ:DP", "0/0:1") + b"\n"
     + row("chr2", "5", "DP:GQ:GT", "1:2:3:4", "z") + b"\n",
     NAMES, ROWS, True),
    ("declared_gt_only", FMT_HEAD.replace(b"ID=GQ,", b"ID=DP,")
     + row("chr1", "5", "DP:GT", "3:0/0") + b"\n", NAMES, ROWS, True),
    ("header_after_rows", WIDE_HEAD + row("chr1", "5", "DP", "7")
     + b"\n#again\n" + row("chr1", "7", "DP", "7") + b"\n", NAMES, ROWS,
     True),
    ("gt_declared_after_rows", WIDE_HEAD + row("chr1", "5", "DP", "7")
     + b"\n##x=ID=GT,\n" + row("chr1", "7", "DP:GT", "3:x") + b"\n",
     NAMES, ROWS, True),
    ("negative_gq", HEAD + row("chr1", "5") + b"\n", ["chr1"],
     [(0, 5, "0", -17)], True),
    ("empty_input", b"", NAMES, ROWS, True),
    ("headers_outgrow_the_first_buffer", b"#\n" * 3000 + row("chr1", "5")
     + b"\n", NAMES, ROWS, True),
    ("no_calls", HEAD + row("chr1", "5") + b"\n", NAMES, [], True),
    ("utf8_name_falls_back", HEAD + row("chr\u00e9", "5") + b"\n",
     ["chr\u00e9"], [(0, 5, "1", 1)], False),
    ("row_without_tab", HEAD + b"chr1\n", NAMES, ROWS, False),
    ("format_without_gt", FMT_HEAD + row("chr1", "5", "DP", "3") + b"\n",
     NAMES, ROWS, False),
    ("gt_past_info", FMT_HEAD + row("chr1", "5", "GT:GQ", "") + b"\n",
     NAMES, ROWS, False),
    ("short_called_row", b"#" + b"\t".join([b"c"] * 10) + b"\n"
     + row("chr1", "5") + b"\n", NAMES, ROWS, False),
    ("not_utf8", HEAD + row("chr1", "5") + b"\xff\n", NAMES, ROWS, False),
    ("gt_declared_then_narrow_row", HEAD + b"##x=ID=GT,\n" + row("chr1", "5")
     + b"\n", NAMES, ROWS, False),
]
RAISES = {"row_without_tab": IndexError, "gt_past_info": IndexError,
          "short_called_row": IndexError,
          "gt_declared_then_narrow_row": IndexError,
          "format_without_gt": ValueError, "not_utf8": UnicodeDecodeError}


@pytest.mark.parametrize("name,data,names,rows,expect_native", CASES,
                         ids=[c[0] for c in CASES])
def test_native_rewrite_matches_loop(lib, tmp_path, name, data, names, rows,
                                     expect_native):
    out = check(tmp_path, data, names, rows, expect_native)
    assert out == RAISES.get(name, "native" if expect_native else "fallback")


def random_vcf(rng, names):
    """A VCF of random shape, mostly of the forms the loop accepts, and
    the rows to call on it."""
    ends = [b"\n", b"\r\n", b"\r"]
    lines = [b"##fileformat=VCFv4.0"]
    wide = bool(rng.integers(0, 2))
    # GT / GQ declared: most such files carry the FORMAT column
    declare = int(rng.integers(0, 4)) if wide or rng.random() < 0.1 else 0
    if declare & 1:
        lines.append(b"##FORMAT=<ID=GT,Number=1>")
    if declare & 2:
        lines.append(b"##FORMAT=<ID=GQ,Number=1>")
    lines.append(b"\t".join([b"#CHROM", b"POS", b"ID", b"REF", b"ALT",
                             b"QUAL", b"FILTER", b"INFO"]
                            + ([b"FORMAT", b"S1"] if wide else [])))
    chroms = names + ["1", "2", "cX", "chrZ", ""]
    fmts = [b"GT:GQ", b"GQ:GT:DP", b"DP", b"GT", b"GQ", b""]
    rows, seen = [], []
    for _ in range(rng.integers(0, 40)):
        r = rng.random()
        if r < 0.03:
            lines.append(b"")
            continue
        if r < 0.04:
            lines.append(b"##late=ID=GT," if rng.random() < 0.5 else b"#x")
            continue
        chrom = chroms[rng.integers(0, len(chroms))]
        p = int(rng.integers(0, 60))
        pos = str(p).encode()
        if rng.random() < 0.05:
            pos = b"0" + pos
        cols = [chrom.encode(), pos, b"rs", b"A", b"G", b".", b".", b"I"]
        if wide or rng.random() < 0.1:
            if rng.random() < 0.9:   # FORMAT holds what the header declares
                fmt = [f for f, bit in ((b"GT", 1), (b"GQ", 2), (b"DP", 4))
                       if declare & bit or rng.random() < 0.5]
                rng.shuffle(fmt)
                fmt = b":".join(fmt)
            else:
                fmt = fmts[rng.integers(0, len(fmts))]
            n_info = fmt.count(b":") + 1 if rng.random() < 0.9 else \
                int(rng.integers(0, 4))
            cols += [fmt, b":".join([b"x"] * n_info)]
            cols += [b"e"] * int(rng.integers(0, 2))
        if rng.random() < 0.01:
            cols = cols[:int(rng.integers(1, 4))]
        lines.append(b"\t".join(cols))
        seen.append((chrom, p))
    for chrom, p in seen:
        if rng.random() < 0.7:
            key = chrom if chrom.startswith("c") else "chr" + chrom
            if key in names:
                rows.append((names.index(key), p, "012"[rng.integers(0, 3)],
                             int(rng.integers(0, 100))))
    for _ in range(rng.integers(0, 4)):   # keys no line asks for
        rows.append((int(rng.integers(0, len(names))),
                     int(rng.integers(0, 60)), "1", 5))
    rng.shuffle(rows)
    data = b"".join(ln + ends[rng.integers(0, 3)] for ln in lines)
    if rng.random() < 0.2:
        data = data.rstrip(b"\r\n")
    return data, rows


def test_native_rewrite_fuzz(lib, tmp_path):
    rng = np.random.default_rng(20)
    outcomes = {}
    for i in range(200):
        names = ["chr1", "chr2", "chr1", "cX", "chr$"][:int(
            rng.integers(1, 6))]
        data, rows = random_vcf(rng, names)
        d = tmp_path / str(i)
        d.mkdir()
        out = check(d, data, names, rows, expect_native=False)
        outcomes[out] = outcomes.get(out, 0) + 1
    # the draw reaches both sides: inputs rewritten natively, and inputs
    # the loop rejects (and the pass declines)
    assert outcomes.get("native", 0) >= 100
    assert outcomes.get("fallback", 0) == 0
    assert sum(v for k, v in outcomes.items() if isinstance(k, type)) >= 3


def test_fallback_when_native_missing(tmp_path, monkeypatch):
    data = CASES[0][1]
    src = str(tmp_path / "in.vcf")
    with open(src, "wb") as f:
        f.write(data)
    want, _ = run_reference(src, str(tmp_path / "ref.vcf"), NAMES, ROWS)
    monkeypatch.setattr(native, "available", lambda: False)
    out = str(tmp_path / "out.vcf")
    assert vcf_writer.write_calls_vcf(src, out, table(NAMES, ROWS)) \
        == "fallback"
    with open(out, "rb") as f:
        assert f.read() == want


def boundary_chrlens(rng):
    n = int(rng.integers(1, 6))
    lens = rng.integers(0, 50, n)
    lens[rng.integers(0, n)] = 0 if n > 1 else lens[0]   # an empty one
    names = [f"chr{int(rng.integers(0, 4))}" for _ in range(n)]  # repeats
    return list(zip(names, (int(x) for x in lens)))


def boundary_positions(rng, chrlens):
    ends = np.cumsum([n for _, n in chrlens])
    pts = {0, 1}
    for e in ends.tolist():
        pts |= {e - 1, e, e + 1}
    pts |= {int(ends[-1]) + int(rng.integers(2, 30))}   # past the end
    pts |= set(rng.integers(0, int(ends[-1]) + 5, 20).tolist())
    return np.array(sorted(p for p in pts if p >= 0), np.int64)


def test_locate_matches_global_to_chrom():
    rng = np.random.default_rng(7)
    for _ in range(100):
        chrlens = boundary_chrlens(rng)
        pos = boundary_positions(rng, chrlens)
        chrom, local = locate([n for _, n in chrlens], pos)
        for p, c, loc in zip(pos.tolist(), chrom.tolist(), local.tolist()):
            assert (chrlens[c][0], loc) == global_to_chrom(chrlens, p)


@pytest.mark.parametrize("seed", range(4))
def test_call_table_matches_per_site_dict(seed):
    """The table against the reference's loop, which walks each site's
    chromosome and keys its call by string (last wins)."""
    rng = np.random.default_rng(100 + seed)
    cfg = GenoConfig()
    for _ in range(25):
        chrlens = boundary_chrlens(rng)
        pos = boundary_positions(rng, chrlens)
        pos = np.sort(np.concatenate([pos, pos[rng.random(pos.size) < 0.2]]))
        n = pos.size
        ref = rng.integers(0, 4, n).astype(np.uint8)
        alt = np.where(rng.random(n) < 0.1, ref,
                       (ref + 1) % 4).astype(np.uint8)
        rf = rng.integers(0, 256, n).astype(np.uint8)
        af = rng.integers(0, 256, n).astype(np.uint8)
        rc = rng.integers(0, cfg.max_cov + 3, n).astype(np.int32)
        ac = rng.integers(0, cfg.max_cov + 3, n).astype(np.int32)
        rc[rng.random(n) < 0.1] = 0
        ac[rc == 0] = 0
        want = ref_finalize_calls(chrlens, pos, ref, alt, rf, af, rc, ac,
                                  cfg)
        t = finalize_calls(chrlens, pos, ref, alt, rf, af, rc, ac, cfg)
        assert t.chrom.dtype == np.int32 and t.pos.dtype == np.int64
        assert t.gchar.dtype == np.uint8 and t.gq.dtype == np.int32
        # the same calls, in the same order (a dict keeps the order of
        # first insertion), one row a called site
        assert list(t.as_dict().items()) == list(want.items())
        sel = ref != alt
        called = ref_call_genotypes(
            np.minimum(rc[sel], cfg.max_cov), np.minimum(ac[sel], cfg.max_cov),
            rf[sel], af[sel], cfg).genotype != GTYPE_NONE
        assert t.chrom.shape == t.pos.shape == (int(called.sum()),)
        assert [global_to_chrom(chrlens, p) for p in pos[sel][called]] == \
            [(chrlens[c][0], p) for c, p in zip(t.chrom.tolist(),
                                                t.pos.tolist())]


def test_rewrite_of_the_fixture(lib, tmp_path):
    """The mini fixture's SNP VCF with calls on every site: the native
    pass writes the loop's bytes."""
    src = os.path.join(os.path.dirname(__file__), "fixtures", "mini",
                       "snps.vcf")
    with open(src, "rb") as f:
        data = f.read()
    keys = [ln.split(b"\t")[:2] for ln in data.splitlines()
            if ln and not ln.startswith(b"#")]
    names = sorted({k[0].decode() for k in keys})
    rows = [(names.index(c.decode()), int(p), "012"[i % 3], i)
            for i, (c, p) in enumerate(keys) if c.decode() in names]
    assert check(tmp_path, data, names, rows) == "native"


def test_table_read_and_edited_by_key(lib, tmp_path):
    """A caller may handle the table as the reference's map: iterate its
    keys, read a call by key and replace it; the rewrite writes the
    edit."""
    names, rows = NAMES + ["chr1"], ROWS + [(4, 7, "2", 30)]
    t, d = table(names, rows), calls_dict(names, rows)
    assert list(t) == list(d)
    assert all(t[k] == d[k] for k in d)
    for k in sorted(d)[::2]:
        t[k] = (t[k][0], t[k][1] + 1)
        d[k] = (d[k][0], d[k][1] + 1)
    assert t.as_dict() == d
    for k in ("chr1$07", "chr1$+7", "chr9$5", "chr1$8", "chr1"):
        with pytest.raises(KeyError):
            t[k]
    src = str(tmp_path / "in.vcf")
    with open(src, "wb") as f:
        f.write(CASES[0][1])
    ref_rewrite(src, str(tmp_path / "ref.vcf"), d)
    assert vcf_writer.write_calls_vcf(src, str(tmp_path / "out.vcf"), t) \
        == "native"
    assert (tmp_path / "out.vcf").read_bytes() == \
        (tmp_path / "ref.vcf").read_bytes()
