"""Port of ``vargeno_tpu/io/vcf_writer.py``, over a call table.

VCF rewrite: inject GT:GQ calls into the input VCF.

Replicates the reference's rewrite loop (src/qv.cc:1628-1747) for the shape
it actually supports: an input VCF *without* existing GT/GQ FORMAT headers.
For that shape the reference injects two ##FORMAT lines before the #CHROM
line, appends FORMAT and DONOR columns when absent, drops uncalled rows, and
writes GT plus GQ = (int)(-10*ln(confidence)).

Divergence note: when the input VCF already declares ID=GT/ID=GQ FORMAT
headers and carries FORMAT columns, the reference's has_gt branch indexes
info_columns[gq_index] with gq_index still -1 (the condition at
src/qv.cc:1699 tests gt_index instead of gq_index) -- undefined behavior that
segfaults in practice (verified against the built binary). We implement the
evident intent instead: locate GT/GQ in the FORMAT column and replace them.

The calls come as ``finalize.CallTable``. The rewrite is one native pass
over the input's bytes (``native.vcf_rewrite``); where the native library
is missing, or the pass declines an input, the Python loop
(``rewrite_loop``) runs over the table's map instead, with the same bytes
out and the same errors.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .. import native

GT_HEADER = '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">'
GQ_HEADER = ('##FORMAT=<ID=GQ,Number=1,Type=Integer,'
             'Description="Genotype Quality">')


def write_calls_vcf(vcf_in: str, vcf_out: str, table) -> str:
    """Rewrite ``vcf_in`` into ``vcf_out`` with the calls of ``table`` (a
    ``finalize.CallTable``); returns the path that ran, "native" or
    "fallback" (the Python loop)."""
    if native.available():
        with open(vcf_in, "rb") as f:
            data = f.read()
        out = native.vcf_rewrite(data, table.names, table.chrom, table.pos,
                                 table.gchar, table.gq)
        if out is not None:
            with open(vcf_out, "wb") as f:
                f.write(out)
            return "native"
    rewrite_loop(vcf_in, vcf_out, table.as_dict())
    return "fallback"


def rewrite_loop(vcf_in: str, vcf_out: str,
                 calls: Dict[str, Tuple[str, int]]) -> None:
    """The reference's rewrite line by line; calls maps 'chrname$pos' ->
    (genotype char '0'|'1'|'2', gq int)."""
    has_gt = False
    has_gq = False
    gt_index = -1
    gq_index = -1
    head_has_gt_col = True

    with open(vcf_in) as fin, open(vcf_out, "w") as fout:
        for line in fin:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##"):
                fout.write(line + "\n")
                if "ID=GT," in line:
                    has_gt = True
                elif "ID=GQ," in line:
                    has_gq = True
                continue
            if line.startswith("#"):
                if not has_gt:
                    fout.write(GT_HEADER + "\n")
                    gt_index = 0
                if not has_gq:
                    fout.write(GQ_HEADER + "\n")
                    gq_index = 1
                head_columns = line.split("\t")
                if len(head_columns) < 10:
                    head_has_gt_col = False
                    line += "\tFORMAT\tDONOR"
                fout.write(line + "\n")
                continue

            columns = line.split("\t")
            chr_name = columns[0]
            if not chr_name.startswith("c"):
                chr_name = "chr" + chr_name
            key = chr_name + "$" + columns[1]
            got = calls.get(key)
            if got is None:
                continue  # uncalled SNPs are omitted (src/qv.cc:1674-1676)
            gchar, gq = got
            genotype_string = {"1": "0/1", "2": "1/1"}.get(gchar, "0/0")

            format_columns = (columns[8].split(":")
                              if head_has_gt_col and len(columns) > 9 else [])
            info_columns = (columns[9].split(":")
                            if head_has_gt_col and len(columns) > 9 else [])
            if has_gt and gt_index == -1:
                gt_index = format_columns.index("GT")
            if has_gq and gq_index == -1:
                gq_index = format_columns.index("GQ")

            if has_gt:
                info_columns[gt_index] = genotype_string
            else:
                format_columns.append("GT")
                info_columns.append(genotype_string)
            if has_gq:
                info_columns[gq_index] = str(gq)
            else:
                format_columns.append("GQ")
                info_columns.append(str(gq))

            new_format = ":".join(format_columns)
            new_info = ":".join(info_columns)
            if head_has_gt_col:
                columns[8] = new_format
                columns[9] = new_info
            else:
                columns.append(new_format)
                columns.append(new_info)
            fout.write("\t".join(columns) + "\n")
