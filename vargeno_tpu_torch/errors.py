"""Jax-free copy of ``vargeno_tpu/errors.py``.

User-input error types.

Malformed inputs (FASTQ records, VCF rows, index artifacts) raise
``InputError`` subclasses carrying an actionable message; the CLI catches
them and prints ``error: ...`` instead of a traceback. The reference's
behavior on the same inputs is an ``assert`` abort (util.c:15, qv.cc:533)
or silent garbage -- failing with a description is a deliberate
improvement, not a parity break (no well-formed input is affected).
"""


class InputError(ValueError):
    """Malformed user input (FASTQ / VCF / index artifact)."""


class FastqError(InputError):
    pass


class VcfError(InputError):
    pass


class IndexFormatError(InputError):
    pass
