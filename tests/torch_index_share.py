"""The port's view of the JAX session index (tests/conftest.py mini_index):
the port's dataclasses over the same numpy arrays, with no copy, so a test
worker holds one 1.2 GB Bloom filter and not two. Tier-1 runs six workers
in one machine's memory."""

import dataclasses

from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.index.bloom import BitVector
from vargeno_tpu_torch.index.dictgen import RefDict, SnpDict


def _shared(obj, cls):
    """``cls`` over the same field values as the dataclass ``obj``."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def port_view(j) -> store.VarGenoIndex:
    return store.VarGenoIndex(
        ref=_shared(j.ref, RefDict), snp=_shared(j.snp, SnpDict),
        ref_bf=_shared(j.ref_bf, BitVector),
        snp_bf=_shared(j.snp_bf, BitVector), chrlens=j.chrlens,
        sites=_shared(j.sites, store.SnpSites),
        snp_locations=j.snp_locations)
