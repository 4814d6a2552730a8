"""The PyTorch port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "vargeno_tpu_torch", "vargeno_tpu_torch.cli",
    "vargeno_tpu_torch.config", "vargeno_tpu_torch.errors",
    "vargeno_tpu_torch.finalize", "vargeno_tpu_torch.testing",
    "vargeno_tpu_torch.core.kmer", "vargeno_tpu_torch.core.hashes",
    "vargeno_tpu_torch.io.fasta", "vargeno_tpu_torch.io.fastq",
    "vargeno_tpu_torch.io.vcf", "vargeno_tpu_torch.io.vcf_writer",
    "vargeno_tpu_torch.index.bloom", "vargeno_tpu_torch.index.build",
    "vargeno_tpu_torch.index.dictgen", "vargeno_tpu_torch.index.store",
    "vargeno_tpu_torch.model.calling", "vargeno_tpu_torch.native",
    "vargeno_tpu_torch.engine.scan_ops",
    "vargeno_tpu_torch.engine.hashtable",
    "vargeno_tpu_torch.engine.device_index",
    "vargeno_tpu_torch.engine.backend", "vargeno_tpu_torch.engine.batch",
    "vargeno_tpu_torch.engine.geno", "vargeno_tpu_torch.kernels.vote",
    "vargeno_tpu_torch.kernels._build", "vargeno_tpu_torch.kernels.gather",
    "vargeno_tpu_torch.tools", "vargeno_tpu_torch.tools.bench_gather",
    "vargeno_tpu_torch.utils", "vargeno_tpu_torch.utils.roofline",
    "vargeno_tpu_torch.utils.profiling",
    "vargeno_tpu_torch.engine.autotune",
    "vargeno_tpu_torch.engine.checkpoint",
    "vargeno_tpu_torch.engine.cohort", "vargeno_tpu_torch.index.filt",
    "vargeno_tpu_torch.index.ucsc", "vargeno_tpu_torch.engine.search",
    "vargeno_tpu_torch.dist", "vargeno_tpu_torch.dist.sharding",
    "vargeno_tpu_torch.dist.sharded_dict", "vargeno_tpu_torch.oracle",
    "vargeno_tpu_torch.dist.multihost",
    "vargeno_tpu_torch.engine.pileup_compact",
    "vargeno_tpu_torch.tools.fuzz_diff",
    "vargeno_tpu_torch.tools.rehearse_wgs",
    "vargeno_tpu_torch.tools.endurance_wgs",
    "vargeno_tpu_torch.tools.bench", "vargeno_tpu_torch.tools.bench_cohort",
    "vargeno_tpu_torch.tools.bench_index_build",
    "vargeno_tpu_torch.tools.bench_scaling",
    "vargeno_tpu_torch.tools.bench_scaling_mh",
    "vargeno_tpu_torch.tools.tune_host_pipeline",
]


@pytest.mark.parametrize("module", ["all", "chip_smoke", "gpu_tests",
                                    "tune_host_pipeline"])
def test_port_imports_no_jax(module):
    if module == "all":
        imports = "; ".join(f"import {m}" for m in MODULES)
    elif module == "gpu_tests":   # the card's machine runs them without jax
        imports = ("import sys; sys.path.insert(0, 'tests'); "
                   "import torch_index_share")
    elif module == "tune_host_pipeline":   # the sweep tool on its own
        imports = "import vargeno_tpu_torch.tools.tune_host_pipeline"
    else:
        imports = "import chip_smoke"
    code = (f"import sys; {imports}; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'vargeno_tpu.')) "
            "or m == 'vargeno_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
