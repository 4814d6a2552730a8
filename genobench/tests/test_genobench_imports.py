"""No module a run or the reference loads is JAX's or the JAX
package's, and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from genobench import spec

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(imports=imports)],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=spec.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    mods = loaded("import genobench.run, genobench.harness, "
                  "genobench.control, genobench.reference.check\n"
                  "from genobench.run import load_reader\n"
                  "from genobench import spec\n"
                  "b = spec.load_benchmark()\n"
                  "[load_reader(m['name']) for m in b['end_to_end'] + "
                  "b['per_layer']]")
    assert not mods & {"jax", "jaxlib", "flax", "vargeno_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import genobench.reference.check")
    assert not mods & {"jax", "jaxlib", "flax", "vargeno_tpu",
                       "vargeno_tpu_torch", "torch"}
