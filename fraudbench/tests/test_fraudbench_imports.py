"""What the benchmark runs loads neither JAX nor the JAX package, nor
the repository's old bench and smoke scripts; its plain reference loads
nothing of the program under test. Modules are compared by their whole
top-level name (the port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from fraudbench.harness import FORBIDDEN, PORT, ROOT

RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import FOREST_SMALL, SEQUENCE_SMALL
from fraudbench.harness import run_cell
run_cell("forest_t100_exact.cards1m", 5, 0.5, True, device="cpu",
         overrides=FOREST_SMALL)
run_cell("sequence_k32.cards1m", 5, 0.5, False, device="cpu",
         overrides=SEQUENCE_SMALL)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import fraudbench.reference.forest, fraudbench.reference.sequence
import fraudbench.reference.tiered_store, fraudbench.reference.hashing
import fraudbench.gen.simulator, fraudbench.counts.step
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           tests=str(ROOT / "fraudbench"
                                                     / "tests"))],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_old_scripts():
    mods = _top_level(RUN)
    assert PORT in mods
    assert not mods & (set(FORBIDDEN) | {"bench", "chip_smoke"})


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(REFERENCE)
    assert not mods & (set(FORBIDDEN) | {PORT})
