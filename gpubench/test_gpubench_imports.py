"""What the harness, the epoch mix's driver and the reference load, checked in
a fresh interpreter by whole top-level module names: no ``jax``, ``jaxlib``,
``flax`` or ``repro`` (``repro_torch`` is another name); the reference loads
nothing of the port either."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(imports: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


@pytest.mark.parametrize("imports,also_banned", [
    ("import gpubench.harness, gpubench.devtrace\n"
     "from gpubench import harness\n"
     "mix = json.loads((harness.HERE / 'mixes' / 'epoch.json').read_text())\n"
     "drv = harness.driver_of(mix)\n"
     "for d in ('end_to_end', 'layer_metrics', 'rooflines'):\n"
     "    for f in sorted((harness.HERE / d).glob('*.py')):\n"
     "        harness.load_module(f)\n", ()),
    ("import gpubench.reference.generators, gpubench.reference.triangles",
     ("repro_torch",)),
], ids=["harness_and_epoch_driver", "reference"])
def test_no_jax_and_no_reference_package(imports, also_banned):
    loaded = _loaded(imports)
    banned = {"jax", "jaxlib", "flax", "repro", *also_banned}
    assert not loaded & banned, sorted(loaded & banned)


def test_forbidden_modules_compares_whole_names():
    from gpubench import harness

    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "reprox"]) == []
    assert harness.forbidden_modules(["repro.core.csr", "jax._src",
                                      "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]
