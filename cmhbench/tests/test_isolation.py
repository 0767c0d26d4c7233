"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name; the reference loads nothing of the port; the load
generator loads no torch; a run without a card, or without the port,
prints no result."""

import json
import shutil
import subprocess
import sys

from cmhbench import spec
from cmhbench.common import forbidden_modules

HARNESS = ("cmhbench.run", "cmhbench.control", "cmhbench.sweep", "cmhbench.kinds.train",
           "cmhbench.kinds.search", "cmhbench.kinds.valid", "cmhbench.layer",
           "cmhbench.methods.dcmht")


def _modules_after(imports, extra: str = "") -> set:
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in imports) + extra
            + "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_modules(["cmh_torch", "cmh_torch.ops", "cmh_tpuish", "jaxtyping",
                              "flaxen.x"]) == []
    assert forbidden_modules(["cmh_tpu.ops.hamming", "jax.numpy", "jaxlib", "flax.linen",
                              "torch"]) == ["cmh_tpu", "flax", "jax", "jaxlib"]


def test_the_harness_loads_nothing_of_jax():
    readers = ("from cmhbench import spec\n"
               "for m in spec.load()['per_layer']:\n    spec.reader(m['name'])\n")
    mods = _modules_after(HARNESS + ("cmh_torch.runners.dcmht", "cmh_torch.server",
                                     "cmh_torch.serving", "cmh_torch.export"), readers)
    assert "cmh_torch" in mods and forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules_after(("cmhbench.reference.clip", "cmhbench.reference.training",
                           "cmhbench.reference.dcmht", "cmhbench.reference.retrieval",
                           "cmhbench.reference.tokenizer"))
    assert not {m.split(".")[0] for m in mods} & {"cmh_torch", "cmh_tpu", "jax", "flax"}


def test_the_load_generator_loads_no_torch():
    mods = _modules_after(("cmhbench.loadgen",))
    assert "torch" not in mods and "numpy" not in mods


def test_a_run_without_a_card_or_without_the_port_prints_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.PKG, tmp_path / "cmhbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (spec.ROOT, tmp_path):
        out = subprocess.run([sys.executable, "-m", "cmhbench.run", "--workload",
                              "dcmht-vitb32-valid", "--seed", "2147483905", "--seconds", "1"],
                             cwd=where, capture_output=True, text=True, timeout=300)
        if where == spec.ROOT and out.returncode == 0:
            continue      # a machine with a card runs it
        assert out.returncode != 0 and out.stdout.strip() == ""
