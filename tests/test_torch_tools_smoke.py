"""``cmh_torch.tools.all_methods_smoke`` on the CPU: cmh_tpu's recipes, and
the JSON contract for all eight methods (a train step and a 4-direction
``valid`` each)."""

import json
import math

import pytest

from cmh_torch.tools import all_methods_smoke
from cmh_tpu.tools import all_methods_smoke as jax_smoke

METHODS = sorted(all_methods_smoke.RECIPES)


def test_recipes_are_cmh_tpus():
    assert all_methods_smoke.RECIPES == jax_smoke.RECIPES
    assert len(METHODS) == 8


@pytest.mark.parametrize("method", METHODS)
def test_json_contract(method):
    out = all_methods_smoke.run_method(method, device="cpu")
    assert set(out) == {"method", "ok", "backend", "device", "loss", "maps", "build_s",
                        "step1_s", "eval_s"}
    assert out["method"] == method and out["ok"] is True
    assert out["backend"] == "cpu" and out["device"] == "cpu"
    assert math.isfinite(out["loss"])
    assert len(out["maps"]) == 4 and all(0.0 <= m <= 1.0 for m in out["maps"])
    assert all(out[k] >= 0 for k in ("build_s", "step1_s", "eval_s"))


def test_main_prints_one_line(capsys):
    out = all_methods_smoke.main(["--method", "DSPH", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("@SMOKE@") and json.loads(line[len("@SMOKE@"):]) == out


def test_a_failing_method_reports_ok_false(monkeypatch, capsys):
    def broken(method, device):
        raise ValueError("no such thing")

    monkeypatch.setattr(all_methods_smoke, "run_method", broken)
    out = all_methods_smoke.main(["--method", "MITH", "--device", "cpu"])
    assert out == {"method": "MITH", "ok": False, "error": "ValueError: no such thing"}
    assert capsys.readouterr().out.startswith("@SMOKE@")
