"""The port's package rules: cmh_torch imports neither jax, flax, msgpack
nor cmh_tpu, and no entry point runs on the CPU unless the caller asks for
it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import cmh_torch
names = [m.name for m in pkgutil.walk_packages(cmh_torch.__path__, "cmh_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "cmh_tpu"))
print(" ".join(names))
print(bad)
"""

# the modules of the training slices, each of which must import on its own
TRAINING_MODULES = {
    "cmh_torch.main", "cmh_torch.registry", "cmh_torch.utils.seed",
    "cmh_torch.utils.logger", "cmh_torch.data.dataset", "cmh_torch.data.builder",
    "cmh_torch.data.loader", "cmh_torch.ops.metrics", "cmh_torch.ops.map_bucketed",
    "cmh_torch.ops.map_kernel", "cmh_torch.optim.bert_adam", "cmh_torch.optim.partition",
    "cmh_torch.runners.base", "cmh_torch.runners.checkpoint", "cmh_torch.runners.dcmht",
    "cmh_torch.models.base", "cmh_torch.models.clip.loader", "cmh_torch.models.losses",
    "cmh_torch.models.baseline", "cmh_torch.models.dsph", "cmh_torch.models.dnph",
    "cmh_torch.ops.hungarian", "cmh_torch.runners.baseline", "cmh_torch.runners.dsph",
    "cmh_torch.runners.dnph", "cmh_torch.models.mith", "cmh_torch.models.twdh",
    "cmh_torch.runners.mith", "cmh_torch.runners.twdh", "cmh_torch.ops.hash_centers",
    "cmh_torch.native.hash_ops", "cmh_torch.native._build", "cmh_torch.utils.flax_msgpack",
    "cmh_torch.models.convert", "cmh_torch.serving", "cmh_torch.export",
    "cmh_torch.models.dimch", "cmh_torch.models.umoed", "cmh_torch.runners.dimch",
    "cmh_torch.runners.umoed", "cmh_torch.ops.distances", "cmh_torch.server",
    "cmh_torch.models.clip.api", "cmh_torch.models.clip.resnet", "cmh_torch.parallel.dp",
    "cmh_torch.runners.jax_checkpoint"}
# the random streams: JAX's threefry keys, flax's per-parameter init, the
# dropout kernel's wrapper
RANDOM_MODULES = {"cmh_torch.utils.prng", "cmh_torch.ops.random", "cmh_torch.models.flax_init"}
# the tools and the native image preprocessing
TOOL_MODULES = {
    "cmh_torch.native.image_ops", "cmh_torch.data.transforms",
    *(f"cmh_torch.tools.{t}" for t in (
        "build_index", "all_methods_smoke", "twdh_matrix", "profile_train", "profile_encode",
        "epoch_ab", "chip_microbench", "real_parity"))}


def test_import_pulls_in_no_jax_and_no_cmh_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names, bad = out.stdout.strip().splitlines()
    assert TRAINING_MODULES | TOOL_MODULES | RANDOM_MODULES <= set(names.split()), out.stdout
    assert len(names.split()) >= 30 and bad == "[]", out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_encoders(tmp_path):
    from cmh_torch.config import config_from_dict
    from cmh_torch.export import save_encoders
    from cmh_torch.models.dcmht import DCMHTModel

    cfg = config_from_dict({"model": {"clip_variant": "tiny"}, "run": {"output_dim": 8}})
    path = str(tmp_path / "enc.pt")
    save_encoders(DCMHTModel.from_config(cfg), cfg, path)
    return path


def test_entry_points_refuse_cpu_unless_asked(no_card, tmp_path):
    from cmh_torch import resolve_device
    from cmh_torch.export import load_encoders
    from cmh_torch.export import main as export_main
    from cmh_torch.models.clip import api
    from cmh_torch.server import main as server_main
    from cmh_torch.serving import RetrievalIndex

    enc = _tiny_encoders(tmp_path)
    idx = RetrievalIndex(8, device="cpu")
    idx.add(np.ones((3, 8), np.float32))
    idx.save(str(tmp_path / "index.npz"))
    cfg = os.path.join(ROOT, "configs", "DCMHT", "synthetic.yaml")
    for call in (lambda: resolve_device("cuda"),
                 lambda: RetrievalIndex(8),
                 lambda: RetrievalIndex.load(str(tmp_path / "index.npz")),
                 lambda: load_encoders(enc),
                 lambda: server_main(["--index", str(tmp_path / "index.npz")]),
                 lambda: export_main(["--config-file", cfg, "--out",
                                      str(tmp_path / "x.pt")]),
                 lambda: api.load("ViT-L/14")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, each runs
    assert resolve_device("cpu").type == "cpu"
    assert len(RetrievalIndex.load(str(tmp_path / "index.npz"), device="cpu")) == 3
    assert load_encoders(enc, device="cpu").device.type == "cpu"


def _tool_calls(tmp_path):
    """Each tool's ``main`` with its required arguments and no ``--device``."""
    from cmh_torch.tools import (all_methods_smoke, build_index, chip_microbench, epoch_ab,
                                 profile_encode, profile_train, real_parity, twdh_matrix)

    cfg = os.path.join(ROOT, "configs", "DCMHT", "synthetic.yaml")
    return {
        "build_index": lambda: build_index.main(["--config-file", cfg, "--model", "m.pt",
                                                 "--out-index", str(tmp_path / "g")]),
        "all_methods_smoke": lambda: all_methods_smoke.main(["--method", "DCMHT"]),
        "twdh_matrix": lambda: twdh_matrix.main(["--save-dir", str(tmp_path)]),
        "profile_train": lambda: profile_train.main(["--tiny"]),
        "profile_encode": lambda: profile_encode.main(["--tiny"]),
        "epoch_ab": lambda: epoch_ab.main(["--scale", "tiny"]),
        "chip_microbench": lambda: chip_microbench.main(["--quick"]),
        "real_parity": lambda: real_parity.main(["--data-root", str(tmp_path), "--dataset",
                                                 "coco", "--preflight-only"]),
    }


@pytest.mark.parametrize("tool", ["build_index", "all_methods_smoke", "twdh_matrix",
                                  "profile_train", "profile_encode", "epoch_ab",
                                  "chip_microbench", "real_parity"])
def test_tools_refuse_cpu_unless_asked(no_card, tmp_path, capsys, tool):
    """Without a card and without ``--device cpu`` every tool raises before
    it does any work, and prints nothing."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool_calls(tmp_path)[tool]()
    assert capsys.readouterr().out == ""
    assert not list(tmp_path.iterdir())


def test_export_cli_writes_loadable_encoders(tmp_path):
    from cmh_torch.export import load_encoders, main

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("model: {arch: DCMHT, clip_variant: tiny, hash_func: softmax}\n"
                   "run: {output_dim: 8}\n")
    out = str(tmp_path / "enc.pt")
    main(["--config-file", str(cfg), "--out", out, "--seed", "3", "--device", "cpu"])
    enc = load_encoders(out, device="cpu")
    codes = enc.encode_image(np.zeros((2, 32, 32, 3), np.float32))
    assert codes.shape == (2, 8) and set(np.unique(codes)) <= {-1.0, 1.0}
    with pytest.raises(ValueError, match="not a cmh_torch encoder file"):
        torch.save({"x": 1}, str(tmp_path / "bad.pt"))
        load_encoders(str(tmp_path / "bad.pt"), device="cpu")


def test_kernel_wrappers_take_plain_path_only_on_cpu():
    from cmh_torch.ops.attention import fused_attention
    from cmh_torch.ops.hamming import hamming_packed
    from cmh_torch.ops.layernorm import fused_layernorm

    from cmh_torch.ops.attention import attention_bwd
    from cmh_torch.ops.layernorm import layernorm_bwd
    from cmh_torch.ops.map_kernel import map_ap, map_hist
    from cmh_torch.ops.random import dropout, dropout_bwd, random_bits

    wrappers = (fused_layernorm, fused_attention, hamming_packed, layernorm_bwd,
                attention_bwd, map_hist, map_ap, random_bits, dropout, dropout_bwd)
    before = [w.launches for w in wrappers]
    x = torch.randn(2, 4, 8, requires_grad=True)
    fused_layernorm(x, torch.ones(8), torch.zeros(8)).sum().backward()
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    fused_attention(q, q, q, 0.5).sum().backward()
    hamming_packed(torch.zeros((1, 1), dtype=torch.int32),
                   torch.zeros((2, 1), dtype=torch.int32))
    words = torch.tensor([[0, 3, 2]], dtype=torch.uint8)
    hist, rhist = map_hist(words, 1)
    map_ap(words, torch.zeros_like(hist), torch.zeros_like(rhist),
           torch.ones(1, dtype=torch.int32))
    random_bits((0, 1), (5,))
    dropout(torch.randn(3, 4, requires_grad=True), (0, 1), 0.5).sum().backward()
    # plain versions on the CPU, forward and backward: no launch is counted
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="no layernorm kernel"):
        fused_layernorm(x.to("meta"), torch.ones(8, device="meta"),
                        torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="no dropout kernel"):
        dropout(torch.zeros(3, device="meta"), (0, 1), 0.5)
    with pytest.raises(ValueError, match="no threefry kernel"):
        random_bits((0, 1), (5,), device="meta")
