"""Pretrained CLIP checkpoints in cmh_torch against cmh_tpu's loader.

A tiny CLIP (``CLIPConfig.tiny()`` widths, seeded random weights) is written
three ways: a plain fp32 state dict, a plain fp16 state dict (the dtype of
OpenAI's files) and a TorchScript archive carrying OpenAI's three integer
entries. Each is read by both packages: the inferred geometry is
cmh_tpu's; every backbone tensor is the file's cast to fp32 and equals
cmh_tpu's ``load_backbone`` through ``clip_state_from_jax`` (exact); the
towers' outputs agree within 1e-5 relative (fp32, cmh_tpu's Pallas kernels
in interpret mode, only the order of fp32 sums differs).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

from cmh_torch.config import config_from_dict
from cmh_torch.models.base import resolve_clip_cfg
from cmh_torch.models.clip.loader import (NON_PARAMETER_KEYS, infer_config,
                                          load_backbone_state, read_torch_state_dict,
                                          save_torchscript_archive)
from cmh_torch.models.clip.model import CLIP, CLIPConfig
from cmh_torch.models.convert import clip_state_from_jax
from cmh_torch.runners.dcmht import DCMHTTrainer
from cmh_torch.utils import prng
from cmh_tpu.models.clip import loader as jax_loader

REL = 1e-5
FORMATS = ("fp32", "fp16", "torchscript")


def _weights():
    model = CLIP(CLIPConfig.tiny())
    model.init_weights(prng.PRNGKey(11))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each format's path and the fp32 tensors it must read back as."""
    root = tmp_path_factory.mktemp("clip")
    sd = _weights()
    ints = {"input_resolution": torch.tensor(32), "context_length": torch.tensor(16),
            "vocab_size": torch.tensor(49408)}
    out = {}
    torch.save(sd, root / "fp32.pt")
    out["fp32"] = (str(root / "fp32.pt"), sd)
    half = {k: v.half() for k, v in sd.items()}
    torch.save(half, root / "fp16.pt")
    out["fp16"] = (str(root / "fp16.pt"), {k: v.float() for k, v in half.items()})
    save_torchscript_archive({**half, **ints}, str(root / "openai.pt"))
    out["torchscript"] = (str(root / "openai.pt"), {k: v.float() for k, v in half.items()})
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("fmt", FORMATS)
def test_geometry_is_cmh_tpus(files, fmt):
    path, _ = files[fmt]
    cfg = infer_config(read_torch_state_dict(path), dtype=torch.float32)
    want = jax_loader.infer_config(jax_loader.read_torch_state_dict(path), dtype=jnp.float32)
    got = dataclasses.asdict(cfg)
    got.pop("dtype")
    assert got == {k: v for k, v in dataclasses.asdict(want).items() if k in got}
    assert cfg.transformer_heads == 64 // 64 and cfg.vision_heads == 1


@pytest.mark.parametrize("fmt", FORMATS)
def test_backbone_tensors_equal_the_file_and_cmh_tpus(files, fmt):
    path, want = files[fmt]
    sd = read_torch_state_dict(path)
    assert all(v.dtype == torch.float32 for v in sd.values())
    backbone = load_backbone_state(sd)
    # OpenAI's integer entries are read, and dropped from the backbone
    if fmt == "torchscript":
        assert set(NON_PARAMETER_KEYS) <= set(sd)
    assert not any(k[len("backbone."):] in NON_PARAMETER_KEYS for k in backbone)
    assert set(backbone) == {"backbone." + k for k in want}
    for k, v in want.items():
        assert torch.equal(backbone["backbone." + k], v), k
    _, _, jvars = jax_loader.load_backbone(path, dtype=jnp.float32)
    jsd = clip_state_from_jax(jax.tree_util.tree_map(np.asarray, jvars["params"]))
    assert set(jsd) == set(backbone)
    for k, v in jsd.items():
        assert torch.equal(backbone[k], v), k


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_outputs_match_cmh_tpu(files, fmt, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    path, _ = files[fmt]
    sd = read_torch_state_dict(path)
    port = CLIP(infer_config(sd, dtype=torch.float32))
    port.load_state_dict({k[len("backbone."):]: v for k, v in load_backbone_state(sd).items()})
    port.eval()
    jcfg, jmodule, jvars = jax_loader.load_backbone(path, dtype=jnp.float32)
    rng = np.random.RandomState(3)
    img = rng.randn(3, 32, 32, 3).astype(np.float32)
    txt = rng.randint(1, 49405, (3, 16)).astype(np.int32)
    txt[:, 0] = 49406
    kpm = np.zeros((3, 16), bool)
    for i, n in enumerate((6, 16, 9)):
        txt[i, n - 1] = 49407
        txt[i, n:] = 0
        kpm[i, n:] = True
    with torch.no_grad():
        img_out = port.encode_image(torch.from_numpy(img))
        txt_out = port.encode_text(torch.from_numpy(txt), torch.from_numpy(kpm))
    jimg = jmodule.apply(jvars, jnp.asarray(img), method=lambda m, x: m.encode_image(x))
    jtxt = jmodule.apply(jvars, jnp.asarray(txt), jnp.asarray(kpm),
                         method=lambda m, t, k: m.encode_text(t, k))
    for a, r in list(zip(img_out, jimg)) + list(zip(txt_out[:3], jtxt[:3])):
        assert a.shape == r.shape
        assert _rel(a.numpy(), r) <= REL


def _trainer_cfg(tmp_path, clip_path, variant=True):
    model = {"arch": "DCMHT", "clip_path": clip_path, "hash_func": "softmax"}
    if variant:
        model["clip_variant"] = "tiny"
    else:
        model["clip_dtype"] = "float32"
    return {
        "model": model,
        "optimizer": {"arch": "BertAdam", "lr": 0.002},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": "DCMHTTrainer", "save_dir": str(tmp_path), "log_dir": str(tmp_path / "log"),
                "output_dim": 8, "batch_size": 16, "train_num": 32, "query_num": 16,
                "epochs": 1, "display_step": 1000, "seed": 5},
    }


def test_heads_keep_their_seeded_init(files, tmp_path):
    """The load overwrites the backbone only: the heads equal a random-init
    trainer's, drawn from the same seed."""
    path, want = files["fp16"]
    loaded = DCMHTTrainer.from_config(cfg=config_from_dict(_trainer_cfg(tmp_path / "a", path)),
                                      device="cpu", auto_run=False)
    fresh = DCMHTTrainer.from_config(
        cfg=config_from_dict(_trainer_cfg(tmp_path / "b", "/nonexistent.pt")),
        device="cpu", auto_run=False)
    a, b = loaded.model.state_dict(), fresh.model.state_dict()
    heads = [k for k in a if not k.startswith("backbone.")]
    assert heads and all(torch.equal(a[k], b[k]) for k in heads)
    for k, v in want.items():
        assert torch.equal(a["backbone." + k], v), k
    assert not torch.equal(b["backbone.visual.proj"], want["visual.proj"])


def test_geometry_comes_from_the_checkpoint_after_tiny(files):
    path, _ = files["fp32"]
    assert resolve_clip_cfg({"clip_path": path}) == dataclasses.replace(
        infer_config(read_torch_state_dict(path)), dtype=torch.bfloat16)
    assert resolve_clip_cfg({"clip_path": path, "clip_variant": "tiny"}) == CLIPConfig.tiny()
    explicit = CLIPConfig.tiny(dtype=torch.bfloat16)
    assert resolve_clip_cfg({"clip_path": path}, explicit) is explicit
    assert resolve_clip_cfg({"clip_path": "/nonexistent.pt"}) == CLIPConfig()


def test_resnet_state_dict_raises_naming_the_item(tmp_path):
    """An RN checkpoint (OpenAI's layout: ``visual.*`` tower entries with
    torch's ``num_batches_tracked`` counters, beside the text tower's): the
    ViT entry points refuse it as cmh_tpu's ``infer_config`` does, naming
    ``resnet_config_from_state_dict``; that function reads its geometry as
    cmh_tpu's does, and ``load_resnet`` loads its tower."""
    from cmh_torch.models.clip.loader import (load_resnet, resnet_config_from_state_dict,
                                              resnet_state_dict)
    from cmh_torch.models.clip.resnet import ModifiedResNet

    geo = dict(layers=(1, 1, 1, 1), width=8, heads=4, input_resolution=32, output_dim=16)
    tower = ModifiedResNet(**geo).init_weights(torch.Generator().manual_seed(3))
    rn = {"visual." + k: v for k, v in tower.state_dict().items()}
    rn.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in rn if k.endswith("running_mean")})
    rn.update({k: v for k, v in _weights().items() if not k.startswith("visual.")})
    path = str(tmp_path / "rn.pt")
    torch.save(rn, path)
    sd = read_torch_state_dict(path)
    for call in (lambda: infer_config(sd), lambda: load_backbone_state(sd),
                 lambda: resolve_clip_cfg({"clip_path": path})):
        with pytest.raises(ValueError, match="RN checkpoint.*resnet_config_from_state_dict"
                                             ".*no hashing method uses"):
            call()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    with pytest.raises(AssertionError, match="RN checkpoint.*resnet_config_from_state_dict"
                                             ".*no hashing method uses"):
        jax_loader.infer_config(np_sd)
    state = resnet_state_dict(sd)
    assert not any("num_batches_tracked" in k or k.startswith("visual.") for k in state)
    strip = {k[len("visual."):]: v for k, v in np_sd.items()
             if k.startswith("visual.") and "num_batches" not in k}
    assert resnet_config_from_state_dict(state) == \
        jax_loader.resnet_config_from_state_dict(strip) == geo
    loaded, cfg = load_resnet(path, dtype=torch.float32)
    assert cfg == geo and not loaded.training
    img = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(loaded(img), tower.eval()(img))


def test_cli_logs_the_load(files, tmp_path):
    """``python -m cmh_torch.main --device cpu`` with ``clip_path`` at the
    archive: the geometry comes from the file (fp32 asked for) and the log
    names the load."""
    import yaml

    from cmh_torch.main import main

    path, want = files["torchscript"]
    cfg = _trainer_cfg(tmp_path / "unused", path, variant=False)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("synthetic-cpu")      # the runner's logger
    logger.addHandler(handler)
    try:
        tr = main(["--config-file", str(cfg_path), "--save-dir", str(tmp_path / "out"),
                   "--device", "cpu"])
    finally:
        logger.removeHandler(handler)
    assert f"backbone: loaded {path}" in records
    assert tr.model.backbone.cfg == infer_config(read_torch_state_dict(path), torch.float32)
    assert len(tr.history) == 1 and np.isfinite(tr.history[0]["loss"])
