"""The port's flax msgpack reader (``cmh_torch/utils/flax_msgpack.py``)
against flax on files that cmh_tpu's own ``save_model`` writes, on the CPU.

Each array the reader returns is bit-equal to
``flax.serialization.msgpack_restore``'s; the encoder half writes flax's
bytes exactly; chunked arrays (flax's ``MAX_CHUNK_SIZE`` patched small),
bfloat16 arrays (returned as ``torch.bfloat16``) and every scalar type flax
emits are read back; a truncated file raises. A ``model-N.msgpack`` of
cmh_tpu loads through ``run.resume_model`` in test mode and through
``python -m cmh_torch.export --model``, and gives cmh_tpu's codes (exact,
where cmh_tpu's continuous code is not within 1e-4 of the decision
boundary) and mAPs (1e-6: fp32 towers on both sides, the codes equal).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch_threads  # noqa: F401  (before any torch work)
import torch

import cmh_tpu.models.mith  # noqa: F401  (registers cmh_tpu's methods)
import cmh_tpu.models.twdh  # noqa: F401
import cmh_tpu.runners.mith  # noqa: F401
import cmh_tpu.runners.twdh  # noqa: F401
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.export import load_encoders
from cmh_torch.export import main as export_main
from cmh_torch.registry import load_components
from cmh_torch.utils import flax_msgpack
from tests.util_methods import tiny_trainer

port_registry = load_components()
EXTRA = {"DCMHT": {"hash_func": "softmax"},
         "MITH": {"drop_out": 0.0, "top_k_label": 4, "hash_func": "tanh"},
         "TwDH": {"long_dim": 64, "short_dims": [8], "numclass": 4, "hash_func": "softmax",
                  "long_center": "/nonexistent", "short_center": "/nonexistent",
                  "trans_matrix": "/nonexistent"}}


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """cmh_tpu's tiny trainer of each method (seeded weights, its image
    BatchNorm statistics moved off their init for DCMHT and TwDH) and the
    ``model-0.msgpack`` its ``save_model`` writes."""
    out = {}
    for arch, extra in EXTRA.items():
        root = tmp_path_factory.mktemp(arch)
        tr = tiny_trainer(root / "train", arch, arch + "Trainer", model_extra=extra)
        if "batch_stats" in tr.state.model_state:
            tr.state = tr.state._replace(model_state=jax.tree_util.tree_map(
                lambda a: a + 0.25, tr.state.model_state))
        tr.save_model(str(root), 0)
        out[arch] = (tr, str(root / "model-0.msgpack"))
    return out


@pytest.mark.parametrize("arch", list(EXTRA))
def test_reader_equals_flax_and_encoder_writes_flax_bytes(saved, arch):
    _, path = saved[arch]
    with open(path, "rb") as f:
        blob = f.read()
    want = flax.serialization.msgpack_restore(blob)
    got = flax_msgpack.load(path)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    wl = _leaves(want)
    for p, a in _leaves(got).items():
        assert a.dtype == wl[p].dtype and a.shape == wl[p].shape, p
        np.testing.assert_array_equal(a, wl[p], err_msg=str(p))
    assert flax_msgpack.dumps(want) == blob


@pytest.mark.parametrize("arch", list(EXTRA))
def test_model_file_loads_into_the_port(saved, arch):
    tr, path = saved[arch]
    method = port_registry.require_model_class(arch).from_config(
        port_config({"model": dict(EXTRA[arch], clip_variant="tiny")}).model, output_dim=8)
    sd = method.read_model_file(path)
    method.model.load_state_dict(sd, strict=True)
    tree = jax.tree_util.tree_map(np.asarray, {"params": tr.state.params,
                                               "model_state": tr.state.model_state})
    again = method.state_from_jax(tree["params"], tree["model_state"])
    assert sd.keys() == again.keys()
    for k in sd:
        assert torch.equal(sd[k], again[k]), k
    if arch != "MITH":
        assert float(sd["hash.img_hash.norm.running_var"].min()) == 1.25


def test_chunked_arrays(monkeypatch):
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(7, 5).astype(np.float32), "b": {"c": np.arange(33, dtype=np.int64)}}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 48)
    blob = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = flax_msgpack.loads(blob)
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"]["c"], tree["b"]["c"])
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 48)
    assert flax_msgpack.dumps(tree) == blob


def test_bfloat16_array():
    a = jnp.asarray(np.random.RandomState(1).randn(3, 4), jnp.bfloat16)
    got = flax_msgpack.loads(flax.serialization.to_bytes({"w": a}))["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 4)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(a, np.float32))
    assert flax_msgpack.dumps({"w": got}) == flax.serialization.to_bytes({"w": a})


def test_every_scalar_type_flax_emits():
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128,
                     -129, -32768, -32769, -2**31 - 1, -2**63],
            "floats": [0.5, -1e300], "none": None, "flags": [True, False],
            "strs": ["", "x" * 31, "y" * 32, "z" * 300, "é" * 40000], "bytes": b"\x00\x01",
            "np": [np.float32(1.5), np.int64(-3), np.bool_(True)], "complex": 1.5 - 2j,
            "empty": {}, "arr0": np.zeros((0, 3), np.float16), "u8": np.arange(20, dtype=np.uint8),
            **{f"k{i}": i for i in range(20)}}
    # in place: flax's to_bytes path, which keeps the maps' order (and lists)
    blob = flax.serialization.msgpack_serialize(dict(tree), in_place=True)
    want = flax.serialization.msgpack_restore(blob)
    got = flax_msgpack.loads(blob)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
        assert type(a) is type(b), p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    assert flax_msgpack.dumps(tree) == blob


def test_truncated_or_padded_file_raises(saved, tmp_path):
    _, path = saved["DCMHT"]
    with open(path, "rb") as f:
        blob = f.read()
    for cut in (1, 100, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.loads(blob[:cut])
    with pytest.raises(ValueError, match="after the object"):
        flax_msgpack.loads(blob + b"\x00")
    bad = tmp_path / "model-0.msgpack"
    bad.write_bytes(blob[: len(blob) - 7])
    method = port_registry.require_model_class("DCMHT").from_config(
        {"clip_variant": "tiny", "hash_func": "softmax"}, output_dim=8)
    with pytest.raises(ValueError, match="truncated"):
        method.read_model_file(str(bad))


@pytest.mark.parametrize("arch", ["DCMHT", "MITH"])
def test_test_mode_from_a_cmh_tpu_file_gives_cmh_tpu_maps(saved, arch, tmp_path, monkeypatch):
    monkeypatch.setenv("CMH_TPU_FUSED", "1")
    _, path = saved[arch]
    run = {"is_train": False, "resume_model": path}
    jtr = tiny_trainer(tmp_path / "jax", arch, arch + "Trainer", model_extra=EXTRA[arch],
                       run_extra=run)
    jmaps = jtr.test()
    cfg = jtr.cfg.to_dict()
    cfg["run"].update(save_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_log"))
    ptr = port_registry.require_runner_class(arch + "Trainer").from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)
    pmaps = ptr.test()
    jmat = scio.loadmat(os.path.join(jtr.save_dir, "mat_files", "test.mat"))
    pmat = scio.loadmat(os.path.join(ptr.save_dir, "mat_files", "test.mat"))
    for key in ("q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l"):
        np.testing.assert_array_equal(pmat[key], jmat[key], err_msg=key)
    np.testing.assert_allclose(pmaps, jmaps, rtol=0, atol=1e-6)


def test_export_reads_a_cmh_tpu_file(saved, tmp_path):
    tr, path = saved["TwDH"]
    cfg = tmp_path / "twdh.yaml"
    cfg.write_text("model: " + str(dict(EXTRA["TwDH"], arch="TwDH", clip_variant="tiny"))
                   + "\nrun: {output_dim: 8}\n")
    out = str(tmp_path / "enc.pt")
    export_main(["--config-file", str(cfg), "--out", out, "--model", path, "--device", "cpu"])
    enc = load_encoders(out, device="cpu")
    img = np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32)
    long_codes, shorts = enc.encode_image(img)
    variables = {"params": tr.state.params, **tr.state.model_state}
    trans = tr.method.eval_method_state()["trans"]
    want_long, want_short = tr.method.module.apply(
        variables, jnp.asarray(img), train=False, trans=trans,
        method=lambda m, x, train, trans: m.encode_image(x, train=train, trans=trans))
    pairs = np.asarray(want_long).reshape(4, -1, 2)
    decided = np.abs(pairs[..., 1] - pairs[..., 0]) > 1e-4
    np.testing.assert_array_equal(long_codes[decided],
                                  np.asarray(tr.method.make_hash_code(want_long))[decided])
    assert sorted(shorts) == ["8"] and shorts["8"].shape == (4, 8)
