"""cmh_tpu's full-state ``checkpoint-last.msgpack`` in the port
(``cmh_torch/runners/jax_checkpoint.py``), on the CPU at tiny shapes.

cmh_tpu's own tiny trainers (``CLIPConfig.tiny()``) take one step and save
the checkpoint: off a mesh (flat BertAdam vectors) for each of the eight
methods, among them DCMHT (BatchNorm statistics), DSPH (the proxies' SGD
momentum, a decay chained before it), DNPH (the proxies on momentum-less
SGD, whose optax state holds no trace), MITH (the memory banks) and TwDH
(its ``extra`` meta), and on the conftest's 8-device mesh (tree BertAdam
state) for DCMHT. The port resumes each through
``run.resume_checkpoint``:

- every tensor and the meta are held exactly: the model's state against
  cmh_tpu's weights through the converters, each moment against cmh_tpu's
  own ``_FlatSpec.unflatten`` of its vector, the SGD momentum, the method
  state, the step and the best tracking;
- the next step matches cmh_tpu's next step on the same batch (loss 1e-5
  relative; parameters within 1e-5), with each method's dropout, DNPH's
  noise and TwDH's tie vector drawn on each side from its own keys at the
  resumed step (the port's from ``run.seed`` and the step count it
  resumed, ``utils/prng.py``), DIMCH and UMoED with
  cmh_tpu's fused kernels in interpret mode (``CMH_TPU_FUSED=1``, as
  ``test_torch_train_dimch_umoed.py``), a constant schedule (the warmup would
  make the lr 0) and BertAdam's ε at 1e-3: at 1e-6 an element whose
  gradient is fp32 noise (the attention key biases' true gradient is 0)
  steps by up to the whole lr on either side
  (``test_torch_methods.py:test_one_train_step_matches``).

The port's writer round-trips: a file it writes, flat or tree, loads in
cmh_tpu's ``load_checkpoint`` to the state it was read from, bit for bit.
``run.auto_resume`` takes a ``.msgpack`` whose sidecar fingerprint is the
port's (and the port's fingerprint is cmh_tpu's for each config) and skips
one whose fingerprint differs, with the reason logged.
"""

import copy
import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (before any torch work)
import torch

import cmh_tpu.models.dnph  # noqa: F401  (registers cmh_tpu's methods)
import cmh_tpu.models.dsph  # noqa: F401
import cmh_tpu.models.mith  # noqa: F401
import cmh_tpu.models.twdh  # noqa: F401
import cmh_tpu.runners.baseline  # noqa: F401
import cmh_tpu.runners.dimch  # noqa: F401
import cmh_tpu.runners.dnph  # noqa: F401
import cmh_tpu.runners.dsph  # noqa: F401
import cmh_tpu.runners.mith  # noqa: F401
import cmh_tpu.runners.twdh  # noqa: F401
import cmh_tpu.runners.umoed  # noqa: F401
from cmh_torch.config import config_from_dict as port_config
from cmh_torch.registry import load_components
from cmh_torch.runners import jax_checkpoint
from cmh_torch.optim.bert_adam import _FlatSpec as PortSpec
from cmh_tpu.config import config_from_dict
from cmh_tpu.optim.bert_adam import _FlatSpec
from cmh_tpu.parallel.mesh import shard_batch
from cmh_tpu.registry import registry
from tests.test_torch_dimch import model_cfg as dimch_cfg
from tests.test_torch_umoed import FUSION

port_registry = load_components()
MODEL = {"DCMHT": {"hash_func": "softmax"},
         "DSPH": {"hash_func": "tanh", "numclass": 4},
         "MITH": {"hash_func": "tanh", "top_k_label": 4, "drop_out": 0.0},
         "TwDH": {"hash_func": "softmax", "long_dim": 16, "short_dims": [8], "numclass": 4,
                  "long_center": "/nonexistent", "short_center": "/nonexistent",
                  "trans_matrix": "/nonexistent"},
         "DNPH": {"hash_func": "tanh", "numclass": 4, "noise_alpha": 0.1},
         "Baseline": {"hash_func": "tanh"},
         "DIMCH": {k: v for k, v in dimch_cfg(dropout=0.3).items()
                   if k not in ("arch", "clip_variant")},
         "UMoED": {k: v for k, v in dict(FUSION, decoder_layers=1, dropout=0.3).items()
                   if k not in ("arch", "clip_variant")}}
CASES = [("DCMHT", "flat"), ("DCMHT", "tree"), ("DSPH", "flat"), ("MITH", "flat"),
         ("TwDH", "flat"), ("DNPH", "flat"), ("Baseline", "flat"), ("DIMCH", "flat"),
         ("UMoED", "flat")]


def _cfg(root, arch, mesh):
    return {
        "model": {"arch": arch, "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                  **MODEL[arch]},
        "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005,
                      "warmup_proportion": 0.0, "schedule": "warmup_constant", "e": 1e-3,
                      "hyp": {"lr": 0.02}, "loss": {"lr": 0.01}},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": arch + "Trainer", "save_dir": str(root / "jax"),
                "log_dir": str(root / "jax_log"), "output_dim": 8, "batch_size": 16,
                "is_train": True, "train_num": 32, "query_num": 16, "epochs": 2,
                "display_step": 1000, "seed": 5, "distribute": mesh},
    }


def _jax_trainer(cfg, mesh):
    cls = registry.get_runner_class(cfg["run"]["arch"])
    if mesh:
        return cls.from_config(cfg=config_from_dict(cfg), world_size=8, distributed=True,
                               auto_run=False)
    return cls.from_config(cfg=config_from_dict(cfg), auto_run=False)


def _jax_step(tr, batch):
    db = (shard_batch(batch, tr.mesh) if tr.mesh is not None
          else {k: jnp.asarray(v) for k, v in batch.items()})
    tr.state, loss, _ = tr._train_step(tr.state, db)
    return float(loss)


def _port_trainer(cfg, root, name, **run):
    cfg = json.loads(json.dumps(cfg))
    cfg["run"].update(save_dir=str(root / name), log_dir=str(root / (name + "_log")),
                      distribute=False, **run)
    return port_registry.require_runner_class(cfg["run"]["arch"]).from_config(
        cfg=port_config(cfg), device="cpu", auto_run=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def saved(request, tmp_path_factory):
    """A cmh_tpu trainer one step past init with its best tracking moved,
    its ``checkpoint-last.msgpack``, the state it saved, the batch of its
    next step, and that step's loss and parameters."""
    arch, fmt = request.param
    root = tmp_path_factory.mktemp(f"{arch}_{fmt}")
    cfg = _cfg(root, arch, fmt == "tree")
    with pytest.MonkeyPatch.context() as mp:
        if arch in ("DIMCH", "UMoED"):
            mp.setenv("CMH_TPU_FUSED", "1")
        tr = _jax_trainer(cfg, fmt == "tree")
        batches = list(tr.train_loader)
        _jax_step(tr, batches[0])
        tr.global_step, tr.max_mapi2t, tr.best_epoch_t = 1, 0.25, 3
        if arch == "TwDH":
            tr.max_short["8"]["i2t"] = 0.5
        path = os.path.join(tr.save_dir, "checkpoint-last.msgpack")
        tr.save_checkpoint(path, epoch=1)
        before = _np(tr.state._asdict())
        loss = _jax_step(tr, batches[1])
    return {"arch": arch, "fmt": fmt, "root": root, "cfg": cfg, "path": path,
            "trainer": tr, "state": before, "batch": batches[1], "loss": loss,
            "params": _np(tr.state.params), "model_state": _np(tr.state.model_state)}


def test_resume_holds_the_state_and_takes_cmh_tpus_next_step(saved, monkeypatch):
    arch, st = saved["arch"], saved["state"]
    ptr = _port_trainer(saved["cfg"], saved["root"], "port", resume_checkpoint=saved["path"])
    assert ptr.optimizer.flat                 # off a mesh, whatever the file's format
    assert ptr._resume() == 1
    method = ptr.method
    # the weights and BatchNorm statistics
    want = method.state_from_jax(st["params"], st["model_state"])
    got = ptr.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # BertAdam: each partition unflattened by cmh_tpu's own spec (tree
    # partitions as they are), carried by the converters, per parameter name
    trees = {}
    for slot in ("m", "v"):
        parts = {}
        for key, sub in st["opt_state"].items():
            if key in ptr.extra_optimizers:
                parts[key] = st["params"][key]
            elif saved["fmt"] == "flat":
                parts[key] = _np(_FlatSpec(st["params"][key]).unflatten(
                    jnp.asarray(getattr(sub, slot))))
            else:
                parts[key] = getattr(sub, slot)
        # a model of the same structure takes the moments as its weights, so
        # each parameter holds its moment (MITH's per-bit rows are one tensor)
        shadow = copy.deepcopy(ptr.model)
        shadow.load_state_dict(method.state_from_jax(parts, st["model_state"]))
        trees[slot] = dict(shadow.named_parameters())
    names = {id(p): n for n, p in ptr.model.named_parameters()}
    opt = ptr.optimizer.state_dict()
    assert opt["step_count"] == int(st["step"]) == 1
    for group, saved_group in zip(ptr.optimizer.param_groups, opt["groups"]):
        for slot in ("m", "v"):
            views = PortSpec(group["params"]).views(saved_group[slot])
            for p, t in zip(group["params"], views):
                assert torch.equal(t, trees[slot][names[id(p)]]), (slot, names[id(p)])
    assert max(float(t.abs().sum()) for t in trees["m"].values()) > 0
    # the proxies' SGD momentum: optax's trace through the converter
    for name, sgd in ptr.extra_optimizers.items():
        # DSPH: chain(decay, sgd) → one trace leaf; DNPH's SGD has no momentum
        # and optax no trace, so torch holds no buffer
        trace = jax.tree_util.tree_leaves(st["opt_state"][name])
        (p,) = sgd.param_groups[0]["params"]
        if arch == "DNPH":
            assert trace == [] and sgd.param_groups[0]["momentum"] == 0
            assert sgd.state.get(p, {}).get("momentum_buffer") is None
            continue
        assert len(trace) == 1
        full = dict(st["params"], **{name: trace[0]})
        want_buf = method.state_from_jax(full, st["model_state"])[names[id(p)]]
        assert torch.equal(sgd.state[p]["momentum_buffer"], want_buf)
    # the method state and the meta
    for path, leaf in jax.tree_util.tree_leaves_with_path(st["method_state"]):
        node = ptr.method_state
        for key in path:
            node = node[key.key]
        assert torch.equal(node, torch.from_numpy(np.asarray(leaf))), path
    assert (ptr.global_step, ptr.max_mapi2t, ptr.best_epoch_t) == (1, 0.25, 3)
    if arch == "TwDH":
        assert ptr.max_short["8"] == {"i2t": 0.5, "t2i": 0.0}
    # the next step, on cmh_tpu's batch
    loss, _ = ptr.train_step(saved["batch"])
    assert abs(float(loss) - saved["loss"]) <= 1e-5 * abs(saved["loss"])
    after = method.state_from_jax(saved["params"], saved["model_state"])
    got = ptr.model.state_dict()
    worst = max(float((got[k] - after[k]).abs().max()) for k in after)
    assert worst <= 1e-5, worst


def test_the_ports_file_loads_in_cmh_tpu(saved, tmp_path):
    """The port resumes cmh_tpu's file and writes it again in the same
    format; a fresh cmh_tpu trainer of that format loads it to the state
    cmh_tpu saved, bit for bit."""
    flat = saved["fmt"] == "flat"
    ptr = _port_trainer(saved["cfg"], saved["root"], "write", resume_checkpoint=saved["path"])
    ptr._resume()
    path = str(tmp_path / "checkpoint-last.msgpack")
    jax_checkpoint.write(path, ptr, 1, flat=flat)
    with open(path + ".meta.json") as f:
        assert json.load(f) == {"epoch": 1, "fingerprint": ptr._config_fingerprint()}
    cfg = json.loads(json.dumps(saved["cfg"]))
    cfg["run"].update(save_dir=str(tmp_path / "jax2"), log_dir=str(tmp_path / "jax2_log"))
    jtr = _jax_trainer(cfg, not flat)
    assert jtr.load_checkpoint(path) == 1
    got, want = _np(jtr.state._asdict()), saved["state"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                         jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    assert (jtr.global_step, jtr.max_mapi2t, jtr.best_epoch_t) == (1, 0.25, 3)
    assert jtr._extra_checkpoint_meta() == saved["trainer"]._extra_checkpoint_meta()


def test_fingerprint_is_cmh_tpus(saved):
    """The port's run fingerprint, which ``auto_resume`` compares with the
    sidecar's, equals cmh_tpu's for each config (the optimizer hash covers
    the same resolved settings and the optimizer section)."""
    ptr = _port_trainer(saved["cfg"], saved["root"], "fingerprint")
    assert ptr._config_fingerprint() == saved["trainer"]._config_fingerprint()


@pytest.fixture
def trainer_log():
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("synthetic-cpu")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def test_auto_resume_takes_a_matching_msgpack_and_skips_a_foreign_one(saved, trainer_log,
                                                                       tmp_path):
    root = tmp_path / "root"
    mine = root / "run_a" / "checkpoint-last.msgpack"
    foreign = root / "run_b" / "emergency.ckpt.msgpack"
    for dst in (mine, foreign):
        os.makedirs(dst.parent)
        shutil.copy(saved["path"], dst)
        shutil.copy(saved["path"] + ".meta.json", str(dst) + ".meta.json")
    with open(str(foreign) + ".meta.json") as f:
        side = json.load(f)
    side["fingerprint"]["optimizer_hash"] = "0" * 16
    with open(str(foreign) + ".meta.json", "w") as f:
        json.dump(side, f)
    os.utime(foreign, (2e9, 2e9))            # the newer file: weighed first
    cfg = json.loads(json.dumps(saved["cfg"]))
    cfg["run"].update(auto_resume=True)
    ptr = port_registry.require_runner_class(cfg["run"]["arch"]).from_config(
        cfg=port_config(dict(cfg, run=dict(cfg["run"], save_dir=str(root / "run_c"),
                                           log_dir=str(tmp_path / "log"),
                                           distribute=False))),
        device="cpu", auto_run=False)
    assert ptr._resume() == 1
    assert ptr.optimizer.step_count == 1
    assert any(f"skipping {foreign} (config fingerprint mismatch on ['optimizer_hash'])" in m
               for m in trainer_log)
    assert any(f"checkpoint restored from {mine}" in m for m in trainer_log)
