"""Tensor parallelism of the port (``cmh_torch/parallel/tp.py``, ``run.tp``)
on the CPU: gloo ranks, each a process of this file, at small shapes.

The towers are those of a seeded CLIP file in OpenAI's layout at vision and
text width 128 (2 heads each; ``CLIPConfig.tiny()`` has one vision head,
which a split by heads cannot share), read by both packages through
``model.clip_path``, in fp32.

- The rules: the parameters the port shards are, name for name, those that
  cmh_tpu's ``_spec_for_path`` shards in each of the eight methods' trees
  (``tests/test_parallel.py:481``).
- DCMHT at tp=2 and at dp=2 × tp=2, 1 epoch of 2 steps and its ``valid``:
  the epoch loss within 1e-6 relative and the parameters within 1e-5 of the
  single process, the mAPs within 1e-12, the ranks' losses equal, the shards
  of a tensor-parallel index bit-equal across its data-parallel ranks; only
  rank 0 writes files. UMoED (its Soft-MoE experts sharded, dropout 0.2 on
  the decoder's sharded attention heads) at tp=2 likewise, drawing the single
  process's mask elements.
- From cmh_tpu's initial weights and on its batch, the first step's loss of
  the dp=2 × tp=2 ranks is that of cmh_tpu's step on its dp=2 × tp=2 mesh
  (rtol 1e-4, as ``tests/test_parallel.py:142``), and UMoED's at tp=2 that
  of cmh_tpu's expert-parallel step (rtol 1e-4, as ``:204``).
- DSPH, MITH (its fp32 concept transformers sharded too), TwDH, DNPH,
  Baseline and DIMCH at tp=2, one step each: the loss within 1e-6 relative
  and the parameters within 1e-5 of the single process's step.
- A tp=2 run resumes the single process's ``checkpoint-last.pt`` and
  cmh_tpu's ``checkpoint-last.msgpack`` (written on its dp × tp mesh), and
  the single process resumes the tp run's ``checkpoint-last.pt``: each next
  epoch equals the single process's resuming the same file (loss 1e-6
  relative, parameters 1e-5, mAPs 1e-12); the tp run's ``.msgpack`` loads in
  cmh_tpu to the tp run's gathered weights, bit for bit.
- Units in a group of two, each against the whole module on one process:
  per-leaf BertAdam clipping (tree and flat: a sharded leaf by the whole
  tensor's norm, a replicated one by its own), the row-split products (fp32
  partials summed, rounded once to bf16, the bias added once) and the
  column-split input gradients (rounded once), the attention's head-averaged
  weights and its dropout masks (self- and cross-attention, the explicit
  path and K2's), the Soft-MoE, and the ResNet tower (its attention pool's
  ``c_proj`` split).
- The rules split the ResNet tower's parameters as cmh_tpu's split its.
- The named errors: heads that tp does not divide, processes that tp does
  not divide, NCCL ranks on one card, a parameter the rules split under no
  module that computes on shards.

Each subprocess has its own timeout, and a worker that waits for a file
another process writes gives up after its own; a hang fails the test. Run
as ``python -m tests.test_torch_tp <plan.json>``, this file is the worker.
"""

import datetime
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from tests import torch_threads  # noqa: F401  (before any torch work)
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240          # a worker process
WAIT = 200             # a worker waiting for another process's file
ARCHS = ("DCMHT", "DSPH", "MITH", "TwDH", "DNPH", "Baseline", "DIMCH", "UMoED")
OTHERS = ("DSPH", "MITH", "TwDH", "DNPH", "Baseline", "DIMCH")   # one step each at tp=2
RN_TOWER = dict(layers=(1, 1, 1, 1), output_dim=16, heads=2, input_resolution=64, width=8)
GEOMETRY = dict(embed_dim=128, image_resolution=32, vision_layers=2, vision_width=128,
                vision_patch_size=8, context_length=16, vocab_size=49408,
                transformer_width=128, transformer_heads=2, transformer_layers=2)
UMOED = {"setDim": 4, "MoE": True, "fusion": True, "num_experts": 2, "slots_per_expert": 2,
         "decoder_heads": 2, "decoder_layers": 1, "hidden_dim": 32, "dropout": 0.2,
         "hash_func": "linear_subspace", "merge_func": "concatenate", "extreme": True,
         "extreme_T": 0.3, "triplet": True, "distance_mode": "cosine",
         "distance": {"mode": "pairwise"},
         "chamfer": {"unif_alpha": 0.8, "token_triplet_margin": 0.1},
         "hash_pars": {"triplet_alpha": 1}}
MODEL = {"DCMHT": {"hash_func": "softmax"},
         "DSPH": {"hash_func": "tanh", "numclass": 4},
         "MITH": {"hash_func": "tanh", "top_k_label": 4},
         "TwDH": {"hash_func": "softmax", "long_dim": 16, "short_dims": [8], "numclass": 4,
                  "long_center": "/nonexistent", "short_center": "/nonexistent",
                  "trans_matrix": "/nonexistent"},
         "DNPH": {"hash_func": "tanh", "numclass": 4},
         "Baseline": {"hash_func": "tanh"},
         "DIMCH": {"hash_func": "tanh", "setDim": 4, "txt_token_size": 12},
         "UMoED": UMOED}


def write_clip(path):
    """A seeded CLIP at ``GEOMETRY`` as OpenAI writes its files: the state
    dict with the three integer entries."""
    from cmh_torch.models.clip.model import CLIP, CLIPConfig
    from cmh_torch.utils import prng

    model = CLIP(CLIPConfig(**GEOMETRY, dtype=torch.float32))
    model.init_weights(prng.PRNGKey(16))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(16),
              vocab_size=torch.tensor(49408))
    torch.save(sd, path)


def _cfg(arch, clip, **run):
    return {
        "model": {"arch": arch, "clip_path": str(clip), "clip_dtype": "float32",
                  **MODEL[arch]},
        "optimizer": {"arch": "BertAdam", "lr": 0.002, "clip_lr": 0.0005,
                      "warmup_proportion": 0.0, "schedule": "warmup_constant", "e": 1e-3},
        "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                    "image_resolution": 32, "max_word": 12},
        "run": {"arch": arch + "Trainer", "output_dim": 8, "batch_size": 16,
                "is_train": True, "train_num": 32, "query_num": 16, "epochs": 1,
                "display_step": 1000, "seed": 5, "log_dir": None, **run},
    }


def _free_port():
    from cmh_torch.parallel.dp import free_port

    return free_port()


def _spawn(tmp, name, plan):
    """One worker process running ``plan`` (its group and cases)."""
    path = tmp / f"{name}.json"
    plan = dict(plan, out=str(tmp / f"{name}.pt"))
    path.write_text(json.dumps(plan))
    proc = subprocess.Popen([sys.executable, "-m", "tests.test_torch_tp", str(path)], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="2"))
    return proc, plan["out"]


def _wait(jobs):
    """Each job's results, or the test fails with its output."""
    results = []
    deadline = time.monotonic() + TIMEOUT
    for proc, out in jobs:
        try:
            log, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for p, _ in jobs:
                p.kill()
            pytest.fail(f"a worker hung past {TIMEOUT} s")
        assert proc.returncode == 0, log.decode()[-4000:]
        results.append(torch.load(out, weights_only=False))
    return results


def _publish(path, obj):
    """Write ``obj`` so that a waiting worker never reads half of it."""
    with open(str(path) + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(str(path) + ".tmp", path)


def _group(world, tp, port, rank):
    return {"world": world, "tp": tp, "port": port, "rank": rank}


# ------------------------------------------------------------------ fixture
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process case at once: the single process, a tp=2 pair
    and a dp=2 × tp=2 group, while this process builds cmh_tpu's dp × tp
    trainers, hands their initial weights and first batches to the workers
    and takes their steps."""
    tmp = tmp_path_factory.mktemp("tp")
    clip = tmp / "clip128.pt"
    write_clip(clip)
    f = {k: str(tmp / k) for k in ("jax_dcmht.pkl", "jax_umoed.pkl", "jax.msgpack")}

    def cli(arch, name, write=None, **run):
        return {"kind": "cli", "name": name, "write": write, "cfg": _cfg(arch, clip, **run)}

    def resume(arch, name, path, **run):
        return {"kind": "cli", "name": name, "wait": path,
                "cfg": _cfg(arch, clip, epochs=2, resume_checkpoint=path, **run)}

    def one_step(arch, **run):
        return {"kind": "one_step", "name": f"step_{arch}", "cfg": _cfg(arch, clip, **run)}

    def step(arch, name, weights, **run):
        # the cmh_tpu comparisons run without dropout: the masks cannot match
        cfg = _cfg(arch, clip, **run)
        cfg["model"]["dropout"] = 0.0
        return {"kind": "step", "name": name, "wait": weights, "cfg": cfg}

    single_ckpt = str(tmp / "single_dcmht" / "checkpoint-last.pt")
    tp_ckpt = str(tmp / "tp_dcmht_0" / "checkpoint-last.pt")
    tp_msgpack = str(tmp / "tp_dcmht_0" / "checkpoint-last.msgpack")
    port_tp, port_dt = _free_port(), _free_port()
    dcmht = dict(checkpoint_every=1)
    plans = {"single": {"cases": [
        cli("DCMHT", "dcmht", save_dir=str(tmp / "single_dcmht"), **dcmht),
        cli("UMoED", "umoed", save_dir=str(tmp / "single_umoed")),
        resume("DCMHT", "resume_single", single_ckpt, save_dir=str(tmp / "s_r1")),
        resume("DCMHT", "resume_jax", f["jax.msgpack"], save_dir=str(tmp / "s_r2")),
        resume("DCMHT", "resume_tp", tp_ckpt, save_dir=str(tmp / "s_r3")),
        *(one_step(a, save_dir=str(tmp / f"single_{a}")) for a in OTHERS)]}}
    for r in (0, 1):
        plans[f"tp{r}"] = {"group": _group(2, 2, port_tp, r), "cases": [
            {"kind": "units", "name": "units"},
            cli("DCMHT", "dcmht", tp_msgpack, save_dir=str(tmp / f"tp_dcmht_{r}"), tp=2,
                **dcmht),
            cli("UMoED", "umoed", save_dir=str(tmp / f"tp_umoed_{r}"), tp=2),
            step("UMoED", "umoed_jax", f["jax_umoed.pkl"], tp=2),
            resume("DCMHT", "resume_single", single_ckpt, save_dir=str(tmp / f"t_r1_{r}"),
                   tp=2),
            resume("DCMHT", "resume_jax", f["jax.msgpack"], save_dir=str(tmp / f"t_r2_{r}"),
                   tp=2),
            resume("DCMHT", "resume_tp", tp_ckpt, save_dir=str(tmp / f"t_r3_{r}"), tp=2),
            *(one_step(a, save_dir=str(tmp / f"tp_{a}_{r}"), tp=2) for a in OTHERS)]}
    for r in range(4):
        plans[f"dt{r}"] = {"group": _group(4, 2, port_dt, r), "cases": [
            cli("DCMHT", "dcmht", save_dir=str(tmp / f"dt_dcmht_{r}"), tp=2),
            step("DCMHT", "dcmht_jax", f["jax_dcmht.pkl"], tp=2)]}
    jobs = {name: _spawn(tmp, name, plan) for name, plan in plans.items()}
    try:
        jax_side = _cmh_tpu_side(tmp, clip, f)
    except BaseException:
        for proc, _ in jobs.values():
            proc.kill()
        raise
    done = dict(zip(jobs, _wait(list(jobs.values()))))
    files = _the_tp_runs_files(tmp, single_ckpt, tp_ckpt, tp_msgpack, jax_side.pop("trainer"))
    for path in tmp.iterdir():   # the checkpoints, weights and results: about 0.7 GB
        if path.is_dir():
            shutil.rmtree(path)
        elif path.suffix in (".pt", ".pkl", ".msgpack"):
            path.unlink()
    return {"jax": jax_side, "files": files, **done}


def _the_tp_runs_files(tmp, single_ckpt, tp_ckpt, tp_msgpack, jax_trainer):
    """What the tp run wrote: its ``checkpoint-last.pt`` beside the single
    run's (names, the largest difference, the optimizer formats), its
    ``checkpoint-last.msgpack`` loaded in cmh_tpu's dp × tp trainer (the
    epoch and the weights it restored), and whether each save root exists."""
    import jax

    from cmh_torch.models import convert

    mine, theirs = (torch.load(p, weights_only=True) for p in (tp_ckpt, single_ckpt))
    out = {"same_names": mine["model"].keys() == theirs["model"].keys(),
           "worst": _worst(mine["model"], theirs["model"]),
           "formats": [(torch.is_tensor(a["m"]), torch.is_tensor(b["m"])) for a, b in
                       zip(mine["optimizer"]["groups"], theirs["optimizer"]["groups"])]}
    out["jax_epoch"] = jax_trainer.load_checkpoint(tp_msgpack)
    params, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (
        jax_trainer.state.params, jax_trainer.state.model_state["batch_stats"]))
    out["jax_weights"] = convert.dcmht_state_from_jax(params, stats)
    out["dirs"] = {p.name: sorted(str(f.relative_to(p)) for f in p.rglob("*"))
                   for p in tmp.iterdir() if p.is_dir()}
    return out


def _cmh_tpu_side(tmp, clip, files):
    """cmh_tpu's DCMHT on a dp=2 × tp=2 mesh and UMoED on a tp=2 one: their
    initial weights and first batches published for the workers, then each
    one's first step; DCMHT's state after it written as
    ``checkpoint-last.msgpack`` (epoch 1)."""
    import jax
    import jax.numpy as jnp

    import cmh_tpu.runners.umoed  # noqa: F401  (registers cmh_tpu's UMoED)
    from cmh_tpu.config import config_from_dict
    from cmh_tpu.parallel.mesh import shard_batch
    from cmh_tpu.registry import registry

    out, trainers = {}, {}
    for arch, world, key in (("DCMHT", 4, "jax_dcmht.pkl"), ("UMoED", 2, "jax_umoed.pkl")):
        cfg = _cfg(arch, clip, save_dir=str(tmp / f"jax_{arch}"), distribute=True, tp=2,
                   log_dir=str(tmp / f"jax_{arch}_log"))
        cfg["model"]["dropout"] = 0.0
        tr = registry.get_runner_class(arch + "Trainer").from_config(
            cfg=config_from_dict(cfg), world_size=world, distributed=True, auto_run=False)
        assert tr.mesh.shape["tp"] == 2 and tr.mesh.shape["dp"] == world // 2
        batch = next(iter(tr.train_loader))
        _publish(files[key], {"params": jax.tree_util.tree_map(np.asarray, tr.state.params),
                              "model_state": jax.tree_util.tree_map(np.asarray,
                                                                    tr.state.model_state),
                              "batch": batch})
        trainers[arch] = (tr, batch)
    for arch, (tr, batch) in trainers.items():
        tr.state, loss, _ = tr._train_step(tr.state, shard_batch(batch, tr.mesh))
        out[arch] = float(jnp.asarray(loss))
    tr = trainers["DCMHT"][0]
    tr.save_checkpoint(files["jax.msgpack"] + ".tmp", epoch=1)
    os.replace(files["jax.msgpack"] + ".tmp", files["jax.msgpack"])
    out["trainer"] = tr
    return out


# ------------------------------------------------------------------- tests
def _rel(a, b):
    return abs(a - b) / abs(b)


def _worst(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_port_shards_what_cmh_tpu_shards(arch):
    """Every parameter the port's rules split, and no other, is one that
    cmh_tpu's ``_spec_for_path`` shards in the method's parameter tree: a
    marker state dict (1 where the port shards, 0 elsewhere) goes through
    the method's converter into cmh_tpu's names."""
    import jax
    from jax.sharding import PartitionSpec as P

    from cmh_torch.config import config_from_dict
    from cmh_torch.parallel import tp
    from cmh_torch.registry import load_components
    from cmh_tpu.parallel.tp import _spec_for_path

    cfg = config_from_dict(_cfg(arch, "/nonexistent.pt"))
    cfg.model.update({"clip_variant": "tiny"})
    method = load_components().require_model_class(arch).from_config(
        cfg.model, output_dim=8, train_num=32)
    sd = method.model.state_dict()
    marker = {k: torch.full_like(v, float(tp.split_for(k) is not None))
              if v.is_floating_point() else v for k, v in sd.items()}
    params, _ = method.state_to_jax(marker)
    sharded, bad = 0, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        want = _spec_for_path(path) != P()
        sharded += want
        if set(np.unique(np.asarray(leaf)).tolist()) != {float(want)}:
            bad.append(jax.tree_util.keystr(path))
    assert not bad, bad
    names = tp.sharded_names(method.model)
    assert sharded == len(names) > 0
    if arch == "UMoED":   # the experts, and the decoder's two attentions a layer
        assert any(n.endswith("moe.experts.weight") for n in names)
        assert any(n.endswith("multihead_attn.in_proj_weight") for n in names)


def _ranks_of(runs, case, names):
    """The ranks' results of ``case``: the first holds the whole model, the
    others must hold the same bytes (digest) and losses."""
    rs = [runs[n][case] for n in names]
    for r in rs[1:]:
        assert r["digest"] == rs[0]["digest"] and r["step_losses"] == rs[0]["step_losses"]
    return rs


def test_tp_and_dp_tp_are_the_single_process(runs):
    single = runs["single"]["dcmht"]
    tps = _ranks_of(runs, "dcmht", ["tp0", "tp1"])
    dts = _ranks_of(runs, "dcmht", ["dt0", "dt1", "dt2", "dt3"])
    loss = single["history"][0]["loss"]
    for r in tps + dts:
        assert len(r["step_losses"]) == 2
        assert _rel(r["history"][0]["loss"], loss) <= 1e-6
        np.testing.assert_allclose(r["history"][0]["maps"], single["history"][0]["maps"],
                                   rtol=0, atol=1e-12)
    for r in (tps[0], dts[0]):
        assert _worst(r["model"], single["model"]) <= 1e-5
    assert len(tps[0]["sharded"]) == 24 and tps[0]["tp"] == (0, 2) and dts[3]["tp"] == (1, 2)
    # the shards of one tensor-parallel index are bit-equal across its dp ranks
    assert dts[0]["local_digest"] == dts[2]["local_digest"] != dts[1]["local_digest"]
    assert dts[1]["local_digest"] == dts[3]["local_digest"]
    w = tps[0]["local_shapes"]["backbone.transformer.resblocks.0.attn.in_proj_weight"]
    assert w == (3 * 64, 128)                # a rank's heads of q, k and v
    # only global rank 0 writes
    dirs = runs["files"]["dirs"]
    for name in ("tp_dcmht_0", "dt_dcmht_0"):
        assert {"mat_files/i2t-best.mat", "mat_files/last.mat",
                "mat_files/t2i-best.mat"} <= set(dirs[name]), name
    for worker in ("tp1", "dt1", "dt2", "dt3"):
        assert runs[worker]["dcmht"]["wrote"] is None, worker
    assert any(w.startswith("model-") for w in dts[0]["wrote"])


def test_umoed_experts_sharded_and_dropout_masks_are_the_single_process(runs):
    single = runs["single"]["umoed"]
    rs = _ranks_of(runs, "umoed", ["tp0", "tp1"])
    assert _worst(rs[0]["model"], single["model"]) <= 1e-5
    for r in rs:
        assert _rel(r["history"][0]["loss"], single["history"][0]["loss"]) <= 1e-6
        np.testing.assert_allclose(r["history"][0]["maps"], single["history"][0]["maps"],
                                   rtol=0, atol=1e-12)
        assert r["mask_elements"] == single["mask_elements"] > 0
        assert any(n.endswith("moe.experts.weight") for n in r["sharded"])
    e = [k for k in rs[0]["local_shapes"] if k.endswith("moe.experts.weight")][0]
    assert rs[0]["local_shapes"][e][0] == 1 == single["model"][e].shape[0] // 2


@pytest.mark.parametrize("arch", OTHERS)
def test_every_other_method_steps_as_the_single_process(runs, arch):
    single = runs["single"][f"step_{arch}"]
    rs = _ranks_of(runs, f"step_{arch}", ["tp0", "tp1"])
    assert len(single["step_losses"]) == 1 == len(rs[0]["step_losses"])
    assert _rel(rs[0]["step_losses"][0], single["step_losses"][0]) <= 1e-6
    assert _worst(rs[0]["model"], single["model"]) <= 1e-5
    assert len(rs[0]["sharded"]) == (48 if arch == "MITH" else 24)


def test_first_step_is_cmh_tpus_dp_tp_mesh_step(runs):
    losses = [runs[f"dt{r}"]["dcmht_jax"]["step_losses"][0] for r in range(4)]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], runs["jax"]["DCMHT"], rtol=1e-4)


def test_umoed_step_is_cmh_tpus_expert_parallel_step(runs):
    losses = [runs[f"tp{r}"]["umoed_jax"]["step_losses"][0] for r in (0, 1)]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], runs["jax"]["UMoED"], rtol=1e-4)


@pytest.mark.parametrize("case", ["resume_single", "resume_jax", "resume_tp"])
def test_tp_resumes_single_process_and_cmh_tpu_files(runs, case):
    """tp=2 and one process resume the same file (the single process's, cmh_tpu's,
    the tp run's own) and run the same next epoch."""
    single = runs["single"][case]
    rs = _ranks_of(runs, case, ["tp0", "tp1"])
    assert _worst(rs[0]["model"], single["model"]) <= 1e-5
    for r in rs:
        assert [h["epoch"] for h in r["history"]] == [1] and len(r["step_losses"]) == 2
        assert (r["global_step"], r["step"]) == (single["global_step"], single["step"])
        assert _rel(r["history"][0]["loss"], single["history"][0]["loss"]) <= 1e-6
        np.testing.assert_allclose(r["history"][0]["maps"], single["history"][0]["maps"],
                                   rtol=0, atol=1e-12)


def test_single_process_resumes_the_tp_runs_files(runs):
    """The tp run's files hold the single-process layout: its
    ``checkpoint-last.pt`` is the single run's file within the two runs'
    difference (the same names, BertAdam tree where the single run's is
    flat), and its ``checkpoint-last.msgpack`` loads in cmh_tpu (on its dp
    × tp mesh) to the tp run's gathered weights, bit for bit."""
    f = runs["files"]
    assert f["same_names"] and f["worst"] <= 1e-5
    assert f["formats"] and all(fmt == (False, True) for fmt in f["formats"])
    assert f["jax_epoch"] == 1
    got, want = f["jax_weights"], runs["tp0"]["dcmht"]["model"]
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_clip_norms_reduce_sharded_leaves_only(runs):
    """BertAdam at max_grad_norm 1 over a sharded and a replicated leaf
    whose gradients' norms are far above it: one step of each rank's shards
    equals the whole tensors' step on one process (tree and flat paths)."""
    for r in (runs["tp0"]["units"], runs["tp1"]["units"]):
        for path in ("tree", "flat"):
            assert r[f"adam_{path}"] <= 1e-7, (path, r[f"adam_{path}"])


def test_row_products_round_once_and_add_the_bias_once(runs):
    """In bf16, the row split's output and the column split's input
    gradient equal the exact product rounded once (the bias added once
    after it), but for the rare element whose fp32 sums differ in order."""
    for r in (runs["tp0"]["units"], runs["tp1"]["units"]):
        assert r["row_off_by_ulps"] <= 1 and r["row_differ"] <= 0.01
        assert r["col_grad_off_by_ulps"] <= 1 and r["col_grad_differ"] <= 0.01


def test_attention_weights_and_dropout_masks_are_the_single_process(runs):
    """Outputs, input and parameter gradients within 1e-6 of their largest
    element, in fp32: the attention with dropout 0.5 in train mode (self-
    and cross-attention, their head-averaged weights), on K2's path, and the
    Soft-MoE."""
    for r in (runs["tp0"]["units"], runs["tp1"]["units"]):
        for what in ("self", "cross", "fused"):
            assert r[f"attn_{what}_out"] <= 1e-6, (what, r)
            assert r[f"attn_{what}_grad"] <= 1e-6, (what, r)
        assert r["attn_self_weights"] <= 1e-6 and r["attn_cross_weights"] <= 1e-6, r
        assert r["moe_out"] <= 1e-6 and r["moe_grad"] <= 1e-6, r


def test_resnet_attention_pool_is_the_single_process(runs):
    """The ResNet tower with its attention pool's ``c_proj`` split: output,
    input and parameter gradients within 1e-6 of their largest element."""
    for r in (runs["tp0"]["units"], runs["tp1"]["units"]):
        assert r["rn_out"] <= 1e-6 and r["rn_grad"] <= 1e-6, r


def test_the_resnet_tower_shards_what_cmh_tpu_shards():
    """The rules split the tower's attention pool ``c_proj`` and nothing
    else, as cmh_tpu's ``_spec_for_path`` splits its variables."""
    import jax
    from jax.sharding import PartitionSpec as P

    from cmh_torch.models.clip.resnet import ModifiedResNet
    from cmh_torch.models.convert import resnet_state_to_jax
    from cmh_torch.parallel import tp
    from cmh_tpu.parallel.tp import _spec_for_path

    tower = ModifiedResNet(**RN_TOWER)
    marker = {k: torch.full_like(v, float(tp.split_for(k) is not None))
              for k, v in tower.state_dict().items()}
    params = resnet_state_to_jax(marker)["params"]
    bad, sharded = [], 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        want = _spec_for_path(path) != P()
        sharded += want
        if set(np.unique(np.asarray(leaf)).tolist()) != {float(want)}:
            bad.append(jax.tree_util.keystr(path))
    assert not bad, bad
    assert sharded == 1 and tp.sharded_names(tower) == ["attnpool.c_proj.weight"]


def test_a_split_parameter_no_module_computes_on_raises():
    """A parameter the rules split must lie under a module with ``shard_``:
    here a ``c_proj`` in a module that would multiply the whole input by
    its shard."""
    from torch import nn

    from cmh_torch.parallel import tp

    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.c_proj = nn.Linear(8, 4)

    model = nn.Sequential()
    model.add_module("head", Head())
    with pytest.raises(ValueError, match=r"head.c_proj.weight: the tensor-parallel rules split "
                                         r"it, but no module above it computes on shards "
                                         r"\(Linear has no shard_\)"):
        tp.shard_model_(model, tp.Shards(0, 2))
    assert model.head.c_proj.weight.shape == (4, 8)     # nothing was cut


def test_heads_tp_does_not_divide_raise():
    from cmh_torch.config import config_from_dict
    from cmh_torch.parallel import tp
    from cmh_torch.registry import load_components

    cfg = config_from_dict(_cfg("DCMHT", "/nonexistent.pt"))
    cfg.model.update({"clip_variant": "tiny"})     # one vision head
    method = load_components().require_model_class("DCMHT").from_config(cfg.model,
                                                                         output_dim=8)
    with pytest.raises(ValueError, match=r"backbone.visual.transformer.resblocks.0.attn: 1 "
                                         r"attention heads do not divide by tp=2"):
        tp.shard_model_(method.model, tp.Shards(0, 2))


def test_processes_tp_does_not_divide_raise(tmp_path):
    from cmh_torch.main import main

    path = tmp_path / "cfg.yaml"
    cfg = _cfg("DCMHT", "/nonexistent.pt", multi_host=True, distributed_port=_free_port(),
               num_processes=3, process_id=0, tp=2)
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="3 devices not divisible by tp=2"):
        main(["--config-file", str(path), "--save-dir", str(tmp_path / "o"), "--device", "cpu"])


def test_nccl_ranks_sharing_a_card_raise():
    """``dp.init`` exchanges the ranks' cards through the rendezvous store
    before it opens an NCCL group; two ranks on one card are named."""
    import torch.distributed as dist

    from cmh_torch.parallel import dp

    port = _free_port()
    got, stores = {}, {}

    def rank(r):
        # each store lives until both ranks are done: rank 0's serves them
        stores[r] = dist.TCPStore("localhost", port, 2, is_master=r == 0,
                                  timeout=datetime.timedelta(seconds=60))
        got[r] = dp._exchange(stores[r], r, 2, "host/GPU-0")

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == {0: ["host/GPU-0"] * 2, 1: ["host/GPU-0"] * 2}
    with pytest.raises(ValueError, match=r"NCCL ranks 0 and 1 share the card host/GPU-0"):
        dp.check_distinct_cards(got[0])
    with pytest.raises(ValueError, match=r"NCCL ranks 1 and 3 share the card h/b"):
        dp.check_distinct_cards(["h/a", "h/b", "h/c", "h/b"])
    dp.check_distinct_cards(["h1/a", "h1/b", "h2/a", "h2/b"])


# ------------------------------------------------------------------ worker
@torch.no_grad()
def _seeded_(module, seed):
    """Uniform ±0.2 weights from a seeded generator, for units whose init
    is not under test."""
    gen = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * 0.2)
    return module


def _units(group):
    """Each sharded module against the whole one on the same seeded inputs."""
    from torch import nn

    from cmh_torch.models.clip.model import MultiHeadAttention, _dense, _dense_out
    from cmh_torch.models.common import dropout_rng
    from cmh_torch.models.umoed import SoftMoE
    from cmh_torch.optim.bert_adam import BertAdam
    from cmh_torch.parallel import tp
    from cmh_torch.utils import prng

    sh = group.shards
    gen = torch.Generator().manual_seed(7)
    out = {}

    def whole_and_sharded(make):
        whole, part = make(), make()          # the same seeded weights
        tp.shard_model_(part, sh)
        return whole, part

    def off(got, want):   # relative to the largest element
        return float((got - want).abs().max() / want.abs().max())

    def grads_off(whole, part):
        names = dict(part.named_parameters())
        worst = 0.0
        for n, p in whole.named_parameters():
            split = tp.split_for(n)
            g = names[n].grad if split is None else tp.gather(names[n].grad, split, sh)
            worst = max(worst, off(g, p.grad))
        return worst

    # attention: self with dropout and weights, cross with dropout, K2's path
    class Holder(nn.Module):
        def __init__(self, p):
            super().__init__()
            self.attn = MultiHeadAttention(64, 4, torch.float32, attn_dropout=p)
            self.attn.attn_drop.path = ("attn", "attn_drop")
            _seeded_(self.attn, 3)

    x = torch.randn(3, 5, 64, generator=gen)
    kv = torch.randn(3, 7, 64, generator=gen)
    r = torch.randn(3, 5, 64, generator=gen)
    for what, p, kw, train in (("self", 0.5, {}, True), ("cross", 0.5, {"kv": kv}, True),
                               ("fused", 0.0, {"need_weights": False}, False)):
        whole, part = whole_and_sharded(lambda: Holder(p))
        res = []
        for m in (whole, part):
            m.train(train)
            xi = x.clone().requires_grad_()
            with dropout_rng(prng.fold_in(prng.PRNGKey(11), 2)):
                y, w = m.attn(xi, **kw)
            (y * r).sum().backward()
            res.append((y.detach(), w, xi.grad))
        (yw, ww, gw), (yp, wp, gp) = res
        out[f"attn_{what}_out"] = off(yp, yw)
        out[f"attn_{what}_grad"] = max(off(gp, gw), grads_off(whole, part))
        if ww is not None:
            out[f"attn_{what}_weights"] = off(wp.detach(), ww.detach())

    # the Soft-MoE over sharded experts
    def moe():
        return _seeded_(SoftMoE(16, 8, 4, 3), 4)

    whole, part = whole_and_sharded(moe)
    h = torch.randn(2, 6, 16, generator=gen)
    res = []
    for m in (whole, part):
        hi = h.clone().requires_grad_()
        y = m(hi)
        (y * torch.arange(8.0)).sum().backward()
        res.append((y.detach(), hi.grad))
    out["moe_out"] = off(res[1][0], res[0][0])
    out["moe_grad"] = max(off(res[1][1], res[0][1]), grads_off(whole, part))

    # the ResNet tower: its attention pool's c_proj split by input features
    from cmh_torch.models.clip.resnet import ModifiedResNet

    whole, part = whole_and_sharded(
        lambda: ModifiedResNet(**RN_TOWER).init_weights(torch.Generator().manual_seed(3)))
    image = torch.randn(2, 64, 64, 3, generator=gen)
    dy = torch.randn(2, 16, generator=gen)
    res = []
    for m in (whole, part):
        xi = image.clone().requires_grad_()
        y = m(xi)
        (y * dy).sum().backward()
        res.append((y.detach(), xi.grad))
    out["rn_out"] = off(res[1][0], res[0][0])
    out["rn_grad"] = max(off(res[1][1], res[0][1]), grads_off(whole, part))

    # the row split in bf16: fp32 partials summed, rounded once, bias once
    def ulps(a, b):
        a, b = a.float(), b.float()
        step = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(), b.abs()).clamp(
            min=1e-30)
        return float(((a - b).abs() / step).max()), float((a != b).float().mean())

    xb = torch.randn(64, 256, generator=gen).bfloat16()
    w = torch.randn(32, 256, generator=gen)
    bias = torch.randn(32, generator=gen)
    cols = slice(sh.rank * 128, (sh.rank + 1) * 128)
    got = _dense_out(xb[:, cols], w[:, cols], bias, torch.bfloat16, sh)
    want = (xb.float() @ w.bfloat16().float().t()).bfloat16() + bias.bfloat16()
    out["row_off_by_ulps"], out["row_differ"] = ulps(got, want)
    out["row_single_process"] = ulps(_dense(xb, w, bias, torch.bfloat16), want)
    # the column split's input gradient in bf16, rounded once
    xi = xb.clone().requires_grad_()
    rows = slice(sh.rank * 16, (sh.rank + 1) * 16)
    dy = torch.randn(64, 32, generator=gen).bfloat16()
    tp.column_product(xi, w.bfloat16()[rows], sh).backward(dy[:, rows])
    out["col_grad_off_by_ulps"], out["col_grad_differ"] = ulps(
        xi.grad, (dy.float() @ w.bfloat16().float()).bfloat16())

    # BertAdam: a sharded leaf (the rules' c_fc) and a replicated one
    for path in ("tree", "flat"):
        full = {"c_fc.weight": torch.randn(8, 6, generator=gen),
                "ln.weight": torch.randn(5, generator=gen)}
        grads = {k: 40 * torch.randn(v.shape, generator=gen) for k, v in full.items()}
        whole = {k: nn.Parameter(v.clone()) for k, v in full.items()}
        mine = {k: nn.Parameter(v.clone() if tp.split_for(k) is None
                                else tp.shard(v, tp.split_for(k), sh.rank, sh.size))
                for k, v in full.items()}
        opts = []
        for ps in (whole, mine):
            for k, p in ps.items():
                g = grads[k]
                p.grad = g if ps is whole or tp.split_for(k) is None else tp.shard(
                    g, tp.split_for(k), sh.rank, sh.size)
            opts.append(BertAdam(list(ps.values()), lr=0.1, b2=0.98, e=1e-6,
                                 weight_decay=0.2, max_grad_norm=1.0, flat=path == "flat"))
        opts[1].shard_norms([mine["c_fc.weight"]], sh)
        for o in opts:
            o.step()
        got = {k: mine[k].detach() if tp.split_for(k) is None
               else tp.gather(mine[k].detach(), tp.split_for(k), sh) for k in full}
        out[f"adam_{path}"] = max(off(got[k], whole[k].detach()) for k in full)
    return out


def _digest(sd):
    """A sha256 over a state dict's names and bytes."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _worker(plan_path):
    from cmh_torch.config import config_from_dict
    from cmh_torch.main import run_config
    from cmh_torch.models.common import Dropout
    from cmh_torch.parallel import dp, tp
    from cmh_torch.registry import load_components
    from cmh_torch.runners.base import BaseTrainer

    with open(plan_path) as f:
        plan = json.load(f)
    losses = []
    step = BaseTrainer.train_step

    def recorded(self, batch):
        loss, loss_dict = step(self, batch)
        losses.append(float(loss))
        return loss, loss_dict

    BaseTrainer.train_step = recorded
    g = plan.get("group")
    group = None
    if g:
        group = dp.init("localhost", g["port"], g["world"], g["rank"], torch.device("cpu"),
                        tp=g["tp"])
    results = {}
    for case in plan["cases"]:
        if case.get("wait"):
            deadline = time.monotonic() + WAIT
            while not os.path.exists(case["wait"]):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{case['wait']} never appeared")
                time.sleep(0.2)
        if case["kind"] == "units":
            results[case["name"]] = _units(group)
            continue
        losses.clear()
        Dropout.mask_elements = 0
        cfg = config_from_dict(case["cfg"])
        if case["kind"] == "cli":
            tr = run_config(cfg, "cpu")
        elif case["kind"] == "one_step":
            tr = load_components().require_runner_class(cfg.run.arch).from_config(
                cfg=cfg, device="cpu", auto_run=False)
            tr.train_step(next(iter(tr.train_loader)))
        else:
            with open(case["wait"], "rb") as f:
                jax_side = pickle.load(f)
            tr = load_components().require_runner_class(cfg.run.arch).from_config(
                cfg=cfg, device="cpu", auto_run=False)
            weights = tr.method.state_from_jax(jax_side["params"], jax_side["model_state"])
            if tr.shards is not None:
                weights = tp.shard_state_dict(weights, tr.shards.rank, tr.shards.size)
            tr.model.load_state_dict(weights)
            tr.train_step(jax_side["batch"])
        blob = tr._state_blob(len(tr.history))
        if case.get("write"):   # cmh_tpu's layout, written as "<path>.msgpack"
            tmp = case["write"] + ".part.msgpack"
            tr.save_checkpoint(tmp, epoch=len(tr.history))
            if tr.is_writer:
                os.replace(tmp, case["write"])
        local = tr.model.state_dict()
        results[case["name"]] = {
            "step_losses": list(losses), "history": tr.history, "global_step": tr.global_step,
            # the whole state from the group's first rank alone (the others' equal
            # it bit for bit, by digest), to keep the files small
            "model": ({k: v.detach().clone() for k, v in blob["model"].items()}
                      if group is None or group.global_rank == 0 else None),
            "digest": _digest(blob["model"]), "local_digest": _digest(local),
            "local_shapes": {k: tuple(v.shape) for k, v in local.items()},
            "step": tr.optimizer.step_count, "mask_elements": Dropout.mask_elements,
            "sharded": tp.sharded_names(tr.model) if tr.shards else [],
            "tp": (tr.shards.rank, tr.shards.size) if tr.shards else None,
            "wrote": sorted(os.listdir(tr.save_dir)) if os.path.isdir(tr.save_dir) else None}
        for name in results[case["name"]]["wrote"] or ():   # weights no case reads again
            if name.startswith("model-"):
                os.remove(os.path.join(tr.save_dir, name))
    torch.save(results, plan["out"])
    if group is not None:
        dp.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1])
