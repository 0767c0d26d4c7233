"""Trainer: the train/eval lifecycle (counterpart of the parts of
``cmh_tpu/runners/base.py`` on the training path).

build dataset → loaders → model (the method's, from the registry; its
backbone read from ``model.clip_path`` when that file exists) → optimizers
(BertAdam, and SGD for the parameters a method keeps apart, such as DSPH's
and DNPH's proxies); then per epoch ``train_epoch`` (one step per batch:
forward in train mode with cmh_tpu's dropout masks from ``run.seed``,
the method's loss, backward through kernels K1-bwd and K2-bwd on the card,
every optimizer) and
``valid`` (±1 codes for the query and retrieval sets, 4-direction mAP
through kernels K3-hist and K3-ap on the card, best tracking, the ``.mat``
dumps and the model file). Everything runs on ``device``, which defaults to
the card; without one the trainer raises unless it is given ``"cpu"``.

Around the loop, as in cmh_tpu (``cmh_tpu/runners/base.py:461-692``,
``:1047-1167``): ``run.checkpoint_every`` writes a full-state checkpoint
(model with BatchNorm statistics, optimizer moments and step count, the
method state such as MITH's memory banks, trainer bookkeeping with a
runner's own ``extra`` meta) after every N epochs;
``run.resume_checkpoint`` loads one; ``run.auto_resume`` takes the newest
checkpoint under the save root whose config fingerprint matches this run's;
SIGTERM, or a crash, writes an emergency checkpoint of the interrupted
epoch (``runners/checkpoint.py`` holds the file format). ``run.profile_dir`` traces ``run.profile_steps``
train steps with ``torch.profiler``. ``run.remat`` recomputes the forward in
the backward (``torch.utils.checkpoint`` around the forward and the loss,
cmh_tpu's ``jax.checkpoint``) on a model without running statistics, and is
ignored with a warning, as cmh_tpu ignores it, on one with them (DCMHT's
BatchNorm).

A checkpoint path ending in ``.msgpack`` is cmh_tpu's full-state format
(``runners/jax_checkpoint.py``): ``run.resume_checkpoint`` reads it,
``run.auto_resume`` weighs cmh_tpu's ``checkpoint-last.msgpack`` and
``emergency.ckpt.msgpack`` beside the port's files, and ``save_checkpoint``
writes it.

Data parallelism (cmh_tpu's ``dp`` mesh, ``runners/base.py:119-129``,
``:407-451``): in a group of ``parallel/dp.py`` (``run.multi_host``,
``--distribute``, or ``run.distribute``, for which ``cmh_torch.main`` opens
a group of one when there is none), each rank runs the CLIP towers on its
rows of the global batch and computes the global loss from the gathered
outputs (``dp.gathered_towers``); the gradients are averaged over the ranks.
BertAdam is then tree-shaped by default, as cmh_tpu's on a mesh. ``valid`` encodes
each rank's rows of every eval batch, sums the code buffers over the ranks,
and ranks each rank's query shard through K3 with one all-reduce of the AP
sums. Every rank holds the same state: a resume reads the checkpoint on
rank 0 and broadcasts the state, and a SIGTERM that reaches any rank stops
every rank at the same step. Only rank 0 writes files and logs to a file.

Tensor parallelism (``run.tp``, cmh_tpu's ``tp`` mesh axis,
``runners/base.py:407-433``; ``parallel/tp.py``): the group is a (dp, tp)
mesh. The model is built whole from the seed (and any file it reads), then
each rank keeps its shards, so a tp run starts from the single process's
weights. The ranks of a tensor-parallel group see the same rows; the towers'
rows are gathered, the gradients averaged, the codes summed and the
``valid`` sharded over the data-parallel group alone. BertAdam clips a
sharded leaf by the whole tensor's norm. Every file is written in the
single-process layout, gathered to rank 0 (``.pt`` checkpoints, ``model-N``
and cmh_tpu's ``checkpoint-last.msgpack``), so a tp run resumes a
single-process or cmh_tpu file and the other way round; a resume reads the
file on rank 0, which broadcasts it, and each rank keeps its shards. The run
fingerprint does not hold tp, as cmh_tpu's does not.
"""

from __future__ import annotations

import contextlib
import copy
import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..config import ConfigNode
from ..data.builder import build_dataloader
from ..data.loader import HostDataLoader
from ..models.base import existing_clip_path, resolve_clip_cfg
from ..models.clip.loader import read_torch_state_dict
from ..models.common import dropout_rng
from ..optim.bert_adam import BertAdam
from ..optim.partition import param_groups
from ..parallel import dp, tp
from ..registry import load_components, registry
from ..utils import prng, trace
from ..utils.logger import get_color_logger
from ..utils.seed import set_seed
from . import checkpoint, jax_checkpoint

class PreemptionRequested(Exception):
    """SIGTERM arrived during training. ``train`` turns it into an emergency
    checkpoint and a clean return, so the same command restarted with
    ``run.auto_resume`` continues."""


class BaseTrainer:
    def __init__(self, cfg: ConfigNode, is_train: bool = True, logger=None,
                 device="cuda", output_dim: int = 16, train_num: int = 10000,
                 query_num: int = 5000, epochs: int = 100,
                 save_dir: str = "./result", display_step: int = 20,
                 top_k: Optional[int] = None, model_state: str = "",
                 batch_size: int = 128, auto_run: bool = True, **kwargs) -> None:
        load_components()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = int(cfg.run.get("seed", 1814))
        self.rng = set_seed(self.seed)
        self.dp = dp.current()
        if self.dp is None and cfg.run.get("distribute", False):
            raise ValueError("run.distribute needs a data-parallel group: run the config "
                             "through cmh_torch.main (run_config), which opens one")
        if self.dp is not None and self.dp.device.type != self.device.type:
            raise ValueError(f"the data-parallel group runs on {self.dp.device.type}, "
                             f"this trainer on {self.device.type}")
        tp_size = int(cfg.run.get("tp", 1) or 1)
        tp.check_world(1 if self.dp is None else self.dp.world * self.dp.tp, tp_size)
        if self.dp is not None and self.dp.tp != tp_size:
            raise ValueError(f"run.tp={tp_size}, but the process group was opened with "
                             f"tp={self.dp.tp}")
        self.shards = None if self.dp is None else self.dp.shards
        # only rank 0 writes the model, .mat files, checkpoints and the log file
        self.is_writer = self.dp is None or self.dp.global_rank == 0
        self.logger = logger or get_color_logger(
            cfg.run.get("log_dir") if self.is_writer else None,
            str(cfg.dataset.get("name", "dataset")) + "-" + self.device.type)
        self.logger.info(f"parameters: {cfg.to_dict()}")
        if int(cfg.run.get("scan_steps", 1)) > 1:
            self.logger.info(
                "run.scan_steps has no effect in cmh_torch: steps run one at a "
                "time (cmh_tpu's scan batches dispatches and equals per-step "
                "stepping, tests/test_train_scan.py)")
        self.is_train = is_train
        self.output_dim = output_dim
        self.train_num = train_num
        self.query_num = query_num
        self.epochs = epochs
        self.display_step = display_step
        self.top_k = top_k
        self.model_state = model_state
        self.batch_size = batch_size
        self.save_dir = save_dir
        if self.is_writer:
            os.makedirs(save_dir, exist_ok=True)

        self.global_step = 0
        self.max_mapi2t = 0.0
        self.max_mapt2i = 0.0
        self.best_epoch_i = 0
        self.best_epoch_t = 0
        self.loss_type = kwargs.get("loss_type", "l1")
        self._last_model_save = None
        # a torch.profiler trace of run.profile_steps train steps from the second
        self.profile_dir = cfg.run.get("profile_dir", None)
        self.profile_steps = int(cfg.run.get("profile_steps", 5))
        self._profiler = None
        self._preempt_signal = None
        # one dict per epoch: loss, steps, pairs, train seconds, then the mAPs
        self.history = []

        self.build_dataset(cfg.dataset, train_num=train_num, query_num=query_num,
                           batch_size=batch_size, shuffle=cfg.run.get("shuffle", True))
        self.build_model(cfg.model, output_dim=output_dim)
        self.build_optimizer(cfg.optimizer)
        if self.dp is not None:
            # every rank starts from its data-parallel group's rank 0's model
            # and method state (the same shards: one tensor-parallel index)
            dp.broadcast_([*(p.detach() for p in self.model.parameters()),
                           *self.model.buffers(), *_tree_leaves(self.method_state)], self.dp)
            self.logger.info(f"data parallel: rank {self.dp.rank} of {self.dp.world}")
        if auto_run:
            self.run()

    # ------------------------------------------------------------------ data
    def build_dataset(self, cfg_dataset, train_num=10000, query_num=5000,
                      batch_size=128, shuffle=True):
        dataname = cfg_dataset.get("name", "synthetic")
        path = cfg_dataset.get("path", "./data")
        self.logger.info(f"Using {dataname} dataset.")
        files = {key: os.path.join(path, dataname, cfg_dataset.get(key, default))
                 for key, default in (("img_file", "index.mat"),
                                      ("txt_file", "caption.mat"),
                                      ("label_file", "label.mat"))}
        dataset_cls = cfg_dataset.get("arch", "transformer_dataset")
        tokenizer_cls = registry.get_tokenizer_class(
            cfg_dataset.get("tokenizer_arch", "clip_tokenizer"))
        tokenizer = tokenizer_cls() if tokenizer_cls else None
        extra = {}
        if dataset_cls == "synthetic_dataset":
            extra["num_classes"] = cfg_dataset.get("num_classes", 8)
            extra["num_items"] = cfg_dataset.get("num_items", query_num + 2 * train_num)
        train_data, query_data, retrieval_data = build_dataloader(
            captionFile=files["txt_file"], indexFile=files["img_file"],
            labelFile=files["label_file"],
            imageResolution=cfg_dataset.get("image_resolution", 224),
            maxWords=cfg_dataset.get("max_word", 32), query_num=query_num,
            train_num=train_num, dataset_cls=dataset_cls, tokenizer=tokenizer,
            **extra)
        self.build_loader(train_data, query_data, retrieval_data,
                          batch_size=batch_size, shuffle=shuffle)

    def build_loader(self, train_data, query_data, retrieval_data,
                     batch_size=128, shuffle=True):
        self.train_labels = train_data.get_all_label()
        self.query_labels_np = query_data.get_all_label()
        self.retrieval_labels_np = retrieval_data.get_all_label()
        self.query_labels = torch.as_tensor(self.query_labels_np, device=self.device)
        self.retrieval_labels = torch.as_tensor(self.retrieval_labels_np,
                                                device=self.device)
        self.retrieval_num = int(self.retrieval_labels.shape[0])
        self.logger.info(f"train shape: {self.train_labels.shape}")
        self.logger.info(f"query shape: {tuple(self.query_labels.shape)}")
        self.logger.info(f"retrieval shape: {tuple(self.retrieval_labels.shape)}")
        workers = self.cfg.run.get("num_workers", 0)
        eval_batch = self.cfg.run.get("eval_batch_size", batch_size)
        if self.dp is not None:
            dp.check_batch_divisible(batch_size, self.dp.world, "run.batch_size")
            dp.check_batch_divisible(eval_batch, self.dp.world, "run.eval_batch_size")
        self.train_loader = HostDataLoader(train_data, batch_size=batch_size,
                                           shuffle=shuffle, num_workers=workers)
        self.query_loader = HostDataLoader(query_data, batch_size=eval_batch,
                                           num_workers=workers)
        self.retrieval_loader = HostDataLoader(retrieval_data, batch_size=eval_batch,
                                               num_workers=workers)

    # ----------------------------------------------------------------- model
    def build_model(self, cfg_model, output_dim=16):
        arch = cfg_model.get("arch", "DCMHT")
        clip_path = existing_clip_path(cfg_model)
        # the checkpoint is read once, for its geometry and its weights
        sd = read_torch_state_dict(clip_path) if clip_path else None
        self.method = registry.require_model_class(arch).from_config(
            cfg_model, output_dim=output_dim, train_num=self.train_num,
            clip_cfg=resolve_clip_cfg(cfg_model, None, sd))
        self.model = self.method.model
        # methods with train-set-sized state (MITH's memory banks) need the
        # label matrix before init_method_state (cmh_tpu runners/base.py:217-219)
        self.method.train_labels = self.train_labels
        self.method_state = _tree_to(self.method.init_method_state(), self.device)
        # cmh_tpu's key chain (runners/base.py:222, :300): the init key, then
        # the dropout key that each step folds its step number into
        self.rng, init_key = prng.split(self.rng)
        self.rng, self.dropout_base = prng.split(self.rng)
        self.model.init_weights(init_key, self.device)
        if sd is not None:
            self.method.load_pretrained_backbone(sd)
            self.logger.info(f"backbone: loaded {clip_path}")
        else:
            self.logger.info("backbone: random init "
                             f"({cfg_model.get('clip_path', './ViT-B-32.pt')} not found)")
        if self.model_state:
            if not os.path.isfile(self.model_state):
                raise FileNotFoundError(
                    f"run.resume_model points at {self.model_state!r}, which "
                    "does not exist")
            self.logger.info("loading model...")
            self.model.load_state_dict(self.method.read_model_file(self.model_state))
        if self.shards is not None:
            names = tp.shard_model_(self.model, self.shards)
            self.logger.info(f"tensor parallel: rank {self.shards.rank} of {self.shards.size}, "
                             f"{len(names)} parameters sharded")
        self.model.to(self.device)
        self.remat = bool(self.cfg.run.get("remat", False)) and self._check_remat()
        self.logger.info("Building model!")
        self.logger.info(f"Output dim: {self.output_dim}")

    def _check_remat(self) -> bool:
        """Whether ``run.remat`` can apply, by cmh_tpu's rule
        (``runners/base.py:302-311``): a model with mutable state, here
        buffers that a train-mode forward updates (BatchNorm's running
        statistics), cannot be recomputed in the backward without updating
        them twice, so ``run.remat`` is ignored with a warning and
        activations are stored."""
        stateful = sorted({name.rsplit(".", 1)[0] for name, _ in self.model.named_buffers()})
        if not stateful:
            self.logger.info("run.remat: the forward is recomputed in the backward")
            return True
        self.logger.warning(
            f"run.remat ignored: the model carries running statistics ({stateful}) "
            "that a recomputed forward would update twice — activations will be stored")
        return False

    # ------------------------------------------------------------- optimizer
    def build_optimizer(self, cfg_optimizer):
        backbone_lr = cfg_optimizer.get("backbone_lr",
                                        cfg_optimizer.get("clip_lr", 0.00001))
        lr = cfg_optimizer.get("lr", 0.001)
        self._t_total = len(self.train_loader) * self.epochs
        common = dict(
            warmup=cfg_optimizer.get("warmup_proportion", 0.1),
            t_total=self._t_total,
            schedule=cfg_optimizer.get("schedule", "warmup_cosine"),
            b1=cfg_optimizer.get("b1", 0.9), b2=cfg_optimizer.get("b2", 0.98),
            e=cfg_optimizer.get("e", 1e-6),
            weight_decay=cfg_optimizer.get("weight_decay", 0.2),
            max_grad_norm=cfg_optimizer.get("max_grad_norm", 1.0))
        # what the run fingerprint hashes, built as cmh_tpu builds it
        self._opt_cfg = dict(common, lr=lr, backbone_lr=backbone_lr)
        # parameters a method trains apart (cmh_tpu's extra_optimizers): one
        # SGD each, and out of BertAdam's groups
        extra = self.method.extra_param_groups(cfg_optimizer)
        self.extra_optimizers = {g["name"]: torch.optim.SGD([dict(g)], lr=g["lr"])
                                 for g in extra}
        # the flat path by default, the tree path under data parallelism, as
        # cmh_tpu runs them off and on a mesh (runners/base.py:270-274)
        self.optimizer = BertAdam(
            param_groups(self.model, lr, backbone_lr,
                         exclude=[p for g in extra for p in g["params"]]),
            lr=lr, flat=bool(cfg_optimizer.get("flat", self.dp is None)), **common)
        if self.shards is not None:
            self.optimizer.shard_norms([p for n, p in self.model.named_parameters()
                                        if tp.split_for(n)], self.shards)
        self._lrs = (lr, backbone_lr)
        self.logger.info("Building optimizer!")

    # ------------------------------------------------------------------- run
    def run(self):
        if self.is_train:
            self.train()
        else:
            self.test()

    def _config_fingerprint(self) -> dict:
        """Identity of this run for resume safety, key for key cmh_tpu's: two
        runs may resume each other's checkpoints only if every field
        matches. The optimizer and model sections are hashed whole, since
        hyperparameters that leave the state's structure unchanged still
        change the trajectory."""
        return {
            "method": str(self.cfg.model.get("arch", "")),
            "runner": type(self).__name__,
            "output_dim": int(self.output_dim),
            "dataset": str(self.cfg.dataset.get("name", "")),
            "train_num": int(self.train_num),
            "query_num": int(self.query_num),
            "retrieval_num": int(self.retrieval_num),
            "batch_size": int(self.batch_size),
            "optimizer_hash": checkpoint.digest([self._opt_cfg, self.cfg.optimizer.to_dict()]),
            "model_hash": checkpoint.digest(self.cfg.model.to_dict()),
        }

    def _resume_candidates(self):
        """The checkpoints under the save root (the directory holding this
        run's timestamped save dir) whose fingerprint matches this run's,
        newest first. Foreign and fingerprint-less ones are skipped with
        the reason logged."""
        mine = self._config_fingerprint()
        for path in checkpoint.candidates(os.path.dirname(os.path.abspath(self.save_dir))):
            fp = checkpoint.read_fingerprint(path)
            if fp == mine:
                yield path
            elif fp is None:
                self.logger.info(
                    f"auto_resume: skipping {path} (no config fingerprint — "
                    "legacy checkpoint; use run.resume_checkpoint to load it)")
            else:
                self.logger.info(
                    f"auto_resume: skipping {path} (config fingerprint mismatch on "
                    f"{checkpoint.fingerprint_diff(mine, fp)})")

    def _resume(self) -> int:
        """The epoch to start at: 0, or the one ``run.resume_checkpoint`` or
        the newest loadable ``run.auto_resume`` candidate names."""
        return self._resume_blob()[0]

    def _resume_blob(self):
        """``_resume``'s epoch and the state it loaded (``_state_blob``'s, in
        the single-process layout; None when it starts fresh)."""
        resume_from = self.cfg.run.get("resume_checkpoint", None)
        if resume_from:
            return self._load_checkpoint(resume_from)
        if not self.cfg.run.get("auto_resume", False):
            return 0, None
        pristine = None
        for cand in self._resume_candidates():
            # copies of all that a load changes (this rank's shards): one that
            # fails may have changed some of it before it raised
            pristine = pristine or copy.deepcopy(self._state_blob(0, whole=False))
            try:
                return self._load_checkpoint(cand)
            except Exception as e:
                # an unreadable candidate (truncated by an ungraceful kill,
                # say) must not stop the restart: try the next, or start fresh
                self.logger.warning(f"auto_resume: {cand} unreadable "
                                    f"({type(e).__name__}: {e}) — trying next candidate")
                self._load_state_blob(pristine, whole=False)
                self._restore_meta(pristine["meta"])
        return 0, None

    def _resume_every_rank(self) -> int:
        """``_resume`` under data parallelism: rank 0 alone reads the
        checkpoint (the others may not see its file) and every rank takes
        the state it read (in the single-process layout; each keeps its
        shards), its meta and start epoch."""
        if self.dp is None:
            return self._resume()
        state = None
        if self.dp.global_rank == 0:
            try:
                state = self._resume_blob()[1]
            except Exception as e:
                dp.broadcast_tree(f"{type(e).__name__}: {e}", self.dp)
                raise
        state = dp.broadcast_tree(state, self.dp)
        if isinstance(state, str):
            raise RuntimeError(f"rank 0 could not resume ({state})")
        if state is None:            # nothing to resume
            return 0
        if self.dp.global_rank != 0:
            self._load_state_blob(state)
            self._restore_meta(state["meta"])
        return int(state["meta"]["epoch"])

    def train(self):
        start_epoch = self._resume_every_rank()
        ckpt_every = int(self.cfg.run.get("checkpoint_every", 0) or 0)
        # SIGTERM only sets a flag; the loop raises PreemptionRequested at
        # its next safe point (after a step, between epochs). Only the main
        # thread may install a handler: trainers driven from other threads
        # run without one.
        self._preempt_signal = None

        def on_sigterm(signum, frame):
            self._preempt_signal = signum

        try:
            previous = signal.signal(signal.SIGTERM, on_sigterm)
            installed = True
        except ValueError:
            installed = False
        epoch = start_epoch
        emergency = os.path.join(self.save_dir, checkpoint.EMERGENCY)
        try:
            for epoch in range(start_epoch, self.epochs):
                self._check_preempted()
                self.train_epoch(epoch)
                self.valid(epoch, k=self.top_k)
                if ckpt_every and (epoch + 1) % ckpt_every == 0:
                    self.save_checkpoint(os.path.join(self.save_dir, checkpoint.CHECKPOINT_LAST),
                                         epoch=epoch + 1)
        except PreemptionRequested:
            # the interrupted epoch runs again on resume
            try:
                self.save_checkpoint(emergency, epoch=epoch)
            except Exception:
                self.logger.exception("preempted (SIGTERM); emergency save failed too")
                return
            self.logger.error(f"preempted (SIGTERM) — state saved to {emergency}; restart "
                              "the same command with run.auto_resume to continue")
            return
        except Exception:
            if self.shards is not None:
                # the other ranks of the group may never reach the gather
                self.logger.error("training crashed — under tensor parallelism no "
                                  "emergency checkpoint is written")
                raise
            try:
                self.save_checkpoint(emergency, epoch=epoch)
                self.logger.error(f"training crashed — state saved to {emergency}")
            except Exception:
                self.logger.exception("training crashed; emergency save failed too")
            raise
        finally:
            if installed:
                signal.signal(signal.SIGTERM, previous)
            self._stop_profiler()
        self.logger.info(
            f">>>>>>> FINISHED >>>>>> Best epoch, I-T: {self.best_epoch_i}, "
            f"mAP: {self.max_mapi2t}, T-I: {self.best_epoch_t}, mAP: {self.max_mapt2i}")

    def _check_preempted(self):
        """Raise PreemptionRequested if SIGTERM arrived (once per signal);
        under data parallelism on every rank when it reached any, so that
        all stop at the same step and rank 0 saves."""
        sig = self._preempt_signal
        if self.dp is not None:
            sig = dp.agree(sig or 0) or None
        if sig is not None:
            self._preempt_signal = None
            raise PreemptionRequested(f"signal {sig}")

    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _optimizers(self):
        return [self.optimizer, *self.extra_optimizers.values()]

    def train_step(self, batch):
        """One step of every optimizer on a host batch; returns (loss,
        loss_dict) as device tensors. Dropout masks come from cmh_tpu's key
        ``fold_in(dropout_base, step)`` and a method's per-step randomness
        from its own keys folded with step, the optimizer step count
        (cmh_tpu's ``state.step``). Under data
        parallelism the towers take this rank's rows of the batch and
        everything after them the gathered global batch. Under a profiler
        the step is the span ``cmh.train_step`` over its phases
        (``utils/trace.py``)."""
        with trace.span("train_step"):
            self.model.train()
            step = self.optimizer.step_count
            with trace.span("to_device"):
                if self.dp is None:
                    b = self._to_device(batch)
                    towers = contextlib.nullcontext
                else:
                    b = self._to_device({k: v for k, v in batch.items() if k != "image"})
                    b.update(self._to_device(dp.shard_batch({k: batch[k] for k in dp.ROW_KEYS},
                                                            self.dp)))
                    towers = lambda: dp.gathered_towers(self.model.backbone, self.dp)  # noqa: E731

            step_key = prng.fold_in(self.dropout_base, step)

            def forward_and_loss(image, text, kpm):
                with trace.span("forward"), dropout_rng(step_key), towers():
                    outputs = self.model(image, text, kpm)
                with trace.span("loss"):
                    return self.method.loss(outputs, b, self.method_state, step)

            args = (b["image"], b["text"], b["key_padding_mask"])
            if self.remat:
                loss, loss_dict, method_state = torch.utils.checkpoint.checkpoint(
                    forward_and_loss, *args, use_reentrant=False)
            else:
                loss, loss_dict, method_state = forward_and_loss(*args)
            with trace.span("zero_grad"):
                for opt in self._optimizers():
                    opt.zero_grad(set_to_none=True)
            with trace.span("backward"):
                loss.backward()
            if self.dp is not None:
                with trace.span("grad_allreduce"):
                    dp.average_gradients(self.model.parameters(), self.dp)
            with trace.span("optimizer"):
                for opt in self._optimizers():
                    opt.step()
            self.method_state = method_state
            return loss.detach(), loss_dict

    def train_epoch(self, epoch: int):
        self.logger.info(">>>>>> epochs: %d/%d" % (epoch, self.epochs))
        all_loss, times, examples, wait = None, 0, 0, [0.0]
        t0 = time.perf_counter()
        for batch in _waited(self.train_loader, wait):
            self.global_step += 1
            times += 1
            if (self.profile_dir and self.is_writer and self.global_step == 2
                    and self._profiler is None):
                self._start_profiler()
            loss, loss_dict = self.train_step(batch)
            all_loss = loss if all_loss is None else all_loss + loss
            examples += int(batch["valid"].sum())
            self._check_preempted()
            if self._profiler is not None and self.global_step >= 1 + self.profile_steps:
                self._stop_profiler()
            if self.global_step % self.display_step == 0:
                with trace.wait("display_loss"):
                    shown = _floats(loss_dict)
                self.print_loss_dict(shown, bits=self.output_dim, epoch=epoch, times=times)
        self._stop_profiler()   # an epoch shorter than the window
        # the host read of the loss waits for the card: take it before the clock
        with trace.wait("epoch_loss"):
            epoch_loss = float(all_loss) / max(times, 1) if all_loss is not None else 0.0
        dt = time.perf_counter() - t0
        self.history.append({"epoch": epoch, "loss": epoch_loss, "steps": times,
                             "pairs": examples, "seconds": dt, "data_wait_s": wait[0]})
        self.logger.info(
            f">>>>>> [{epoch}/{self.epochs}] loss: {epoch_loss}, "
            f"lr: {self._current_lr_str()}, "
            f"throughput: {examples / max(dt, 1e-9):.1f} pairs/s, "
            f"waited {wait[0]:.2f}s of {dt:.2f}s for data")

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._profile_first = self.global_step

    def _stop_profiler(self):
        """Close an open trace window and write its Chrome trace under
        ``profile_dir``."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # a trace stopped early misses the kernels
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"train-steps-{self._profile_first}-"
                                              f"{self.global_step}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")

    def _current_lr_str(self) -> str:
        factor = self.optimizer.lr_factor()
        return "-".join("%.9f" % x for x in sorted({lr * factor for lr in self._lrs}))

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def generate_hash(self, batch):
        """Continuous (image, text) codes for one host batch, eval mode."""
        self.model.eval()
        b = self._to_device(batch)
        with trace.span("encode_image"):
            image = self.model.encode_image(b["image"])
        with trace.span("encode_text"):
            text = self.model.encode_text(b["text"], b["key_padding_mask"])
        return image, text

    @torch.no_grad()
    def get_code(self, data_loader, length: int, wait=None):
        """±1 codes (image, text) of every item, indexed by the batches'
        ``index``; ``wait``, a one-element list, gathers the seconds spent
        waiting for the loader. Under data parallelism each rank encodes its
        rows of every batch (``eval_rows``) and ``join_codes`` sums the
        buffers over the ranks. Under a profiler: the span ``cmh.get_code``,
        in each batch ``cmh.encode_image``, ``cmh.encode_text`` and
        ``cmh.make_code``, and a ``cmh.wait.*`` span at each of the batch's
        three boolean indexings, where the host waits for the card."""
        with trace.span("get_code"):
            k = self.method.eval_code_dims()
            bufs = (torch.zeros((length, k), dtype=torch.float32, device=self.device),
                    torch.zeros((length, k), dtype=torch.float32, device=self.device))
            for batch in _waited(data_loader, [0.0] if wait is None else wait):
                batch = self.eval_rows(batch)
                valid = torch.as_tensor(batch["valid"], device=self.device)
                with trace.wait("get_code_index"):
                    idx = torch.as_tensor(batch["index"], device=self.device).long()[valid]
                for buf, h in zip(bufs, self.generate_hash(batch)):
                    with trace.span("make_code"):
                        code = self.method.make_hash_code(h)
                        with trace.wait("get_code_rows"):
                            code = code[valid]
                        buf[idx] = code.to(buf.dtype)
            return self.join_codes(bufs)

    def eval_rows(self, batch):
        """This rank's rows of an eval batch (all of it off data parallelism)."""
        return batch if self.dp is None else dp.shard_batch(batch, self.dp, batch.keys())

    def join_codes(self, bufs):
        """Code buffers (a tree of tensors) summed over the ranks: each item
        is written by one rank, the others hold zeros."""
        if self.dp is not None:
            dp.all_reduce_sum_(_tree_leaves(bufs), self.dp)
        return bufs

    def valid_codes_and_maps(self, epoch: int, k: Optional[int] = None):
        """``valid``'s common part: the ±1 codes of the query and retrieval
        sets, the four mAPs (i→t, t→i, i→i, t→t), their timing logged and
        kept in the epoch's ``history`` entry; returns ((query_img,
        query_txt, retrieval_img, retrieval_txt), maps). Under a profiler
        the span ``cmh.valid`` over ``cmh.get_code`` (twice) and
        ``cmh.map_4dir``."""
        self.logger.info("Valid.")
        with trace.span("valid"):
            t0, wait = time.perf_counter(), [0.0]
            query_img, query_txt = self.get_code(self.query_loader, self.query_num, wait)
            retrieval_img, retrieval_txt = self.get_code(self.retrieval_loader,
                                                         self.retrieval_num, wait)
            if self.device.type == "cuda":
                with trace.wait("code_sync"):
                    torch.cuda.synchronize(self.device)
            t_code = time.perf_counter() - t0
            t0 = time.perf_counter()
            with trace.span("map_4dir"):
                maps = self.calc_map_4dir(query_img, query_txt, retrieval_img, retrieval_txt,
                                          k)
            t_map = time.perf_counter() - t0
        self.logger.info(f"eval timing: code generation {t_code:.2f}s "
                         f"(waited {wait[0]:.2f}s for data), 4×mAP {t_map:.2f}s")
        if self.history and self.history[-1]["epoch"] == epoch:
            self.history[-1].update(maps=maps, code_s=t_code, code_data_wait_s=wait[0],
                                    map_s=t_map)
        return (query_img, query_txt, retrieval_img, retrieval_txt), maps

    def valid(self, epoch: int, k: Optional[int] = None):
        save_dir = self.mat_dir()
        (query_img, query_txt, retrieval_img, retrieval_txt), maps = \
            self.valid_codes_and_maps(epoch, k)
        mapi2t, mapt2i, mapi2i, mapt2t = maps
        codes = (query_img, query_txt, self.query_labels_np, retrieval_img,
                 retrieval_txt, self.retrieval_labels_np)
        if self.max_mapi2t < mapi2t:
            self.best_epoch_i = epoch
            self.save_mat(*codes, save_file=os.path.join(save_dir, "i2t-best.mat"))
            self.save_model_once(self.save_dir, epoch)
        self.max_mapi2t = max(self.max_mapi2t, mapi2t)
        if self.max_mapt2i < mapt2i:
            self.best_epoch_t = epoch
            self.save_mat(*codes, save_file=os.path.join(save_dir, "t2i-best.mat"))
            self.save_model_once(self.save_dir, epoch)
        self.max_mapt2i = max(self.max_mapt2i, mapt2i)
        self.save_mat(*codes, save_file=os.path.join(save_dir, "last.mat"))
        self.logger.info(
            f">>>>>> [{epoch}/{self.epochs}], MAP(i->t): {mapi2t}, MAP(t->i): {mapt2i}, "
            f"MAP(t->t): {mapt2t}, MAP(i->i): {mapi2i}, "
            f"MAX MAP(i->t): {self.max_mapi2t}, epoch: {self.best_epoch_i}, "
            f"MAX MAP(t->i): {self.max_mapt2i}, epoch: {self.best_epoch_t}")
        return maps

    def calc_map_4dir(self, query_img, query_txt, retrieval_img, retrieval_txt,
                      k: Optional[int]):
        """Four-direction mAP: K3 on the card, the plain counting rank on the
        CPU, the argsort route for codes over 4094 bits; under data
        parallelism sharded over the queries of the group."""
        from ..ops.map_bucketed import calc_map_k_4dir_auto, calc_map_k_4dir_sharded

        args = (query_img, query_txt, retrieval_img, retrieval_txt, self.query_labels,
                self.retrieval_labels, k)
        if self.dp is not None:
            return calc_map_k_4dir_sharded(*args, group=self.dp)
        return calc_map_k_4dir_auto(*args)

    def mat_dir(self) -> str:
        """``<save_dir>/mat_files``, made by the rank that writes."""
        path = os.path.join(self.save_dir, "mat_files")
        if self.is_writer:
            os.makedirs(path, exist_ok=True)
        return path

    def test(self):
        assert self.model_state != "", "test step must provide the model file!"
        self.logger.info("Test.")
        save_dir = self.mat_dir()
        # the first two buffers: TwDH's get_code gives its long codes there
        query_img, query_txt = self.get_code(self.query_loader, self.query_num)[:2]
        retrieval_img, retrieval_txt = self.get_code(self.retrieval_loader,
                                                     self.retrieval_num)[:2]
        maps = self.calc_map_4dir(query_img, query_txt, retrieval_img,
                                  retrieval_txt, self.top_k)
        self.save_mat(query_img, query_txt, self.query_labels_np, retrieval_img,
                      retrieval_txt, self.retrieval_labels_np,
                      save_file=os.path.join(save_dir, "test.mat"))
        mapi2t, mapt2i, mapi2i, mapt2t = maps
        self.logger.info(f">>>>>> TEST, MAP(i->t): {mapi2t}, MAP(t->i): {mapt2i}, "
                         f"MAP(t->t): {mapt2t}, MAP(i->i): {mapi2i}")
        return maps

    # ------------------------------------------------------------- artifacts
    def save_mat(self, query_img, query_txt, query_labels, retrieval_img,
                 retrieval_txt, retrieval_labels, save_file="i2t"):
        """The reference ``.mat`` schema: q_img, q_txt, r_img, r_txt (±1
        codes), q_l, r_l (labels); written by rank 0 only."""
        import scipy.io as scio

        if not self.is_writer:
            return
        scio.savemat(save_file, host_arrays(
            q_img=query_img, q_txt=query_txt, r_img=retrieval_img, r_txt=retrieval_txt,
            q_l=query_labels, r_l=retrieval_labels))

    def save_model_once(self, save_dir, epoch, other=""):
        """``save_model`` that skips a second identical write in one epoch
        (both directions improving save the same weights)."""
        key = (save_dir, epoch, other)
        if self._last_model_save == key:
            return
        self._last_model_save = key
        self.save_model(save_dir, epoch, other)

    def save_model(self, save_dir, epoch, other=""):
        """Weights only: the model's state dict (parameters and the image
        BatchNorm's running statistics) as ``model-<epoch>.pt``, in the
        single-process layout. ``run.resume_model`` reads it back, or a
        cmh_tpu ``model-<epoch>.msgpack`` (``Method.read_model_file``)."""
        if not self._gathers():
            return
        state = self._whole_state_dict()
        if not self.is_writer:
            return
        path = os.path.join(save_dir, "model-" + other + str(epoch) + ".pt")
        state = {k: v.detach().cpu() for k, v in state.items()}
        torch.save(state, path)
        self.logger.info("save mode to {}".format(path))

    def _checkpoint_meta(self, epoch: int) -> dict:
        """Trainer bookkeeping beside the state: ``epoch`` is the next epoch
        to run on resume."""
        return {
            "epoch": int(epoch),
            "global_step": int(self.global_step),
            "max_mapi2t": float(self.max_mapi2t),
            "max_mapt2i": float(self.max_mapt2i),
            "best_epoch_i": int(self.best_epoch_i),
            "best_epoch_t": int(self.best_epoch_t),
            "fingerprint": self._config_fingerprint(),
            "extra": self._extra_checkpoint_meta(),
        }

    def _extra_checkpoint_meta(self) -> dict:
        """A runner's own bookkeeping beside the base trainer's (TwDH's
        per-short-width best tracking), JSON-able scalars only; none here."""
        return {}

    def _restore_extra_checkpoint_meta(self, extra: dict) -> None:
        pass

    def _restore_meta(self, meta: dict) -> None:
        self.global_step = int(meta["global_step"])
        self.max_mapi2t = float(meta["max_mapi2t"])
        self.max_mapt2i = float(meta["max_mapt2i"])
        self.best_epoch_i = int(meta["best_epoch_i"])
        self.best_epoch_t = int(meta["best_epoch_t"])
        self._restore_extra_checkpoint_meta(meta.get("extra") or {})

    def _gathers(self) -> bool:
        """Whether this rank takes part in writing a file: rank 0 and, under
        tensor parallelism, the ranks that gather their shards to it."""
        return self.dp is None or self.dp.rank == 0

    def _param_names(self) -> dict:
        return {id(p): n for n, p in self.model.named_parameters()}

    def whole_likes(self) -> dict:
        """Meta tensors of the parameters' single-process shapes (the
        sharded ones grown back), by ``id(parameter)``: what the converters
        lay a whole state out over."""
        params = list(self.model.parameters())
        if self.shards is None:
            return {id(p): p for p in params}
        likes = tp.whole_likes(params, self._param_names(), self.shards.size)
        return {id(p): like for p, like in zip(params, likes)}

    def _whole_params(self):
        """Per BertAdam group, tensors of its parameters' single-process
        shapes."""
        likes = self.whole_likes()
        return [[likes[id(p)] for p in g["params"]] for g in self.optimizer.param_groups]

    def _whole_state_dict(self) -> dict:
        """The model's state dict in the single-process layout (gathered over
        the tensor-parallel group: every rank of it must call this)."""
        sd = self.model.state_dict()
        return sd if self.shards is None else tp.gather_state_dict(sd, self.shards)

    def _state_blob(self, epoch: int, whole: bool = True) -> dict:
        """The full training state: the model's state dict (parameters and
        BatchNorm statistics), BertAdam's moments and step count, the other
        optimizers' state dicts (SGD momentum buffers), the method state (a
        nested dict of tensors: MITH's memory banks, TwDH's centers and
        transforms; cmh_tpu saves ``state.method_state``) and the trainer's
        bookkeeping. Under tensor parallelism ``whole`` gathers it into the
        single-process layout (every rank of the tensor-parallel group must
        call it); otherwise it holds this rank's shards."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.shards is not None and whole:
            model = tp.gather_state_dict(model, self.shards)
            opt = tp.gather_moments(opt, self.optimizer.param_groups, self._param_names(),
                                    self.shards, self._whole_params())
        return {"model": model,
                "optimizer": opt,
                "extra_optimizers": {k: o.state_dict() for k, o in self.extra_optimizers.items()},
                "method_state": self.method_state,
                "meta": self._checkpoint_meta(epoch)}

    def _load_state_blob(self, blob: dict, whole: bool = True) -> bool:
        """Load the state of ``_state_blob`` (this rank's shards of it under
        tensor parallelism, when ``whole``); returns whether BertAdam's
        state format was converted (flat↔tree). A checkpoint without a
        method state loads only into a method that has none."""
        model, opt = blob["model"], blob["optimizer"]
        converted = any(torch.is_tensor(g["m"]) != self.optimizer.flat for g in opt["groups"])
        if self.shards is not None and whole:
            model = tp.shard_state_dict(model, self.shards.rank, self.shards.size)
            opt = tp.shard_moments(opt, self.optimizer.param_groups, self._param_names(),
                                   self.shards, self._whole_params())
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(opt)
        extra = blob.get("extra_optimizers", {})
        if set(extra) != set(self.extra_optimizers):
            raise KeyError(f"extra optimizers {sorted(extra)} != {sorted(self.extra_optimizers)}")
        for name, opt in self.extra_optimizers.items():
            opt.load_state_dict(extra[name])
        state = blob.get("method_state", {})
        if _tree_keys(state) != _tree_keys(self.method_state):
            raise KeyError(f"method state {_tree_keys(state)} != {_tree_keys(self.method_state)}")
        self.method_state = _tree_to(state, self.device)
        return converted

    def save_checkpoint(self, path: str, epoch: int = 0):
        """``_state_blob`` written to ``path`` with its sidecar, by rank 0
        only (under tensor parallelism its group gathers the shards first);
        a path ending in ``.msgpack`` gets cmh_tpu's layout, its BertAdam
        state flat or tree as this trainer's optimizer keeps it
        (``jax_checkpoint.write`` takes either)."""
        if not self._gathers():
            return
        if checkpoint.is_jax(path):
            jax_checkpoint.write(path, self, epoch, self.optimizer.flat)
        else:
            blob = self._state_blob(epoch)
            if self.is_writer:
                checkpoint.write(path, blob)
        if self.is_writer:
            self.logger.info(f"checkpoint saved to {path}")

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of ``save_checkpoint``, or cmh_tpu's (a
        ``.msgpack`` path); returns the epoch to resume at. An optimizer
        state of the other path (flat or tree) is converted. A fingerprint
        that differs from this run's is named in a warning and the load goes
        on (it was asked for explicitly)."""
        return self._load_checkpoint(path)[0]

    def _load_checkpoint(self, path: str):
        """``load_checkpoint``'s epoch and the state it loaded."""
        jax = checkpoint.is_jax(path)
        blob = jax_checkpoint.decode(path) if jax else checkpoint.read(path)
        try:
            if jax:
                blob = jax_checkpoint.blob_from_jax(blob, self)
            meta = blob["meta"]
            converted = self._load_state_blob(blob)
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            raise ValueError(
                f"checkpoint at {path} does not match this trainer's state structure "
                f"(different method/model config?): {type(e).__name__}: {e}") from e
        if converted and not jax:   # cmh_tpu's moments always come as per-parameter lists
            self.logger.info("optimizer state format converted (flat↔tree) on restore")
        fp, mine = meta.get("fingerprint"), self._config_fingerprint()
        if fp is not None and fp != mine:
            self.logger.warning(
                f"checkpoint config fingerprint differs from this run on "
                f"{checkpoint.fingerprint_diff(mine, fp)} — resuming anyway (explicitly "
                "requested)")
        self._restore_meta(meta)
        start_epoch = int(meta["epoch"])
        self.logger.info(f"checkpoint restored from {path} (resuming at epoch {start_epoch})")
        return start_epoch, blob

    # --------------------------------------------------------------- logging
    def print_loss_dict(self, loss_dict, bits=16, epoch=0, times=0):
        print_str = (f">>>>>> Display ({self.loss_type} loss-{bits}) >>>>>> "
                     f"[{epoch}/{self.epochs}], [{times}/{len(self.train_loader)}]: ")

        def leaf_str(d, key, acc):
            acc += f"{key}: "
            if isinstance(d[key], dict):
                for kk in d[key]:
                    acc = leaf_str(d[key], kk, acc)
            else:
                acc += f"{d[key]}, "
            return acc

        for key in loss_dict.keys():
            print_str += leaf_str(loss_dict, key, "")
        print_str += f"lr: {self._current_lr_str()}"
        self.logger.info(print_str)

    # ------------------------------------------------------------ config API
    @classmethod
    def from_config(cls, cfg=None, device="cuda", logger=None, auto_run=True):
        assert cfg is not None, "config is None!"
        run = cfg.run
        return cls(cfg, is_train=run.get("is_train", True), logger=logger,
                   device=device, output_dim=run.get("output_dim", 16),
                   train_num=run.get("train_num", 10000),
                   query_num=run.get("query_num", 5000),
                   epochs=run.get("epochs", 10),
                   save_dir=run.get("save_dir", "./result"),
                   batch_size=run.get("batch_size", 128),
                   display_step=run.get("display_step", 20),
                   top_k=run.get("top_k", None),
                   model_state=run.get("resume_model", ""),
                   auto_run=auto_run)


def host_arrays(**arrays):
    """Tensors or arrays by name → numpy arrays on the host (a ``.mat``'s
    contents)."""
    return {k: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            for k, a in arrays.items()}


def _waited(loader, wait):
    """Yield the loader's batches, adding the seconds spent waiting for each
    to ``wait[0]`` (the loader prepares batches in a background thread)."""
    it = iter(loader)
    while True:
        t = time.perf_counter()
        batch = next(it, None)
        wait[0] += time.perf_counter() - t
        if batch is None:
            return
        yield batch


def _tree_to(tree, device):
    """A nested dict of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def _tree_leaves(tree):
    """The tensors of a nested dict, tuple or list, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def _tree_keys(tree):
    """The nested key structure of a dict of tensors, with each leaf's
    shape and dtype."""
    if isinstance(tree, dict):
        return {k: _tree_keys(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype))


def _floats(tree):
    """A nested dict of 0-d tensors → the same dict of Python floats."""
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree.detach())
