"""UMoED trainer (counterpart of ``cmh_tpu/runners/umoed.py``).

``valid`` tracks the best mAP in all four directions (the i→i and t→t
bests and their epochs ride in the checkpoint's ``extra`` meta), writes
each new best's ``{i2t,t2i,i2i,t2t}-best.mat`` and ``last.mat`` with the
reference's fusion code buffers (``q_fus``, ``r_fus``: zeros, as the
reference writes them), and saves no model file on a best (the reference
has those saves commented out).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..registry import registry
from .base import BaseTrainer, host_arrays


@registry.register_runner("UMoEDTrainer")
class UMoEDTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "linear_subspace")
        self.hash_scale = 2 if self.hash_func == "softmax" else 1
        cfg.model.update({"txt_token_size": cfg.dataset.get("max_word", 32)})
        self.max_mapi2i = 0.0
        self.max_mapt2t = 0.0
        self.best_epoch_i2i = 0
        self.best_epoch_t2t = 0
        super().__init__(cfg, **kwargs)

    def _extra_checkpoint_meta(self):
        return {"max_mapi2i": float(self.max_mapi2i), "max_mapt2t": float(self.max_mapt2t),
                "best_epoch_i2i": int(self.best_epoch_i2i),
                "best_epoch_t2t": int(self.best_epoch_t2t)}

    def _restore_extra_checkpoint_meta(self, extra):
        if extra:
            self.max_mapi2i = float(extra["max_mapi2i"])
            self.max_mapt2t = float(extra["max_mapt2t"])
            self.best_epoch_i2i = int(extra["best_epoch_i2i"])
            self.best_epoch_t2t = int(extra["best_epoch_t2t"])

    def valid(self, epoch: int, k: Optional[int] = None):
        save_dir = self.mat_dir()
        (q_img, q_txt, r_img, r_txt), maps = self.valid_codes_and_maps(epoch, k)
        mapi2t, mapt2i, mapi2i, mapt2t = maps
        q_fus, r_fus = torch.zeros_like(q_img), torch.zeros_like(r_img)

        def save(name):
            self.save_mat_fusion(q_img, q_txt, q_fus, self.query_labels_np, r_img, r_txt,
                                 r_fus, self.retrieval_labels_np,
                                 save_file=os.path.join(save_dir, name))

        if self.max_mapi2t < mapi2t:
            self.best_epoch_i = epoch
            save("i2t-best.mat")
        self.max_mapi2t = max(self.max_mapi2t, mapi2t)
        if self.max_mapt2i < mapt2i:
            self.best_epoch_t = epoch
            save("t2i-best.mat")
        self.max_mapt2i = max(self.max_mapt2i, mapt2i)
        if self.max_mapi2i < mapi2i:
            self.best_epoch_i2i = epoch
            save("i2i-best.mat")
        self.max_mapi2i = max(self.max_mapi2i, mapi2i)
        if self.max_mapt2t < mapt2t:
            self.best_epoch_t2t = epoch
            save("t2t-best.mat")
        self.max_mapt2t = max(self.max_mapt2t, mapt2t)
        save("last.mat")
        self.logger.info(
            f">>>>>> [{epoch}/{self.epochs}], MAP(i->t): {mapi2t}, MAP(t->i): {mapt2i}, "
            f"MAP(t->t): {mapt2t}, MAP(i->i): {mapi2i}, MAX MAP(i->t): {self.max_mapi2t}, "
            f"MAX MAP(t->i): {self.max_mapt2i}, MAX MAP(i->i): {self.max_mapi2i}, "
            f"MAX MAP(t->t): {self.max_mapt2t}")
        return maps

    def save_mat_fusion(self, query_img, query_txt, query_fusion, query_labels, retrieval_img,
                        retrieval_txt, retrieval_fusion, retrieval_labels, save_file="i2t"):
        """``save_mat``'s schema with the fusion buffers ``q_fus`` and
        ``r_fus``; written by rank 0 only."""
        import scipy.io as scio

        if not self.is_writer:
            return

        scio.savemat(save_file, host_arrays(
            q_img=query_img, q_txt=query_txt, q_fus=query_fusion, r_img=retrieval_img,
            r_txt=retrieval_txt, r_fus=retrieval_fusion, q_l=query_labels,
            r_l=retrieval_labels))
