"""TwDH trainer (counterpart of ``cmh_tpu/runners/twdh.py``).

The softmax hash is required. ``valid`` encodes each batch once into a
long-code buffer and one buffer per short width, runs one 4-direction mAP
for the long code (``long_dim`` bits: K3 through int16 words at 512) and
one for each short width, and keeps its own best tracking per short width
(``max_short``, ``best_epoch_short``), carried by the checkpoint's
``extra`` meta. Only a new best of the long code saves ``model-<epoch>``;
each width's new bests write ``{i2t,t2i}-long.mat`` or
``{i2t,t2i}-short-<k>.mat``. The base ``test`` evaluates the long code
(cmh_tpu's unpacks TwDH's four buffers into two and fails).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..registry import registry
from .base import BaseTrainer, _waited


@registry.register_runner("TwDHTrainer")
class TwDHTrainer(BaseTrainer):
    def __init__(self, cfg, **kwargs):
        self.hash_func = cfg.model.get("hash_func", "softmax")
        assert self.hash_func == "softmax", "TwDH must adopt the 'softmax' hash technique."
        self.hash_scale = 2
        self.long_dim = int(cfg.model.get("long_dim", 512))
        self.max_short, self.best_epoch_short = {}, {}
        super().__init__(cfg, **kwargs)

    def build_model(self, cfg_model, output_dim=16):
        super().build_model(cfg_model, output_dim=output_dim)
        for item in self.method.short_dims:
            self.max_short[str(item)] = {"i2t": 0.0, "t2i": 0.0}
            self.best_epoch_short[str(item)] = {"i2t": 0, "t2i": 0}

    def _extra_checkpoint_meta(self):
        return {"max_short": self.max_short, "best_epoch_short": self.best_epoch_short}

    def _restore_extra_checkpoint_meta(self, extra):
        if extra:
            self.max_short = {s: {d: float(v) for d, v in t.items()}
                              for s, t in extra["max_short"].items()}
            self.best_epoch_short = {s: {d: int(v) for d, v in t.items()}
                                     for s, t in extra["best_epoch_short"].items()}

    @torch.no_grad()
    def get_code(self, data_loader, length: int, wait=None):
        """±1 codes of every item: (long image, long text, {width: short
        image}, {width: short text}); under data parallelism each rank's rows
        of every batch, summed over the ranks, as the base ``get_code``."""
        self.model.eval()
        dev = self.device

        def zeros(k):
            return torch.zeros((length, k), dtype=torch.float32, device=dev)

        widths = [str(d) for d in self.method.short_dims]
        bufs = (zeros(self.long_dim), zeros(self.long_dim),
                {w: zeros(int(w)) for w in widths}, {w: zeros(int(w)) for w in widths})
        for batch in _waited(data_loader, [0.0] if wait is None else wait):
            b = self._to_device(self.eval_rows(batch))
            valid = b["valid"].bool()
            idx = b["index"].long()[valid]
            il, ish = self.method.encode_image(b["image"])
            tl, tsh = self.method.encode_text(b["text"], b["key_padding_mask"])
            make = self.method.make_hash_code
            bufs[0][idx] = make(il)[valid]
            bufs[1][idx] = make(tl)[valid]
            for w in widths:
                bufs[2][w][idx] = make(ish[w])[valid]
                bufs[3][w][idx] = make(tsh[w])[valid]
        return self.join_codes(bufs)

    def valid(self, epoch: int, k: Optional[int] = None):
        save_dir = self.mat_dir()
        self.logger.info("Valid.")
        t0, wait = time.time(), [0.0]
        q_li, q_lt, q_si, q_st = self.get_code(self.query_loader, self.query_num, wait)
        r_li, r_lt, r_si, r_st = self.get_code(self.retrieval_loader, self.retrieval_num, wait)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_code = time.time() - t0
        t0 = time.time()
        by_width = {"long": self.valid_each(epoch, q_li, q_lt, r_li, r_lt, k, save_dir)}
        for key in q_si:
            by_width[key] = self.valid_each(epoch, q_si[key], q_st[key], r_si[key], r_st[key],
                                            k, save_dir, short=key)
        t_map = time.time() - t0
        self.logger.info(f"eval timing: code generation {t_code:.2f}s "
                         f"(waited {wait[0]:.2f}s for data), {len(by_width)}×4×mAP {t_map:.2f}s")
        if self.history and self.history[-1]["epoch"] == epoch:
            self.history[-1].update(maps=by_width["long"], maps_by_width=by_width,
                                    code_s=t_code, code_data_wait_s=wait[0], map_s=t_map)
        return by_width["long"]

    def valid_each(self, epoch, query_img, query_txt, retrieval_img, retrieval_txt, k=None,
                   save_dir=None, short=None):
        mapi2t, mapt2i, mapi2i, mapt2t = self.calc_map_4dir(
            query_img, query_txt, retrieval_img, retrieval_txt, k)
        codes = (query_img, query_txt, self.query_labels_np, retrieval_img, retrieval_txt,
                 self.retrieval_labels_np)
        if short is None:
            if self.max_mapi2t < mapi2t:
                self.best_epoch_i = epoch
                self.save_mat(*codes, save_file=os.path.join(save_dir, "i2t-long.mat"))
                self.save_model_once(self.save_dir, epoch)
            self.max_mapi2t = max(self.max_mapi2t, mapi2t)
            if self.max_mapt2i < mapt2i:
                self.best_epoch_t = epoch
                self.save_mat(*codes, save_file=os.path.join(save_dir, "t2i-long.mat"))
                self.save_model_once(self.save_dir, epoch)
            self.max_mapt2i = max(self.max_mapt2i, mapt2i)
            self.logger.info(
                f">>>>>> [{epoch}/{self.epochs}], Long, {query_img.shape[-1]} Bit, "
                f"MAP(i->t): {mapi2t}, MAP(t->i): {mapt2i}, MAP(t->t): {mapt2t}, "
                f"MAP(i->i): {mapi2i}, MAX MAP(i->t): {self.max_mapi2t}, "
                f"epoch: {self.best_epoch_i}, MAX MAP(t->i): {self.max_mapt2i}, "
                f"epoch: {self.best_epoch_t}")
        else:
            track, best = self.max_short[short], self.best_epoch_short[short]
            for d, m in (("i2t", mapi2t), ("t2i", mapt2i)):
                if track[d] < m:
                    best[d] = epoch
                    self.save_mat(*codes,
                                  save_file=os.path.join(save_dir, f"{d}-short-{short}.mat"))
                track[d] = max(track[d], m)
            self.logger.info(
                f">>>>>> [{epoch}/{self.epochs}], Short, {query_img.shape[-1]} Bit, "
                f"MAP(i->t): {mapi2t}, MAP(t->i): {mapt2i}, MAP(t->t): {mapt2t}, "
                f"MAP(i->i): {mapi2i}, MAX MAP(i->t): {track['i2t']}, "
                f"epoch: {best['i2t']}, MAX MAP(t->i): {track['t2i']}, epoch: {best['t2i']}")
        return mapi2t, mapt2i, mapi2i, mapt2t
