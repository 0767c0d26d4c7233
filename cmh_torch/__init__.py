"""cmh_torch: PyTorch/CUDA port of the cmh_tpu cross-modal hashing package.

Training (all eight methods: DCMHT, Baseline, DSPH, DNPH, MITH, TwDH,
DIMCH, UMoED, from random init, a pretrained CLIP checkpoint or a cmh_tpu
``model-N.msgpack``) and serving are ported: text or image query → CLIP
ViT-B/32 tower → the method's hash head → ±1 codes → packed index → exact
top-k, on the card or, through ``RetrievalIndex.search_cpu``, on the host. Every Pallas
kernel on that path has a hand-written CUDA C++ kernel for Hopper under
``cmh_torch/csrc/`` (built at first use by ``ops/_build.py``) and a plain
PyTorch version beside it that runs on CPU tensors. Runs move to and from
``cmh_tpu``'s full-state checkpoints (``runners/jax_checkpoint.py``), and
train and validate over several cards, one process a card
(``parallel/dp.py``).

The package imports torch and never jax, flax, msgpack or cmh_tpu. Entry points take a
``device`` that defaults to ``"cuda"``; without a card they raise unless the
caller asks for ``"cpu"`` (see ``resolve_device``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises rather than falling back
    to the CPU when a CUDA device was asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
