"""Host-side image transforms (counterpart of ``cmh_tpu/data/transforms.py``,
PIL path).

train: RandomHorizontalFlip(0.5) → RandomResizedCrop(R) → ToTensor →
Normalize; eval: Resize((R, R), bicubic) → ToTensor → Normalize, with the
CLIP constants, emitting HWC float32 (the layout ``encode_image`` takes).
The random draws consume a ``np.random.RandomState`` in cmh_tpu's order.
PIL is imported only when an image is transformed.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def normalize(img) -> np.ndarray:
    """HWC uint8 [0,255] or float [0,1] → normalized float32 HWC (integer
    input is divided by 255, as torchvision's ToTensor does)."""
    img = np.asarray(img)
    x = img.astype(np.float32)
    if np.issubdtype(img.dtype, np.integer):
        x = x / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def sample_crop_box(height, width, rng, scale=(0.08, 1.0),
                    ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision RandomResizedCrop.get_params: (y, x, h, w)."""
    area = height * width
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h + 1)
            j = rng.randint(0, width - w + 1)
            return i, j, h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def train_transform(img, size: int, rng: np.random.RandomState) -> np.ndarray:
    """PIL image → flip with probability ½ → random resized crop → normalize."""
    from PIL import Image

    if rng.rand() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    width, height = img.size
    i, j, h, w = sample_crop_box(height, width, rng)
    img = img.resize((size, size), Image.BILINEAR, box=(j, i, j + w, i + h))
    return normalize(np.asarray(img))


def eval_transform(img, size: int) -> np.ndarray:
    """PIL image → Resize((size, size), bicubic) → normalize."""
    from PIL import Image

    return normalize(np.asarray(img.resize((size, size), Image.BICUBIC)))
