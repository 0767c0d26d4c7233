"""ModifiedResNet vision tower (the alternative CLIP image encoder).

Counterpart of ``cmh_tpu/models/clip/resnet.py``: a 3-conv anti-aliased
stem (avgpool instead of maxpool), Bottleneck blocks whose strided
convolutions are preceded by avgpool, and a QKV attention pool over the
mean token instead of global average pooling. No hashing method uses this
tower (every config is a ViT), but OpenAI's RN checkpoints load into it
(``loader.resnet_config_from_state_dict``, ``loader.load_resnet``).

The public input is NHWC float32, as cmh_tpu's; the convolutions run in
the compute dtype (``F.conv2d``: cmh_tpu leaves them to XLA, outside any
Pallas kernel) and every BatchNorm in fp32 with flax's semantics. The
modules keep the reference torch names (``conv1``, ``bn1``,
``layer{n}.{i}.conv{1,2,3}``, ``downsample.0``/``downsample.1``,
``attnpool.{q,k,v,c}_proj``), so a torch RN state dict loads with
``load_state_dict``; its ``num_batches_tracked`` buffers are accepted and
dropped. The attention pool computes only the mean token's query row, which
equals the reference's full self-attention followed by taking row 0; it
needs no attention kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import tp
from .model import _dense, _dense_out


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    NCHW channels, in fp32 whatever the input dtype.

    Training: normalise by the batch mean and the biased batch variance
    (E[x²] − E[x]², clipped at 0, as flax's fast variance) and move the
    running statistics as new = 0.9·old + 0.1·batch, the variance biased
    too (torch's ``BatchNorm2d`` would take the unbiased one there). Eval:
    the running statistics. y = (x − mean)·(rsqrt(var + eps)·weight) + bias."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)   # torch's counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean((0, 2, 3))
            var = torch.clamp(x.square().mean((0, 2, 3)) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on x in ``dtype`` (fp32 parameters cast per call)."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    return F.avg_pool2d(x, stride) if stride > 1 else x


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", nn.Conv2d(inplanes, out, 1, bias=False))
            self.downsample.add_module("1", BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(_conv(self.conv1, x, dt)))
        y = F.relu(self.bn2(_conv(self.conv2, y, dt)))
        y = self.bn3(_conv(self.conv3, _avg_pool(y, self.stride), dt))
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample[0], self.downsample[1]
            identity = bn(_conv(conv, _avg_pool(x, self.stride), dt))
        return F.relu(y + identity)


class AttentionPool2d(nn.Module):
    """The mean token's attention over the (HW + 1) tokens, projected by
    ``c_proj``: the dense layers in the compute dtype, q scaled in it before
    an fp32-accumulated dot, the fp32 softmax rounded to the compute dtype
    before the weighted sum (cmh_tpu ``resnet.py:68-97``). With ``shards``
    (``parallel/tp.py``) ``c_proj`` holds this rank's input features."""

    shards = None

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim**2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)

    def shard_(self, shards: tp.Shards) -> None:
        """Run ``c_proj`` as a row split (``tp.shard_model_`` keeps this
        rank's input features): the pooled features, computed whole on every
        rank, give it their columns."""
        self.shards = shards

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        dt, nh = self.dtype, self.num_heads
        tokens = x.flatten(2).transpose(1, 2)                  # (B, HW, C), row-major
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], 1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)[None]
        hd = c // nh

        def heads(t):
            return t.reshape(b, -1, nh, hd).transpose(1, 2)

        q = heads(_dense(tokens[:, :1], self.q_proj.weight, self.q_proj.bias, dt))
        k = heads(_dense(tokens, self.k_proj.weight, self.k_proj.bias, dt))
        v = heads(_dense(tokens, self.v_proj.weight, self.v_proj.bias, dt))
        logits = torch.matmul((q * hd**-0.5).float(), k.float().transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1).to(dt)
        pooled = torch.matmul(weights.float(), v.float()).to(dt)   # (B, nh, 1, hd)
        pooled = pooled.transpose(1, 2).reshape(b, c)
        sh = self.shards
        if sh is None:
            return _dense(pooled, self.c_proj.weight, self.c_proj.bias, dt)
        # every rank's gradient of its columns summed: the whole gradient
        pooled = tp.copy_to_shards(pooled, sh).chunk(sh.size, 1)[sh.rank]
        return _dense_out(pooled, self.c_proj.weight, self.c_proj.bias, dt, sh)


class ModifiedResNet(nn.Module):
    """``image`` (B, H, W, 3) NHWC float32 → (B, output_dim) in the compute
    dtype. Geometry as cmh_tpu's: ``layers`` Bottlenecks a stage at widths
    width·(1, 2, 4, 8), an attention pool of width·32 channels."""

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
                 output_dim: int = 1024, heads: int = 32, input_resolution: int = 224,
                 width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.output_dim, self.heads = tuple(layers), output_dim, heads
        self.input_resolution, self.width, self.dtype = input_resolution, width, dtype
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm2d(width)
        inplanes = width
        for stage, (blocks, stride) in enumerate(zip(self.layers, (1, 2, 2, 2))):
            planes = width * 2**stage
            seq = nn.Sequential()
            for i in range(blocks):
                seq.add_module(str(i), Bottleneck(inplanes, planes, stride if i == 0 else 1,
                                                  dtype))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", seq)
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads,
                                        output_dim, dtype)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = image.permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(_conv(conv, x, dt)))
        x = _avg_pool(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ModifiedResNet":
        """Seeded random init with flax's default distributions, as cmh_tpu's
        ``ModifiedResNet.init`` draws them: lecun-normal convolution and dense
        kernels, zero dense biases, normal(C^-½) positional embedding, unit
        BatchNorm scales, zero shifts and running means, unit running
        variances."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 * fan_in**-0.5)
            elif isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 * mod.in_features**-0.5)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        pos = self.attnpool.positional_embedding
        pos.copy_(torch.randn(pos.shape, generator=generator) * pos.shape[1]**-0.5)
        return self
