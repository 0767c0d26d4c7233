"""DCMHT (``cmh_torch/models/dcmht.py``): two heads, each a one-token
attention's value and output projections, a norm (BatchNorm for images,
LayerNorm for text) and ``fc2`` to two logits a bit."""

from __future__ import annotations

ARCH = "DCMHT"
RUNNER = "DCMHTTrainer"


def head_leaves(cfg: dict):
    """DCMHT's two heads, with the image BatchNorm's running statistics;
    (name, shape, how) as ``weights.py`` reads them."""
    embed, output_dim = cfg["clip"]["embed_dim"], cfg["output_dim"]
    out = []
    for m in ("img_hash", "txt_hash"):
        p = f"hash.{m}."
        out += [
            (p + "atten.in_proj_weight", (3 * embed, embed), ("normal", 0.0, embed ** -0.5)),
            (p + "atten.in_proj_bias", (3 * embed,), ("normal", 0.0, 0.02)),
            (p + "atten.out_proj.weight", (embed, embed), ("normal", 0.0, embed ** -0.5)),
            (p + "atten.out_proj.bias", (embed,), ("normal", 0.0, 0.02)),
            (p + "norm.weight", (embed,), ("normal", 1.0, 0.02)),
            (p + "norm.bias", (embed,), ("normal", 0.0, 0.02)),
        ]
        if m == "img_hash":
            out += [(p + "norm.running_mean", (embed,), ("normal", 0.0, 0.1)),
                    (p + "norm.running_var", (embed,), ("lognormal", 0.2))]
        out += [(p + "fc2.weight", (2 * output_dim, embed), ("normal", 0.0, embed ** -0.5)),
                (p + "fc2.bias", (2 * output_dim,), ("normal", 0.0, 0.02))]
    return out


def load_heads(model, heads: dict) -> None:
    """The head tensors (fp16, under ``hash.``) into the port's model."""
    model.hash.load_state_dict({k[len("hash."):]: v.float() for k, v in heads.items()})


def head_flops(cfg: dict) -> float:
    """Both heads' forward FLOPs for one pair: each head's value and output
    products (the attention over one token) and fc2."""
    embed, output_dim = cfg["clip"]["embed_dim"], cfg["output_dim"]
    return 2 * (2.0 * 2 * embed * embed + 2.0 * embed * 2 * output_dim)
