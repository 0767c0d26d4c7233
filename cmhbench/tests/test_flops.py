"""Operation and byte counts against hand counts and against the bound
times PERF.md's table of kernels lists for its shapes."""

import json

import pytest

from cmhbench import flops, spec


def config(name):
    with open(spec.PKG / "configs" / f"{name}.json") as f:
        return json.load(f)


def clip(name):
    return config(name)["clip"]


def heads(name):
    return spec.method(config(name)).head_flops(config(name))


def hand_forward(w, layers, s, patch, tw, tlayers, t, embed, out_dim):
    """Forward FLOPs of one pair by hand: per block 2 s (3w w + w w + 4w w +
    4w w) and 2 s^2 w twice (causal: s(s+1)/2 pairs) in the text tower."""
    g = 224 // patch
    vision = (2 * g * g * 3 * patch * patch * w + layers * (2 * s * 12 * w * w + 4 * s * s * w)
              + 2 * s * w * embed)
    text = tlayers * (2 * t * 12 * tw * tw + 4 * (t * (t + 1) // 2) * tw) + 2 * t * tw * embed
    heads = 2 * (4 * embed * embed + 4 * embed * out_dim)
    return vision + text + heads


@pytest.mark.parametrize("name,w,layers,s,patch,tw,embed,gflop", [
    ("dcmht-vitb32-64bit", 768, 12, 50, 32, 512, 512, 11.30),
    ("dcmht-vitl14-64bit", 1024, 24, 257, 14, 768, 768, 167.93),
])
def test_pair_forward_against_hand_counts(name, w, layers, s, patch, tw, embed, gflop):
    got = flops.pair_forward(clip(name), 32, heads(name))
    assert got == pytest.approx(hand_forward(w, layers, s, patch, tw, 12, 32, embed, 64))
    assert got / 1e9 == pytest.approx(gflop, abs=0.01)


def test_training_counts_every_product_three_times_but_the_patch_embedding():
    c, h = clip("dcmht-vitb32-64bit"), heads("dcmht-vitb32-64bit")
    patch = 2 * 49 * 3 * 32 * 32 * 768
    assert flops.pair_train(c, 32, h) == pytest.approx(3 * flops.pair_forward(c, 32, h) - patch)


def ms(fn, *args):
    return 1e3 * flops.bound_s(*fn(*args))


@pytest.mark.parametrize("fn,args,bound_ms", [
    (flops.k1_fwd, (12800, 768, 2), 0.01174),
    (flops.k1_fwd, (8192, 512, 2), 0.00501),
    (flops.k1_fwd, (5000, 768, 2), 0.00459),
    (flops.k1_fwd, (3200, 512, 2), 0.00196),
    (flops.k1_bwd, (5000, 768, 2), 0.00688),
    (flops.k1_bwd, (3200, 512, 2), 0.00294),
    (flops.k2_fwd, (256, 12, 50, 64, 2, False, False), 0.02348),
    (flops.k2_fwd, (256, 8, 32, 64, 2, True, True), 0.01003),
    (flops.k2_fwd, (100, 16, 257, 64, 2, False, False), 0.06285),
    (flops.k2_bwd, (100, 12, 50, 64, 2, False, False), 0.01605),
    (flops.k2_bwd, (100, 16, 257, 64, 2, False, False), 0.10998),
    (flops.k4, (64, 1049353, 1, 1), 0.02130),
    (flops.k4, (64, 1049353, 2, 1), 0.02255),
    (flops.k4, (4, 1 << 20, 1, 1), 0.00250),
])
def test_bounds_of_the_kernel_table(fn, args, bound_ms):
    assert ms(fn, *args) == pytest.approx(bound_ms, abs=6e-6)


def test_k4_integer_work_at_the_issue_rate():
    """The kernel table took K4's xor, popcount and add at the fp32 rate
    (0.03005 ms, bytes, at 1,024 bits); at the integer issue rate the
    operations bound it."""
    nbytes, ops, kind = flops.k4(64, 1 << 18, 32, 4)
    assert kind == "int32" and nbytes / flops.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.03005, abs=6e-6)
    assert ms(flops.k4, 64, 1 << 18, 32, 4) == pytest.approx(0.04814, abs=6e-6)


def test_k3_counts_each_segment_histogram_written():
    """The kernel table counted K3-hist's (Q, S, V) histograms once (2 q v 4
    bytes); they are written once a segment: 27 segments at N = 110,000."""
    assert ms(flops.k3_hist, 1024, 110000, 1, 17, 27) == pytest.approx(0.03475, abs=6e-6)
    table = (1024 * 110000 + 2 * 1024 * 17 * 4) / flops.HBM_BYTES_PER_S * 1e3
    assert table == pytest.approx(0.03367, abs=6e-6)


def test_causal_and_padded_attention_counts_only_the_pairs_needed():
    assert flops.attention_pairs(2, 4, False) == 32
    assert flops.attention_pairs(2, 4, True) == 20
    assert flops.attention_pairs(2, 4, True, [4, 2]) == 10 + 3
    _, ops, kind = flops.k2_fwd(2, 8, 32, 64, 2, True, True, [32, 10])
    assert kind == "bf16" and ops == 4 * 8 * 64 * (32 * 33 // 2 + 10 * 11 // 2)
