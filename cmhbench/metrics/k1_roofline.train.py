"""K1 (LayerNorm) forward and backward launches of the traced training
window: their bound time from the shapes over the device time of every
kernel launched inside their spans, %."""
from cmhbench import flops
from cmhbench.layer import roofline_pct


def read(outcome):
    return roofline_pct(outcome, (("k1_fwd", flops.k1_fwd), ("k1_bwd", flops.k1_bwd)))
