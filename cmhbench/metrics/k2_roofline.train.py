"""K2 (attention) forward and backward launches of the traced training
window, one-block and row-tiled alike: their bound time from the shapes,
the text tower's counting only the pairs its causal and padding masks
leave, over the device time of every kernel launched inside their spans, %."""
from cmhbench import flops
from cmhbench.layer import roofline_pct


def read(outcome):
    return roofline_pct(outcome, (("k2_fwd", flops.k2_fwd), ("k2_bwd", flops.k2_bwd)))
