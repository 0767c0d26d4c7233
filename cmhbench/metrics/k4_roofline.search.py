"""K4 (packed Hamming) launches of the traced search window: their bound
time from the shapes over the device time of every kernel launched inside
their spans, %."""
from cmhbench import flops
from cmhbench.layer import roofline_pct


def read(outcome):
    return roofline_pct(outcome, (("k4", flops.k4),))
