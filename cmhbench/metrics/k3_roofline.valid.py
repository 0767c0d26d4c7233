"""K3's two passes (histograms, then APs) of the traced valid: their bound
time from the shapes over the device time of every kernel launched inside
their spans, %."""
from cmhbench import flops
from cmhbench.layer import roofline_pct


def read(outcome):
    return roofline_pct(outcome, (("k3_hist", flops.k3_hist), ("k3_ap", flops.k3_ap)))
