"""Model FLOPs of the timed window's steps (forward and backward of both
towers and heads at the cell's batch, ``flops.pair_train``) over the
window's seconds, as a share of the card's bf16 peak, %."""
from cmhbench import flops


def read(outcome):
    h = outcome.host
    if not h.get("steps"):
        return None
    return 100.0 * h["flops_per_step"] * h["steps"] / h["window_s"] / flops.PEAK["bf16"]
