"""Forward FLOPs of both towers and heads over every item of the timed
window's valids over the window's seconds, as a share of the card's bf16
peak, %."""
from cmhbench import flops


def read(outcome):
    h = outcome.host
    if not h.get("valids"):
        return None
    return 100.0 * h["flops_per_valid"] * h["valids"] / h["window_s"] / flops.PEAK["bf16"]
