"""Kernels that ran on the card in the traced window over its train steps."""


def read(outcome):
    t, steps = outcome.trace, outcome.host.get("traced_steps")
    return t.kernels() / steps if t is not None and steps else None
