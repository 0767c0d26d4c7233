"""Milliseconds a traced train step with nothing on the card inside the
program's ``cmh.forward`` span."""
from cmhbench.program_spans import idle_s, per


def read(outcome):
    return per(outcome, "train_step", lambda t: 1e3 * idle_s(t, "forward"))
