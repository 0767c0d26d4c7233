"""The program's ``cmh.wait.*`` spans (host waits on the card) over the
traced train steps."""
from cmhbench.program_spans import count, per


def read(outcome):
    return per(outcome, "train_step", lambda t: count(t, "wait.*"))
