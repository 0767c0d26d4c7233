"""Mean host time of ``LoadedEncoders.encode_text`` (tokens to codes, ending
in the copy to the host) in the traced window, ms."""
from cmhbench.layer import span_mean_ms


def read(outcome):
    return span_mean_ms(outcome, "encode_text")
