"""A request's least time on the card, its text tower's FLOPs at the bf16
peak plus one read of the packed gallery at the memory bandwidth, over
the timed window's mean client latency, %."""
import statistics


def read(outcome):
    lat = outcome.host.get("latency_ms")
    if not lat:
        return None
    return 100.0 * outcome.host["bound_s_per_request"] * 1e3 / statistics.fmean(lat)
