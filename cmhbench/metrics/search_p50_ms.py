"""Median client latency of the timed window's requests, from when each
was due, ms (a failed request counts as the generator's timeout)."""
from cmhbench.kinds.search import percentile


def read(outcome):
    lat = outcome.host.get("latency_ms")
    return percentile(lat, 50) if lat else None
