"""95th percentile of how late the load generator sent the timed window's
requests against their due times, ms."""
from cmhbench.kinds.search import percentile


def read(outcome):
    late = outcome.host.get("late_ms")
    return percentile(late, 95) if late else None
