"""The HTTP front end's share of a request in the traced window: the mean
client latency less the mean host time inside ``RetrievalApp.handle_post``,
ms."""
import statistics

from cmhbench.layer import span_mean_ms


def read(outcome):
    lat, inside = outcome.host.get("trace_latency_ms"), span_mean_ms(outcome, "handle_post")
    return statistics.fmean(lat) - inside if lat and inside is not None else None
