"""Mean host time of ``RetrievalIndex.search`` (K4 and the key merge over
every gallery block, ending in the copy to the host) in the traced window,
ms."""
from cmhbench.layer import span_mean_ms


def read(outcome):
    return span_mean_ms(outcome, "index_search")
