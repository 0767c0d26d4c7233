"""Mean of the runner's own ``history`` ``map_s`` (the synchronised
4-direction mAP) over the timed window's valids, ms."""
import statistics


def read(outcome):
    m = outcome.host.get("map_s")
    return 1e3 * statistics.fmean(m) if m else None
