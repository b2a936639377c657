"""query_p95_ms: the 95th percentile of every query completed in the
window, from its first call into the client to its count's return."""

from gridbench.harness.loop import p95


def read(rec, form):
    if "queries" not in rec or not rec["latencies_s"]:
        return None
    return 1e3 * p95(rec["latencies_s"])
