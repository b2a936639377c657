"""A roofline share from the work the harness counted, never from the
name of a kernel: least bytes over (peak bytes/s x busy seconds), both
summed over the cards the cell uses."""

from typing import Optional


def share(rec: dict, work: str) -> Optional[float]:
    least = rec.get("work_bytes", {}).get(work)
    peak = rec.get("peak_bytes_per_s")
    busy = rec.get("busy_s", 0.0) * rec.get("cards", 1)
    if not least or not peak or busy <= 0:
        return None
    return 100.0 * least / (peak * busy)
