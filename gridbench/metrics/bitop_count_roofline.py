"""bitop_count_roofline: the least bytes of the window's rollup queries
(`work/bitop_count.py`) at the card's peak bandwidth, over the device's
busy time; summed over cards on a pod."""

from gridbench.harness.rooflines import share


def read(rec, form):
    return share(rec, "bitop_count")
