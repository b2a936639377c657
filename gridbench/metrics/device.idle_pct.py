"""device.idle_pct.<form>: 100 x (1 - busy_s / window_s) of the traced
window, busy_s being the union of the device's operations on each card,
averaged over the cards. The form names the cell's unit of work
(`query`: queries)."""

FORMS = {"query": "queries"}


def read(rec, form):
    if rec.get("unit") != FORMS.get(form) or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
