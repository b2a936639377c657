"""ops.launches_per_call.<form>: the device's kernels, copies and fills in
the traced window over the calls (queries) submitted in it, the work that
runs beside them (login batches) included; the window lasts until every
one of them has completed."""

FORMS = {"query": "queries"}


def read(rec, form):
    if rec.get("unit") != FORMS.get(form) or not rec.get("calls"):
        return None
    return rec["device_ops"] / rec["calls"]
