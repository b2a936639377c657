"""queries_per_s: queries completed in the window over its length."""


def read(rec, form):
    if "queries" not in rec:
        return None
    return rec["queries"] / rec["seconds"]
