"""executor.stage_ms_per_run.<form>: the dispatcher thread's host staging
and launch time per run over the traced window (ExecutorMetrics'
`executor.stage_s.<kind>` histograms, every kind, read at the window's
marks)."""

FORMS = {"query": "queries"}


def read(rec, form):
    if rec.get("unit") != FORMS.get(form) or not rec.get("runs"):
        return None
    return 1e3 * rec["stage_s"] / rec["runs"]
