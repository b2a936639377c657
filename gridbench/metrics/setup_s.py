"""setup_s: process start to the window's first mark (set-up, kernel
loading and the warm-up of the cell's own traffic), host clock."""


def read(rec, form):
    return rec.get("setup_s")
