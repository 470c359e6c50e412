"""step_ms: the window's wall time over the steps it completed (snapshot
reads and replay restarts inside; steps redone by a P3M rewind counted once)."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["steps"]
