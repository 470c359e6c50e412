"""program_idle_ms_per_step: the time the device is idle while the innermost
open span on the window's thread is an ``nbody.*`` span (the program's host
work the device waits on), per step, mean over the ranks
(``harness/spans.py``)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or not any(k.startswith("nbody.") for k in sp["spans"]):
        return None
    return sp["program_idle_s"] * 1e3 / rec["steps"]
