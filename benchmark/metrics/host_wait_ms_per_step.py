"""host_wait_ms_per_step: host time inside the program's ``nbody.host_read``
spans (its counted blocking reads, ``utils.timing.host_read``), per step:
the part of ``host_ms_per_step`` that waits for the card
(``harness/spans.py``)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or "nbody.host_read" not in sp["spans"]:
        return None
    return sp["spans"]["nbody.host_read"]["host_s"] * 1e3 / rec["steps"]
