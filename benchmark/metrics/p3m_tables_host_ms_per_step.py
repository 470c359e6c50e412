"""p3m_tables_host_ms_per_step: host time inside the program's
``nbody.p3m.tables`` spans (binning, sorts and work items queued on the
card), per step (``harness/spans.py``)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or "nbody.p3m.tables" not in sp["spans"]:
        return None
    return sp["spans"]["nbody.p3m.tables"]["host_s"] * 1e3 / rec["steps"]
