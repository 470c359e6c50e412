"""force_ms_per_step: device time of the ops launched inside the program's
``nbody.force`` spans (the spans nested in them included), ``nccl*`` ops
left out, per step, mean over the ranks (``harness/spans.py``)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or "nbody.force" not in sp["spans"]:
        return None
    return sp["spans"]["nbody.force"]["compute_s"] * 1e3 / rec["steps"]
