"""launches_per_step: the device ops (kernels, copies, sets) launched inside
any ``nbody.*`` span, per step, mean over the ranks (``harness/spans.py``)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or not sp["program_launches"]:
        return None
    return sp["program_launches"] / rec["steps"]
