"""comm_exposed_ms_per_step: the time in which ``nccl*`` ops launched inside
the program's ``nbody.ring.exchange``, ``nbody.allgather`` or
``nbody.reduce_scatter`` spans run and no other op runs on the rank, per
step, mean over the ranks (``harness/spans.py``)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or sp["comm_exposed_s"] is None:
        return None
    return sp["comm_exposed_s"] * 1e3 / rec["steps"]
