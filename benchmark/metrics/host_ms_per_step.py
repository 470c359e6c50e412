"""host_ms_per_step: the host clock inside the window's update_many calls
(no synchronise inside), summed and divided by the steps: what the host
spends to queue a step."""


def read(rec):
    return rec["host_s"] * 1e3 / rec["steps"]
