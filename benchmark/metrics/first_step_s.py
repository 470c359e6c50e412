"""first_step_s: the harness's span around the first update_many(1) and its
synchronise (the library loads, or builds, at the first launch)."""


def read(rec):
    return rec["first_step_s"]
