"""step_roofline: the least time the configuration's algorithm needs for
the window's steps on the cards (rooflines/<config>.py, at the published
peaks), over the device's busy time in the traced window (the union of its
kernel and copy intervals, mean over the ranks), in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or not rec.get("bound_s_per_step"):
        return None
    return 100.0 * rec["bound_s_per_step"] * rec["steps"] / tr["busy_s"]
