"""device_idle_share: the share of the traced window in which nothing ran
on the device, 1 - busy / window, mean over the ranks, in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
