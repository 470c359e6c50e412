"""snapshot_read_ms: the harness's span around positions after the
segment's synchronise (the copy to the host; on a mesh its gathers), mean
over the window's segments."""


def read(rec):
    return sum(rec["read_s"]) * 1e3 / len(rec["read_s"])
