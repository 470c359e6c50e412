"""comm_ms_per_step: device time of the kernels whose names start with
"nccl" in the traced window, mean over the ranks, per step."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["nccl_s"] <= 0:
        return None
    return tr["nccl_s"] * 1e3 / rec["steps"]
