"""setup_s: process start to the first timed launch: imports, the kernels'
library (loaded, or built), the inputs, the system and the warm-up."""


def read(rec):
    return rec["setup_s"]
