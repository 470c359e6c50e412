"""Plants the fault named by $BENCHMARK_TEST_FAULT in every process of a
test's run (the ranks of a four-card cell are processes of their own)."""

import os
import sys

sys.path.insert(0, os.environ["BENCHMARK_TEST_ROOT"])

from benchmark.tests import faults  # noqa: E402

faults.apply_from_env()
