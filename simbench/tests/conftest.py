"""CPU tests of the benchmark harness.  Run from the repository's root:
``python -m pytest simbench/tests -q``; the card's test (marked ``cuda``)
skips itself where no card is present.  The port's encoder cache goes to
a temporary directory of the session, never to the home directory."""
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
_CACHE = tempfile.mkdtemp(prefix="simbench_tests_")
os.environ["NBLDPC_TORCH_CACHE_DIR"] = _CACHE


def pytest_sessionfinish(session, exitstatus):
    shutil.rmtree(_CACHE, ignore_errors=True)
