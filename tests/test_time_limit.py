"""The repo's conftest.py gives every test a time limit: a test that runs past
it fails with its name and a traceback, and the run goes on."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent

INNER = '''
import time

import pytest


@pytest.mark.time_limit(2)
def test_sleeps_past_its_limit():
    time.sleep(30)


def test_after_it():
    pass
'''


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "2"]],
                         ids=["plain", "xdist"])
def test_time_limit_fails_the_test_and_the_run_goes_on(tmp_path, workers):
    shutil.copy(ROOT / "conftest.py", tmp_path)
    shutil.copy(ROOT / "pytest.ini", tmp_path)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_inner.py").write_text(INNER)
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         *workers, "tests/test_inner.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert ("tests/test_inner.py::test_sleeps_past_its_limit ran past its time "
            "limit of 2 s") in out, out
    assert "time.sleep(30)" in out, out    # the traceback reaches the test
