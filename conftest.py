"""Time limits and the `slow` list for the tests under tests/.

Every test there has a time limit: 300 s for setup and call together (a
module fixture's build counts to the first test of the module that a process
runs), and 300 s more for its teardown. A kept test that needs more says so
with `@pytest.mark.time_limit(seconds)`. Past the limit, SIGALRM fails the
test with its name and a traceback, and the run goes on.

The frozen JAX package's whole-engine runs are marked `slow` here, by node
id, and left out of `-m 'not slow'`; `python -m pytest tests/ -m slow` runs
them, in one process.
"""
import contextlib
import faulthandler
import os
import signal
import sys
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).parent / "tests"

DEFAULT_TIME_LIMIT_S = 300
# Past its limit, a test stuck in native code (an XLA compile, a gloo wait)
# never returns to Python to take the alarm: faulthandler then prints every
# thread and ends the process. Under xdist that is the worker, which xdist
# records as failed on that test and replaces.
NATIVE_GRACE_S = 60

# Each file imports gs_icp_slam_tpu and not gs_icp_slam_torch, and each test
# took over 120 s or peaked over 8 GB RSS when run alone in one process
# (`python -m pytest <nodeid>`, cold JAX compile cache, stopped at 300 s;
# 8-core CPU host). Tests sharing a module fixture were measured together.
SLOW = (
    # one module fixture: not ended at 300 s, 6.78 GB by then
    "tests/test_fused.py::test_fused_tracking_accuracy",
    "tests/test_fused.py::test_fused_mapping_quality",
    "tests/test_fused.py::test_fused_keyframe_sparsity",
    "tests/test_fused.py::test_fused_poses_start_at_gt",
    # one module fixture: not ended at 300 s, 6.56 GB
    "tests/test_slam_engine.py::test_tracking_accuracy",
    "tests/test_slam_engine.py::test_mapping_quality",
    "tests/test_slam_engine.py::test_keyframe_sparsity",
    "tests/test_slam_engine.py::test_poses_shape_and_start",
    "tests/test_stress.py::test_depth_noise_tracking_survives",  # >300 s, 8.84 GB
    "tests/test_stress.py::test_rotation_heavy_trajectory",  # >300 s, 8.83 GB
    "tests/test_stress.py::test_sparse_smooth_tracking_stays_metric",  # 154.4 s, 1.83 GB
    "tests/test_stress.py::test_keyframe_store_overflow_evicts_not_drops",  # >300 s, 8.84 GB
    "tests/test_buckets.py::test_bucketed_run_matches_quality",  # >300 s, 6.78 GB
    "tests/test_buckets.py::test_bucket_slicing_preserves_out_of_bucket_slots",  # 186.8 s, 10.09 GB
    # one module fixture, a CLI run: not ended at 300 s, 4.89 GB
    "tests/test_cli_eval.py::test_cli_run_outputs",
    "tests/test_cli_eval.py::test_cli_offline_render_and_eval",
    "tests/test_cli_eval.py::test_fused_checkpoint_roundtrip",
    "tests/test_io.py::test_engine_periodic_checkpoint_resume",  # 214.4 s, 5.47 GB
    "tests/test_training_stage.py::test_stage_loss_downsamples",  # 159.7 s, 19.09 GB
    # past 1,400 s alone and 39.8 GB; OOM-killed under -n 6
    "tests/test_training_stage.py::test_stage1_engine_quality",
    "tests/test_quick.py::test_sharded_step_mesh2",
    "tests/test_parallel.py::test_sharded_engine_end_to_end",
)

_deadline = pytest.StashKey[float]()
_stderr_fd = pytest.StashKey[int]()


def _limited(item):
    return item.path.is_relative_to(TESTS)


def pytest_configure(config):
    # A copy of the real stderr, taken while capture is off: during a test
    # fd 2 goes to a capture file, which a process ended by faulthandler
    # never shows.
    config.stash[_stderr_fd] = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if _limited(item) and item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _time_limit(item):
    marker = item.get_closest_marker("time_limit")
    return marker.args[0] if marker else DEFAULT_TIME_LIMIT_S


@contextlib.contextmanager
def _alarm(item, deadline):
    """Fail `item` from SIGALRM if this phase runs past `deadline`."""
    if not _limited(item):
        yield
        return

    def expired(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of "
                    f"{_time_limit(item)} s")

    previous = signal.signal(signal.SIGALRM, expired)
    seconds = max(deadline - time.monotonic(), 0.01)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + NATIVE_GRACE_S, exit=True,
                                      file=item.config.stash[_stderr_fd])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    item.stash[_deadline] = time.monotonic() + _time_limit(item)
    with _alarm(item, item.stash[_deadline]):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _alarm(item, item.stash[_deadline]):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _alarm(item, time.monotonic() + _time_limit(item)):
        return (yield)
