"""The suite's own scheduling helpers in the root ``conftest.py``: the file
order xdist queues, each worker's thread budget and its ``XLA_FLAGS``."""

import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("suite_conftest", ROOT / "conftest.py")
suite = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(suite)


def test_listed_files_go_longest_first_and_each_file_keeps_its_order():
    ids = ["tests/test_few.py::a", "tests/test_many.py::a", "tests/test_short.py::a",
           "tests/test_many.py::b", "tests/test_long.py::a", "tests/test_few.py::b",
           "tests/test_long.py::b", "tests/test_many.py::c", "tests/test_short.py::b"]
    longest = ("tests/test_long.py", "tests/test_short.py")
    order = suite.longest_files_first(ids, longest)
    assert sorted(order) == list(range(len(ids)))  # every item, once
    # listed files in their order, then the others most tests first
    assert [ids[i] for i in order] == [
        "tests/test_long.py::a", "tests/test_long.py::b",
        "tests/test_short.py::a", "tests/test_short.py::b",
        "tests/test_many.py::a", "tests/test_many.py::b", "tests/test_many.py::c",
        "tests/test_few.py::a", "tests/test_few.py::b"]
    assert suite.longest_files_first([], longest) == []


def test_every_file_of_the_cost_table_exists():
    missing = [name for name in suite.LONGEST_FILES if not (ROOT / name).is_file()]
    assert not missing, missing
    assert len(set(suite.LONGEST_FILES)) == len(suite.LONGEST_FILES)


def test_thread_budget_shares_the_cores_under_xdist_only():
    assert suite.thread_budget({}, 8) is None
    assert suite.thread_budget({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8) == 1
    assert suite.thread_budget({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8) == 4
    assert suite.thread_budget({"PYTEST_XDIST_WORKER_COUNT": "16"}, 8) == 1


def test_xla_flags_add_the_suites_and_keep_the_operators():
    assert suite.xla_flags("", None) == ""
    assert suite.xla_flags("", 4) == ""
    assert suite.xla_flags("", 1) == "--xla_cpu_multi_thread_eigen=false"
    assert (suite.xla_flags("--xla_force_host_platform_device_count=4", 1)
            == "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false")
    mine = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=true"
    assert suite.xla_flags(mine, 1) == mine
