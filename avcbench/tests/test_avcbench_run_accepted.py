"""The whole-run checks of ``test_avcbench_run`` and the traced reads of
``test_avcbench_stage_metrics``, on the benchmark's first two cells, in a
scratch checkout whose metric lists name only those two.  The checkout
those files build maps every cell a metric lists through their fixed
renaming of the first two cells, so it cannot be built once
BENCHMARK.json lists more; here the other cells are left out of the
lists first, and the same tests run against that checkout.  The entries
of ``pack_ms_per_frame`` and ``wait_ms_per_frame`` are checked by name."""
import json

import pytest

import test_avcbench_run as base
from test_avcbench_run import (  # noqa: F401  (collected here)
    test_cell_from_files_runs_correct, test_failed_requests_turn_correct_false,
    test_fault_turns_correct_false, test_mix_sizes_torch_threads,
    test_one_client_only)
from test_avcbench_stage_metrics import (  # noqa: F401  (collected here)
    NEW, SPEC, test_traced_cell_reads_them)

FIRST_PER_LAYER = [
    "parse_ms_per_frame", "entropy_ms_per_frame", "motion_ms_per_frame",
    "untimed_ms_per_frame", "dispatch_ms_per_frame", "graph_pool_mib",
    "device_idle_pct", "b2_roofline", "b3_roofline", "pack_ms_per_frame",
    "wait_ms_per_frame"]


def first(cells):
    """The cells of `cells` that the renaming knows, in their order."""
    return [w for w in cells if w in base.RENAME]


def first_cells_only(spec):
    """`spec` with every metric's list cut to ``first``."""
    spec = json.loads(json.dumps(spec))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = first(m["workloads"])
    return spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``test_avcbench_run``'s checkout, built from the cut spec."""
    spec = base.SPEC
    base.SPEC = first_cells_only(spec)
    try:
        return base.root.__wrapped__(tmp_path_factory)
    finally:
        base.SPEC = spec


def test_entries_by_name():
    per = {m["name"]: m for m in SPEC["per_layer"]}
    assert first(per["pack_ms_per_frame"]["workloads"]) == ["ipb.gop10"]
    assert first(per["wait_ms_per_frame"]["workloads"]) == [
        "ipb.gop10", "intra.stream128"]
    for name in NEW:
        m = per[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms/frame", "lower", "program_span", "frames_per_s")
    # later entries come after the first ones, which keep their order
    names = [m["name"] for m in SPEC["per_layer"]]
    assert names[:len(FIRST_PER_LAYER)] == FIRST_PER_LAYER
