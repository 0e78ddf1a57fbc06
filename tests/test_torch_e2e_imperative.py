"""The port under ``executor: "imperative"`` against the JAX package's
imperative run: the end-to-end tests of ``test_torch_e2e.py`` on its clean
lane under ``poa``, with both packages in the JAX package's imperative
stage order (every file under ``nano_tcr/`` byte-identical but the files
of timings, those by schema and names; no ``graph`` section on either
side)."""

import pytest

pytest.importorskip("torch")

from test_torch_e2e import (  # noqa: E402,F401  (collected here on this file's lane)
    _one_torch_thread,
    lane_runs,
    test_artifacts_byte_identical_to_jax,
    test_counts_equal_the_truth,
    test_every_jax_artifact_is_written_byte_identical,
    test_graph_sections_equal_jax,
    test_history_has_one_entry_with_the_jax_fingerprint,
    test_obs_files_carry_the_jax_names_and_counts,
    test_obs_files_have_the_jax_schema,
    test_stage_timing_carries_the_jax_stage_names,
    test_the_port_writes_nothing_the_jax_run_does_not,
)


@pytest.fixture(scope="module", params=[("clean", "poa", "imperative")], ids="-".join)
def runs(request, tmp_path_factory):
    return lane_runs(request.param, tmp_path_factory)
