"""The port's ASR and clustering gates end to end on the CPU: the
counterparts of the reference's ``asr-steady`` / ``kill-asr-worker``
(`tests/test_asr_serve.py`) and ``cluster-steady`` /
``kill-cluster-worker`` (`tests/test_cluster_serve.py`) runs, through
`run_scenario` with ``device="cpu"``.

The ASR gate's tiny Whisper (`WHISPER_TEST`) draws its weights from a
``torch.Generator`` seeded with the scenario's ``asr.seed`` (the reference
draws from JAX's PRNG), and its transcripts re-enter a ``tiny`` text
engine.  Each verdict has the reference runner's keys and check names for
the scenario and passes; every wait inside a run is bounded by the
scenario's ``drain_timeout_s``.
"""

import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("grpc")

from distributed_crawler_tpu_torch import loadgen as tlg  # noqa: E402

ASR_KEYS = {
    "bus", "chaos_events", "checks", "dtraces", "duplicates", "duration_s",
    "expected_media", "fault_breaches", "fault_window_s",
    "goodput_media_per_s", "kind", "lockwitness", "lost", "occupancy",
    "processed_media", "published", "reentered_posts", "scenario",
    "status", "tail_asr_batch_p95_ms", "tail_batch_age_p95_ms",
    "tail_breaches", "tail_queue_wait_p95_ms", "transcript_errors",
    "worker_generations"}
CLUSTER_KEYS = {
    "assigned_records", "bus", "chaos_events", "checks",
    "cluster_duplicates", "cluster_lost", "cluster_updates", "clusters",
    "dtraces", "duplicates", "duration_s", "embedded_records",
    "expected_records", "fault_breaches", "fault_window_s",
    "goodput_vectors_per_s", "kind", "lockwitness", "lost", "published",
    "scenario", "status", "tail_batch_age_p95_ms", "tail_batch_p95_ms",
    "tail_breaches", "tail_queue_wait_p95_ms", "worker_generations"}

# The check names the reference's runners give each scenario.
CHECKS = {
    "asr-steady": {
        "bubble_share", "clock_skew_ms", "device_busy_fraction", "drained",
        "dtrace_processes", "duplicates", "endpoint_costs",
        "endpoint_dtraces", "endpoint_metrics", "flight_asr_batch",
        "flight_loadgen_audio_batch", "goodput_media_per_s", "lost",
        "reentered", "tail_asr_batch_p95_ms", "tail_queue_wait_p95_ms",
        "transcript_errors", "whisper_costs"},
    "kill-asr-worker": {
        "breach_batch_age", "drained", "duplicates", "endpoint_costs",
        "endpoint_dtraces", "endpoint_metrics", "flight_chaos",
        "flight_loadgen_audio_batch", "flight_worker_kill",
        "goodput_media_per_s", "lost", "reentered", "transcript_errors",
        "whisper_costs"},
    "cluster-steady": {
        "cluster_costs", "cluster_duplicates", "cluster_lost",
        "clusters_nonempty", "drained", "dtrace_processes", "duplicates",
        "endpoint_clusters", "endpoint_costs", "endpoint_dtraces",
        "endpoint_metrics", "endpoint_timeseries",
        "flight_cluster_checkpoint", "flight_loadgen_batch",
        "goodput_vectors_per_s", "inertia_growth", "lost",
        "tail_queue_wait_p95_ms", "timeseries_series"},
    "kill-cluster-worker": {
        "cluster_costs", "cluster_duplicates", "cluster_lost",
        "cluster_resumed", "clusters_nonempty", "drained", "duplicates",
        "endpoint_clusters", "endpoint_costs", "endpoint_dtraces",
        "endpoint_metrics", "endpoint_timeseries", "flight_chaos",
        "flight_cluster_checkpoint", "flight_cluster_resume",
        "flight_worker_kill", "goodput_vectors_per_s", "lost"},
}


@pytest.mark.parametrize("name,generations", [("asr-steady", 1),
                                              ("kill-asr-worker", 2)])
def test_asr_scenario_passes(name, generations):
    """Every expected media id transcribed exactly once (across the
    worker kill) and every transcript embedded as ``media:<id>``."""
    verdict = tlg.run_scenario(tlg.load_scenario(name), device="cpu")
    assert verdict["status"] == "pass", json.dumps(verdict["checks"])
    assert set(verdict) - {"lost_sample"} == ASR_KEYS
    assert set(verdict["checks"]) == CHECKS[name]
    assert verdict["lost"] == 0 and verdict["duplicates"] == 0
    assert verdict["worker_generations"] == generations
    assert verdict["checks"]["reentered"]["value"] == 0
    assert verdict["reentered_posts"] >= verdict["processed_media"] > 0


@pytest.mark.parametrize("name,generations", [("cluster-steady", 1),
                                              ("kill-cluster-worker", 2)])
def test_cluster_scenario_passes(name, generations):
    """Every embedded post assigned exactly once, across the cluster
    worker's kill, which resumes from its checkpoint."""
    verdict = tlg.run_scenario(tlg.load_scenario(name), device="cpu")
    assert verdict["status"] == "pass", json.dumps(verdict["checks"])
    assert set(verdict) - {"lost_sample", "cluster_lost_sample"} == \
        CLUSTER_KEYS
    assert set(verdict["checks"]) == CHECKS[name]
    assert verdict["lost"] == 0 and verdict["duplicates"] == 0
    assert verdict["cluster_lost"] == 0
    assert verdict["cluster_duplicates"] == 0
    assert verdict["assigned_records"] == verdict["embedded_records"] > 0
    assert verdict["worker_generations"] == generations
    if generations == 2:
        assert verdict["clusters"]["resumed"] is True
