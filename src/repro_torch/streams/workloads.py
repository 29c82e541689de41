"""The paper's three evaluation workloads as DagSpecs (§5.1), plus two
synthetic topologies that stress the batched evaluation engine.

Ground-truth per-ktuple costs are chosen to land the same peak rates the
paper measured on its 4-CPU-VM cluster (WordCount: R_w ≈ 839 ktps,
R_c ≈ 658 ktps, SM ≈ 724 ktps traversals), so that Table 2 and the figures
reproduce quantitatively, not just in shape.  In the reference package each
paper node also carries its real operator body for the executor; this
package has no operators yet, so every node's ``fn`` is ``None`` here.

The two additional workloads exercise topology classes the paper's three do
not:

* :func:`diamond` — a fan-out/fan-in **join** topology (``clicks`` splits
  into two enrichment branches that re-converge on a keyed join).  The join
  ingests the *sum* of both branch rates (1.9× the source rate), so the
  allocator's rate propagation and the simulator's multi-in-edge queueing
  both get a workout, and cross-container traffic concentrates on the
  fan-in edge.
* :func:`deep_pipeline` — a **deep 8-stage** linear pipeline with heavily
  skewed per-stage costs (two hot stages at ~4–6× the cost of their
  neighbours) and rate-shrinking gammas.  Depth stresses backpressure
  propagation (slow-start admission must travel 8 hops) and skew makes the
  bottleneck move as parallelism changes — the regime where speculative
  batched evaluation pays off.

Both are simulator-first workloads (``fn=None``): the executor treats their
nodes as pass-through.
"""
from __future__ import annotations

from ..core.dag import DagSpec, EdgeSpec, Grouping, NodeSpec

# Peak rates implied: 1/cost. Keep in sync with benchmarks' expectations.
R_W = 839.0   # word producer peak ktps
R_C = 658.0   # counting consumer peak ktps
R_SM = 724.0  # stream-manager peak traversal ktps (used by SimParams default)


def wordcount() -> DagSpec:
    """Fig. 3a: word-producer -> (fields) -> counting-consumer."""
    producer = NodeSpec(
        "W",
        cpu_cost_per_ktuple=1.0 / R_W,
        gamma=1.0,
        mem_mb_base=96.0,
        mem_mb_per_ktps=0.05,
        tuple_bytes=24.0,
        is_source=True,
    )
    consumer = NodeSpec(
        "C",
        cpu_cost_per_ktuple=1.0 / R_C,
        gamma=1.0,  # emits updated (word, count) pairs downstream
        mem_mb_base=160.0,
        mem_mb_per_ktps=0.4,  # hashmap grows with keyspace share (§4)
        tuple_bytes=32.0,
    )
    return DagSpec(
        "wordcount",
        nodes=(producer, consumer),
        edges=(EdgeSpec("W", "C", Grouping.FIELDS),),
    )


def adanalytics() -> DagSpec:
    """Fig. 5: the 6-node Yahoo ad-analytics benchmark.

    ads(kafka) -> deserializer -> filter(γ≈0.32) -> projection -> join(redis)
    -> campaign_processor.  The source is I/O-bound (Kafka network calls, §4);
    the join spends time on (emulated) Redis lookups.
    """
    return DagSpec(
        "adanalytics",
        nodes=(
            NodeSpec(
                "ads", 1.0 / 900.0, gamma=1.0, io_fraction=0.55,
                mem_mb_base=128.0, tuple_bytes=180.0, is_source=True,
            ),
            NodeSpec(
                "event_deserializer", 1.0 / 520.0, gamma=1.0,
                mem_mb_base=96.0, tuple_bytes=120.0,
            ),
            NodeSpec(
                "event_filter", 1.0 / 950.0, gamma=0.32,
                mem_mb_base=64.0, tuple_bytes=96.0,
            ),
            NodeSpec(
                "event_projection", 1.0 / 1200.0, gamma=1.0,
                mem_mb_base=64.0, tuple_bytes=48.0,
            ),
            NodeSpec(
                "redis_join", 1.0 / 600.0, gamma=1.0, io_fraction=0.35,
                mem_mb_base=192.0, tuple_bytes=56.0,
            ),
            NodeSpec(
                "campaign_processor", 1.0 / 800.0, gamma=1.0,
                mem_mb_base=160.0, mem_mb_per_ktps=0.3, tuple_bytes=40.0,
            ),
        ),
        edges=(
            EdgeSpec("ads", "event_deserializer", Grouping.SHUFFLE),
            EdgeSpec("event_deserializer", "event_filter", Grouping.SHUFFLE),
            EdgeSpec("event_filter", "event_projection", Grouping.SHUFFLE),
            EdgeSpec("event_projection", "redis_join", Grouping.SHUFFLE),
            EdgeSpec("redis_join", "campaign_processor", Grouping.FIELDS),
        ),
    )


def mobile_analytics() -> DagSpec:
    """Fig. 12: the mobile-network user-analytics DAG — nonlinear topology
    with fan-out (parser feeds three branches) and fan-in at the report sink.

        kafka_in -> log_parser -> { session_tracker -> anomaly_detector,
                                    cell_kpi,
                                    geo_mapper }
        {anomaly_detector, geo_mapper} -> report_sink;  cell_kpi -> kpi_store
    """
    return DagSpec(
        "mobile_analytics",
        nodes=(
            NodeSpec(
                "kafka_in", 1.0 / 1100.0, gamma=1.0, io_fraction=0.6,
                mem_mb_base=128.0, tuple_bytes=220.0, is_source=True,
            ),
            NodeSpec(
                "log_parser", 1.0 / 450.0, gamma=1.0,
                mem_mb_base=96.0, tuple_bytes=160.0,
            ),
            NodeSpec(
                "session_tracker", 1.0 / 700.0, gamma=1.0,
                mem_mb_base=256.0, mem_mb_per_ktps=0.8, tuple_bytes=96.0,
            ),
            NodeSpec(
                "anomaly_detector", 1.0 / 850.0, gamma=0.12,
                mem_mb_base=96.0, tuple_bytes=64.0,
            ),
            NodeSpec(
                "cell_kpi", 1.0 / 780.0, gamma=0.5,
                mem_mb_base=128.0, mem_mb_per_ktps=0.2, tuple_bytes=48.0,
            ),
            NodeSpec(
                "geo_mapper", 1.0 / 1400.0, gamma=1.0,
                mem_mb_base=64.0, tuple_bytes=72.0,
            ),
            NodeSpec(
                "report_sink", 1.0 / 900.0, gamma=0.0,
                mem_mb_base=128.0, mem_mb_per_ktps=0.2, tuple_bytes=32.0,
            ),
            NodeSpec(
                "kpi_store", 1.0 / 1000.0, gamma=0.0, io_fraction=0.4,
                mem_mb_base=192.0, tuple_bytes=40.0,
            ),
        ),
        edges=(
            EdgeSpec("kafka_in", "log_parser", Grouping.SHUFFLE),
            EdgeSpec("log_parser", "session_tracker", Grouping.FIELDS),
            EdgeSpec("log_parser", "cell_kpi", Grouping.FIELDS),
            EdgeSpec("log_parser", "geo_mapper", Grouping.SHUFFLE),
            EdgeSpec("session_tracker", "anomaly_detector", Grouping.SHUFFLE),
            EdgeSpec("anomaly_detector", "report_sink", Grouping.FIELDS),
            EdgeSpec("geo_mapper", "report_sink", Grouping.FIELDS),
            EdgeSpec("cell_kpi", "kpi_store", Grouping.FIELDS),
        ),
    )


def diamond() -> DagSpec:
    """Diamond fan-out/fan-in join topology (see module docstring).

        clicks -> { enrich_user, enrich_geo } -> click_join -> sink

    The join receives both branches keyed on the same field (FIELDS
    grouping), so its input rate is the sum of the branch outputs.
    """
    return DagSpec(
        "diamond",
        nodes=(
            NodeSpec(
                "clicks", 1.0 / 1000.0, gamma=1.0, io_fraction=0.5,
                mem_mb_base=128.0, tuple_bytes=150.0, is_source=True,
            ),
            NodeSpec(
                "enrich_user", 1.0 / 750.0, gamma=1.0,
                mem_mb_base=160.0, mem_mb_per_ktps=0.3, tuple_bytes=180.0,
            ),
            NodeSpec(
                "enrich_geo", 1.0 / 1300.0, gamma=0.9,
                mem_mb_base=96.0, tuple_bytes=120.0,
            ),
            NodeSpec(
                "click_join", 1.0 / 550.0, gamma=0.5, io_fraction=0.2,
                mem_mb_base=256.0, mem_mb_per_ktps=0.6, tuple_bytes=96.0,
            ),
            NodeSpec(
                "sink", 1.0 / 1500.0, gamma=0.0,
                mem_mb_base=96.0, tuple_bytes=48.0,
            ),
        ),
        edges=(
            EdgeSpec("clicks", "enrich_user", Grouping.SHUFFLE),
            EdgeSpec("clicks", "enrich_geo", Grouping.SHUFFLE),
            EdgeSpec("enrich_user", "click_join", Grouping.FIELDS),
            EdgeSpec("enrich_geo", "click_join", Grouping.FIELDS),
            EdgeSpec("click_join", "sink", Grouping.SHUFFLE),
        ),
    )


def deep_pipeline() -> DagSpec:
    """Deep 8-stage ETL pipeline with skewed per-stage costs (see module
    docstring).  ``transform`` (~1/260) and ``aggregate`` (~1/340) are the
    hot stages; gammas shrink the stream by ~70% end to end."""
    stages = (
        # (name, peak_ktps, gamma, io_fraction, mem_base, mem_per_ktps)
        ("ingest", 1600.0, 1.0, 0.5, 128.0, 0.0),
        ("decode", 800.0, 1.0, 0.0, 96.0, 0.0),
        ("validate", 1400.0, 0.85, 0.0, 64.0, 0.0),
        ("transform", 260.0, 1.0, 0.0, 160.0, 0.3),
        ("enrich", 900.0, 1.0, 0.15, 128.0, 0.0),
        ("aggregate", 340.0, 0.4, 0.0, 256.0, 0.7),
        ("compress", 1200.0, 0.8, 0.0, 96.0, 0.0),
        ("store", 1800.0, 0.0, 0.35, 128.0, 0.0),
    )
    nodes = tuple(
        NodeSpec(
            name,
            cpu_cost_per_ktuple=1.0 / peak,
            gamma=g,
            io_fraction=io,
            mem_mb_base=mb,
            mem_mb_per_ktps=mk,
            tuple_bytes=120.0,
            is_source=(i == 0),
        )
        for i, (name, peak, g, io, mb, mk) in enumerate(stages)
    )
    edges = tuple(
        EdgeSpec(stages[i][0], stages[i + 1][0], Grouping.SHUFFLE)
        for i in range(len(stages) - 1)
    )
    return DagSpec("deep_pipeline", nodes=nodes, edges=edges)


WORKLOADS = {
    "wordcount": wordcount,
    "adanalytics": adanalytics,
    "mobile_analytics": mobile_analytics,
    "diamond": diamond,
    "deep_pipeline": deep_pipeline,
}
