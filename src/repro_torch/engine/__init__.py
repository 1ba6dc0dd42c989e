"""repro_torch.engine — fleet-scale ODL: Algorithm 1 batched over streams.

PyTorch counterpart of ``repro.engine``: the fleet engine, its S=1 view,
the streaming async-teacher runtime (``stream.py``, whose per-tick runners
replay as CUDA graphs on the card through ``graphs.py``), cohort fusion
(``cohort.py``), the multi-tenant multiplexer (``multiplex.py``) and
durability (``snapshot.py``: snapshot/restore of a live session and its wire
frame; ``durable.py``: the single-session durable runner and the
kill-and-resume smoke, ``python -m repro_torch.engine.durable
--crash-smoke``) and the teacher transport (``rpc.py`` on ``wire.py``).

Sharding: ``split_fleet``/``run_fleet_shards``/``merge_fleet`` split a fleet
along its stream axis into shard-local blocks, one device per shard (a
``launch.mesh.make_fleet_mesh`` mesh under ``distributed.sharding.activate``,
or an explicit device list), and ``stream.run_sharded`` runs one stream
session per shard; both are bit for bit the unsplit run.
``shard_fleet``/``run_fleet_sharded`` keep the reference's GSPMD layout on a
mesh whose entries are all one device.

Teachers over the wire: ``engine.rpc.RpcTeacher`` speaks the
``stream.Teacher`` protocol over a real TCP socket with timeout -> loss;
``engine.rpc.BatchedRpcClient`` shares one such connection across all
tenants of a teacher host, coalescing asks that land within a flush window
into single length-prefixed binary frames (v2; v1 newline JSON and the zlib
envelope stay supported) and demuxing replies to per-tenant
``BatchedRpcTeacher`` handles; ``multiplex.shared_rpc_teachers`` dedups
endpoints into shared clients.  ``engine.rpc.LabelServer`` is the bundled
label server (``python -m repro_torch.engine.rpc``).  The wire is the JAX
package's byte for byte, so clients and servers of the two packages talk
to each other.  ``rpc`` and ``durable`` are leaves with a CLI, kept out of
the package import so ``python -m`` runs them cleanly.

``EngineState`` (``types.py``) carries a leading stream axis S on every leaf::

    EngineState
    ├── elm:   OSELMState   beta (S, N, m) · P (S, N, N) · count (S,)
    ├── prune: PruneState   level/streak/queries/skips/phase_trained (S,)
    ├── drift: DriftState   mean/var/steps/hits/calm/active (S,)
    └── meter: CommMeter    up_bytes/down_bytes (S,)

One tick is ``plan`` (projection kernel, then one per-stream pass for the
readout, confidence, drift, query decision and comm meter) then ``learn``
(fused RLS kernel + auto-theta ladder);
``fleet_step`` composes them and ``run_fleet`` walks T ticks in chunks
through the chunk runner (one CUDA graph replay a chunk on the card, the
same ticks eagerly on the CPU; the state donated on the card by default;
one-shot callers pass ``chunk=CHUNK_TICKS``; ``release_chunk_graphs``
frees the card's graphs).
``gate``/``apply_labels`` are the serving split.  The S=1 view (``step``,
``run_training_phase``, ``run_stream``, ``accuracy``) lives in ``scalar.py``;
``stream.run`` drives the engine from a tick iterator with a teacher whose
answers come back late, out of order, partly or never; ``multiplex.run``
drives many tenants' sessions in one process, same-shaped tenants fused
into cohorts that advance with one stacked dispatch per tick.
"""

from repro_torch.engine.fleet import (  # noqa: F401
    CHUNK_TICKS,
    DEFAULT_STREAM_BLOCK,
    FleetShards,
    GateOutput,
    PlanOutput,
    apply_labels,
    broadcast_streams,
    fleet_accuracy,
    fleet_step,
    gate,
    init_fleet,
    learn,
    merge_fleet,
    pad_streams,
    plan,
    release_chunk_graphs,
    remove_streams,
    run_fleet,
    run_fleet_sharded,
    run_fleet_shards,
    runner_cache_info,
    shard_fleet,
    slice_streams,
    split_fleet,
    stack_streams,
    stream_slice,
)
from repro_torch.engine.types import (  # noqa: F401
    EngineConfig,
    EngineState,
    FleetStepOutput,
    ODLCoreConfig,
    ODLCoreState,
    StepOutput,
    init_state,
)

from .scalar import (  # noqa: F401,E402
    accuracy,
    run_stream,
    run_training_phase,
    step,
    train_phase_step,
)

# The runtime's modules, as in the JAX package (fleet imports first;
# ``durable`` and ``rpc`` are leaves with a CLI, kept out of the package
# import so ``python -m repro_torch.engine.<leaf>`` stays clean).
from repro_torch.engine import cohort, multiplex, snapshot, stream  # noqa: E402,F401
