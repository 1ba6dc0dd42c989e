"""repro_torch.engine — fleet-scale ODL: Algorithm 1 batched over streams.

PyTorch counterpart of ``repro.engine``: the fleet engine, its S=1 view,
the streaming async-teacher runtime (``stream.py``, whose per-tick runners
replay as CUDA graphs on the card through ``graphs.py``), cohort fusion
(``cohort.py``) and the multi-tenant multiplexer (``multiplex.py``).
Durability, RPC and sharding are not ported yet.

``EngineState`` (``types.py``) carries a leading stream axis S on every leaf::

    EngineState
    ├── elm:   OSELMState   beta (S, N, m) · P (S, N, N) · count (S,)
    ├── prune: PruneState   level/streak/queries/skips/phase_trained (S,)
    ├── drift: DriftState   mean/var/steps/hits/calm/active (S,)
    └── meter: CommMeter    up_bytes/down_bytes (S,)

One tick is ``plan`` (projection kernel, readout, confidence, drift, query
decision, comm meter) then ``learn`` (fused RLS kernel + auto-theta ladder);
``fleet_step`` composes them and ``run_fleet`` loops it over T ticks.
``gate``/``apply_labels`` are the serving split.  The S=1 view (``step``,
``run_training_phase``, ``run_stream``, ``accuracy``) lives in ``scalar.py``;
``stream.run`` drives the engine from a tick iterator with a teacher whose
answers come back late, out of order, partly or never; ``multiplex.run``
drives many tenants' sessions in one process, same-shaped tenants fused
into cohorts that advance with one stacked dispatch per tick.
"""

from repro_torch.engine.fleet import (  # noqa: F401
    GateOutput,
    PlanOutput,
    apply_labels,
    broadcast_streams,
    fleet_accuracy,
    fleet_step,
    gate,
    init_fleet,
    learn,
    plan,
    remove_streams,
    run_fleet,
    slice_streams,
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

# The runtime's modules, as in the JAX package (fleet imports first).
from repro_torch.engine import cohort, multiplex, stream  # noqa: E402,F401
