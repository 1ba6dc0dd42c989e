"""Alias of the S=1 view of the fleet engine (``repro_torch.engine``), kept
at the JAX package's original import path so paper-repro code reads the
same in both packages.  ``ODLCoreConfig`` / ``ODLCoreState`` /
``StepOutput`` are the engine's own ``EngineConfig`` / ``EngineState`` /
``FleetStepOutput`` classes.
"""

from repro_torch.engine import (  # noqa: F401
    ODLCoreConfig,
    ODLCoreState,
    StepOutput,
    accuracy,
    init_state,
    run_stream,
    run_training_phase,
    step,
    train_phase_step,
)
