from repro_torch.runtime.faults import (FaultPlan, FaultSpec,  # noqa: F401
                                        StarveState)
from repro_torch.runtime.guards import (OK, ROLLBACK, SKIP,  # noqa: F401
                                        GuardConfig, GuardState,
                                        disable_fp8_monitor,
                                        enable_fp8_monitor, fold_fp8,
                                        fp8_sat_counts,
                                        fp8_sat_rate, reset_fp8_counter)
from repro_torch.runtime.rollback import RollbackManager  # noqa: F401
