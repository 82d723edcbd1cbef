"""Core hybrid-computing engine (the paper's contribution, generalized).

- work_sharing:    throughput-proportional work splits (paper §5.4.3)
- async_executor:  chunk-pipelined concurrent execution + work stealing
- calibration:     static + EWMA online throughput estimation (paper §4.5)
- cost_model:      per-device hardware profile + analytic priors
- hybrid_executor: executes work-shared plans over a GPU + CPU pair
- metrics:         gain & idle-time accounting (paper §5.1)
"""
from repro_torch.core.work_sharing import (WorkPlan, integer_shares,
                                           paper_split, plan_work,
                                           proportional_shares,
                                           refine_split)
from repro_torch.core.calibration import (CalibrationCache,
                                          ThroughputTracker,
                                          clear_calibration_cache,
                                          get_calibration_cache)
from repro_torch.core.async_executor import (AsyncChunkExecutor, Chunk,
                                             ChunkRecord, ExecutionTrace,
                                             WorkStealingScheduler,
                                             make_chunks)
from repro_torch.core.hybrid_executor import (DeviceGroup, HybridExecutor,
                                              WorkSharedOutput,
                                              detect_platform)
from repro_torch.core.metrics import EWMA, HybridResult
