from pinot_tpu_torch.minion.framework import (
    Minion,
    PinotTaskExecutor,
    PinotTaskManager,
    TaskConfig,
    TaskGenerator,
    TaskState,
)
from pinot_tpu_torch.minion.processing import SegmentProcessorConfig, process_segments

__all__ = [
    "Minion",
    "PinotTaskExecutor",
    "PinotTaskManager",
    "TaskConfig",
    "TaskGenerator",
    "TaskState",
    "SegmentProcessorConfig",
    "process_segments",
]
