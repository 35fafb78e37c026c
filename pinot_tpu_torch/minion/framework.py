"""Minion task framework: controller-side generators + minion-side executors.

Reference parity: PinotTaskGenerator (pinot-controller/.../helix/core/minion/
generator/PinotTaskGenerator.java:35) producing task configs per table,
PinotTaskManager scheduling them, and PinotTaskExecutor
(pinot-minion/.../executor/PinotTaskExecutor.java:27) running them on minion
nodes. Helix's task queue collapses to an in-process thread-safe queue with
task states (IN_PROGRESS/COMPLETED/FAILED) that the controller REST surface
can expose; a Minion polls, executes registered executors, reports back.

This is the JAX package's `minion/framework.py`; a minion's tasks run on the
host, and the segments they write reach the device where servers serve them.
"""

from __future__ import annotations

import itertools
import threading
import traceback
from dataclasses import dataclass, field
from enum import Enum


class TaskState(Enum):
    WAITING = "WAITING"
    IN_PROGRESS = "IN_PROGRESS"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclass
class TaskConfig:
    task_type: str
    table_name: str
    configs: dict = field(default_factory=dict)
    task_id: str = ""
    state: TaskState = TaskState.WAITING
    result: object = None
    error: str = ""


class TaskGenerator:
    """Controller-side: inspect cluster state, emit task configs."""

    task_type: str = ""

    def generate_tasks(self, table_config, controller) -> list[TaskConfig]:
        raise NotImplementedError


class PinotTaskExecutor:
    """Minion-side: execute one task config."""

    task_type: str = ""

    def execute(self, task: TaskConfig, controller) -> object:
        raise NotImplementedError


class PinotTaskManager:
    """Controller-side scheduler + queue (PinotTaskManager parity)."""

    def __init__(self, controller):
        self._controller = controller
        self._generators: dict[str, TaskGenerator] = {}
        self._queue: list[TaskConfig] = []
        self._all: dict[str, TaskConfig] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def register_generator(self, gen: TaskGenerator) -> None:
        self._generators[gen.task_type] = gen

    def schedule_tasks(self, task_type: str | None = None) -> list[TaskConfig]:
        """Run generators over all tables; enqueue fresh tasks
        (the periodic-task / REST /tasks/schedule entry point)."""
        out = []
        gens = (
            list(self._generators.values())
            if task_type is None
            else [self._generators[task_type]]
        )
        for table in self._controller.tables():
            tc = self._controller.get_table(table)
            task_types = (tc.extra or {}).get("taskTypes")
            for g in gens:
                if task_types is not None and g.task_type not in task_types:
                    continue
                for t in g.generate_tasks(tc, self._controller):
                    t.task_id = f"Task_{t.task_type}_{next(self._seq)}"
                    with self._lock:
                        self._queue.append(t)
                        self._all[t.task_id] = t
                    out.append(t)
        return out

    def submit(self, task: TaskConfig) -> TaskConfig:
        """Directly enqueue an ad-hoc task (REST /tasks/execute parity)."""
        task.task_id = task.task_id or f"Task_{task.task_type}_{next(self._seq)}"
        with self._lock:
            self._queue.append(task)
            self._all[task.task_id] = task
        return task

    def poll(self, supported: set[str]) -> TaskConfig | None:
        with self._lock:
            for i, t in enumerate(self._queue):
                if t.task_type in supported:
                    self._queue.pop(i)
                    t.state = TaskState.IN_PROGRESS
                    return t
        return None

    def task_state(self, task_id: str) -> TaskState | None:
        with self._lock:
            t = self._all.get(task_id)
            return t.state if t else None

    def tasks(self, state: TaskState | None = None) -> list[TaskConfig]:
        with self._lock:
            return [t for t in self._all.values() if state is None or t.state == state]


class Minion:
    """Minion node: executor registry + worker loop (BaseMinionStarter +
    TaskFactoryRegistry parity). `run_pending()` drains synchronously for
    tests; `start()` polls in a background thread."""

    def __init__(self, minion_id: str, task_manager: PinotTaskManager, controller):
        self.minion_id = minion_id
        self._tm = task_manager
        self._controller = controller
        self._executors: dict[str, PinotTaskExecutor] = {}
        self._thread: threading.Thread | None = None
        self._running = False

    def register_executor(self, ex: PinotTaskExecutor) -> None:
        self._executors[ex.task_type] = ex

    def _run_one(self, task: TaskConfig) -> None:
        from pinot_tpu_torch.common.metrics import MinionMeter, minion_metrics

        try:
            task.result = self._executors[task.task_type].execute(task, self._controller)
            task.state = TaskState.COMPLETED
            minion_metrics().meter(MinionMeter.TASKS_EXECUTED).mark()
        except Exception:
            task.state = TaskState.FAILED
            task.error = traceback.format_exc()
            minion_metrics().meter(MinionMeter.TASKS_FAILED).mark()

    def run_pending(self) -> int:
        """Execute queued tasks this minion supports; returns count run."""
        n = 0
        while (task := self._tm.poll(set(self._executors))) is not None:
            self._run_one(task)
            n += 1
        return n

    def start(self, poll_interval: float = 0.1) -> None:
        self._running = True

        def loop():
            import time

            while self._running:
                if self.run_pending() == 0:
                    time.sleep(poll_interval)

        self._thread = threading.Thread(target=loop, name=f"minion-{self.minion_id}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
