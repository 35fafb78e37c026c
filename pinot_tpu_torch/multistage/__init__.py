"""Multistage (v2) query engine: joins, subqueries, set ops, window functions.

Reference parity: pinot-query-planner (QueryEnvironment.java:100) +
pinot-query-runtime (QueryDispatcher.java:99, MailboxService.java:40,
runtime/operator/). See logical.py (planner, exchange placement, stage
cutting) and runtime.py (mailboxes, operators, OpChain workers). This is the
JAX package's in-process engine; its leaf stages run the single-stage engine
on the engine's device.
"""

from pinot_tpu_torch.multistage.logical import Catalog, StagePlan, build_stage_plan
from pinot_tpu_torch.multistage.runtime import MailboxService, MultistageEngine

__all__ = ["Catalog", "StagePlan", "build_stage_plan", "MailboxService", "MultistageEngine"]
