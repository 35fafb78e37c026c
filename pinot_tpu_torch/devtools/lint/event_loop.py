"""event-loop-safety: the lint gate for the ROADMAP-1 asyncio rewrite.

An asyncio frontend runs everything on ONE thread; a single blocking call
parks every in-flight query. This pack flags the four shapes that sink
event-loop code, so the rewrite can land incrementally with CI holding the
line from day one:

1. **Blocking op reachable from an `async def`** — directly, or through any
   chain of resolved SYNC calls. The blocking set is the
   blocking-under-lock set (time.sleep, socket recv/accept, queue.get,
   Future.result, .wait, urlopen, ...) plus the loop-only set (subprocess,
   fcntl.flock/lockf, os.fsync, socket connect/sendall,
   HTTPConnection.getresponse, pooled `wire` .request/.checkout).
   Executor hand-offs are the sanctioned escape: `loop.run_in_executor(...)`
   and `asyncio.to_thread(...)` pass the worker as an uncalled reference,
   which creates no call edge — the analysis never follows it, exactly
   mirroring the runtime (the blocking work happens off-loop).
2. **`await` while holding a `threading` lock** — the coroutine parks with
   the lock held; every thread (and every other coroutine hopping through
   an executor) convoys on it.
3. **Un-awaited coroutine call** — a statement-level `f(...)` where `f`
   resolves to an `async def`: the coroutine object is created and dropped,
   the body never runs.
4. **Threading primitive in an `async def`** — `with self._lock:` /
   `threading.Lock()` acquisitions inside coroutines; use `asyncio.Lock` /
   `asyncio.Condition` (constructions via `asyncio.*` are recognized and
   exempt).

Checks 1, 2 and 4 only fire INSIDE `async def` bodies, so today's fully
threaded package lints clean and every finding appears exactly when a
module converts. Check 3 fires in sync code too (calling a coroutine from
sync code without scheduling it is always a bug).

Known false-positive shapes (suppress with a reason):
- a sync helper that blocks only on a path the coroutine never takes still
  produces a witness (path-insensitive);
- a blocking call deliberately wrapped in a short-lived lock + executor
  combination needs a reasoned suppression;
- `.connect`/`.sendall`/`.getresponse` are name-based — an unrelated API
  with the same method name trips them.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, walk_scope

_EXECUTOR_HINT = "hand off via loop.run_in_executor() or asyncio.to_thread()"


class EventLoopSafetyChecker(Checker):
    name = "event-loop-safety"

    def finalize(self, modules) -> list[Finding]:
        idx = self.session.index
        out: list[Finding] = []
        for fi in idx.functions.values():
            # (3) un-awaited coroutine calls — any caller, sync or async
            stmt_calls = {
                id(n.value)
                for n in walk_scope(fi.node)
                if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
            }
            for call in fi.calls:
                if call.callee is None or id(call.node) not in stmt_calls:
                    continue
                callee = idx.functions[call.callee]
                if callee.is_async:
                    out.append(
                        Finding(
                            check=self.name,
                            path=fi.module.path,
                            line=call.line,
                            message=(
                                f"coroutine {callee.short}() is called but never awaited in"
                                f" {fi.short}() — the body never runs; await it or schedule it"
                                f" with asyncio.create_task()"
                            ),
                        )
                    )
            if not fi.is_async:
                continue
            # (1a) blocking ops directly in the coroutine body
            for op in fi.blocking:
                out.append(
                    Finding(
                        check=self.name,
                        path=fi.module.path,
                        line=op.line,
                        message=(
                            f"blocking {op.desc} inside async def {fi.short}() parks the"
                            f" event loop — {_EXECUTOR_HINT}"
                        ),
                    )
                )
            # (1b) blocking ops reachable through sync callees
            for call in fi.calls:
                if call.callee is None or idx.functions[call.callee].is_async:
                    continue
                wit = idx.loop_block_witness(call.callee)
                if wit is None:
                    continue
                _, _, desc, chain = wit
                out.append(
                    Finding(
                        check=self.name,
                        path=fi.module.path,
                        line=call.line,
                        message=(
                            f"async def {fi.short}() reaches blocking {desc} via"
                            f" {' -> '.join(chain)} — {_EXECUTOR_HINT}"
                        ),
                    )
                )
            # (2) await with a threading lock held
            for line, held in fi.awaits:
                if held:
                    locks = ", ".join(sorted(held))
                    out.append(
                        Finding(
                            check=self.name,
                            path=fi.module.path,
                            line=line,
                            message=(
                                f"await while holding threading lock {locks} in async def"
                                f" {fi.short}() — the coroutine parks with the lock held and"
                                f" every waiter convoys; use asyncio.Lock"
                            ),
                        )
                    )
            # (4) threading primitives acquired inside the coroutine
            for acq in fi.acquires:
                out.append(
                    Finding(
                        check=self.name,
                        path=fi.module.path,
                        line=acq.line,
                        message=(
                            f"threading lock {acq.lock_id} acquired inside async def"
                            f" {fi.short}() — use an asyncio primitive (asyncio.Lock/"
                            f"Condition) on the event loop"
                        ),
                    )
                )
        return out
