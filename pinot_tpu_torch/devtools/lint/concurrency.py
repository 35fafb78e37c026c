"""lock-order + blocking-under-lock: interprocedural concurrency checkers.

Both ride the whole-program `callgraph.ProgramIndex` (one shared build per
lint session).

lock-order
    Builds the lock-acquisition graph: an edge A -> B whenever some function
    acquires B (directly, or anywhere down its resolved call chain) while
    holding A. A cycle in that graph is a potential deadlock: two threads
    entering the cycle from different edges block each other forever.
    Re-acquiring the SAME lock is not an edge (the codebase uses RLock where
    reentrancy is intended); every distinct-lock edge that participates in a
    cycle is reported at its acquisition/call site, naming the opposite
    direction's witness so the inversion is readable from either end.

blocking-under-lock
    Flags operations that can park a thread for an unbounded/IO-scale time
    while a lock is held — the whole process's other threads then convoy on
    that lock. Blocking set: `time.sleep`, socket/HTTP I/O
    (`urllib.request.urlopen`, `socket.create_connection`, `.recv`/
    `.accept`), `queue.get` (incl. `timeout=`), mailbox `.receive`/
    `.receive_all`, `Future.result`, `Thread.join`, and `.wait` on
    events/conditions. A Condition `.wait()` while holding exactly the lock
    the Condition wraps is the one legal shape (wait releases it); holding
    any OTHER lock across the wait is still flagged. Interprocedural: a call
    made with a lock held is flagged when the callee can reach a blocking
    operation through the call graph, with the full chain in the message.

Known false-positive shapes (suppress with a reason):
- `.join`/`.get`/`.result`/`.wait` are recognized by argument shape and
  receiver, not type inference — an unrelated API with the same name and
  arity can trip them;
- a callee that blocks only on a code path the caller can never take still
  produces a witness (the analysis is path-insensitive);
- a lock released manually before the blocking call (`.release()`) is not
  modeled — only `with` scoping is.
"""

from __future__ import annotations

import ast

from pinot_tpu_torch.devtools.lint.core import Checker, Finding, dotted_name

#: exact dotted-call suffixes that always block
_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep()",
    "urllib.request.urlopen": "urllib.request.urlopen()",
    "request.urlopen": "urllib.request.urlopen()",
    "urlopen": "urlopen()",
    "socket.create_connection": "socket.create_connection()",
    "select.select": "select.select()",
}

#: attribute calls that block regardless of arguments
_BLOCKING_ATTRS = {
    "recv": "socket .recv()",
    "recv_into": "socket .recv_into()",
    "accept": "socket .accept()",
    "result": "Future.result()",
    "receive": "mailbox .receive()",
    "receive_all": "mailbox .receive_all()",
}


def classify_blocking(call: ast.Call, dotted: str) -> str | None:
    """Human label when `call` is a blocking operation, else None. Lexical
    heuristics only — see the module docstring for the exact shapes."""
    if dotted:
        leaf2 = ".".join(dotted.split(".")[-2:])
        if dotted in _BLOCKING_DOTTED:
            return _BLOCKING_DOTTED[dotted]
        if leaf2 in _BLOCKING_DOTTED:
            return _BLOCKING_DOTTED[leaf2]
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    if attr in _BLOCKING_ATTRS:
        return _BLOCKING_ATTRS[attr]
    n_pos = len(call.args)
    kwargs = {kw.arg for kw in call.keywords}
    if attr == "join":
        # Thread.join() / join(timeout) — NOT str.join(iterable) / path.join
        if dotted.endswith("path.join"):
            return None
        if n_pos == 0 and (not kwargs or kwargs <= {"timeout"}):
            return "Thread.join()"
        if n_pos == 1 and isinstance(call.args[0], ast.Constant) and isinstance(
            call.args[0].value, (int, float)
        ):
            return "Thread.join(timeout)"
        return None
    if attr == "get":
        # queue.Queue.get() / get(timeout=..) — NOT dict.get(key[, default])
        if n_pos == 0 and (not kwargs or kwargs <= {"block", "timeout"}):
            return "queue .get()"
        return None
    if attr == "wait":
        if n_pos <= 1 and (not kwargs or kwargs <= {"timeout"}):
            return ".wait()"
        return None
    return None


#: dotted suffixes that only matter on an asyncio event loop: they park the
#: ONE thread everything runs on, but are ordinary (often intended) blocking
#: calls in threaded code, so blocking-under-lock ignores them
_LOOP_BLOCKING_DOTTED = {
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_call": "subprocess.check_call()",
    "subprocess.check_output": "subprocess.check_output()",
    "subprocess.Popen": "subprocess.Popen()",
    "fcntl.flock": "fcntl.flock()",
    "fcntl.lockf": "fcntl.lockf()",
    "os.fsync": "os.fsync()",
    "pool.request": "wire pool .request()",
    "pool.checkout": "wire pool .checkout()",
}

#: attribute calls in the loop-only set (socket/HTTP client surface)
_LOOP_BLOCKING_ATTRS = {
    "connect": "socket .connect()",
    "sendall": "socket .sendall()",
    "getresponse": "HTTPConnection.getresponse()",
}


def classify_loop_blocking(call: ast.Call, dotted: str) -> str | None:
    """Label for ops blocking ONLY from the event-loop-safety perspective
    (`classify_blocking` already returned None). Same lexical heuristics."""
    if dotted:
        leaf2 = ".".join(dotted.split(".")[-2:])
        if dotted in _LOOP_BLOCKING_DOTTED:
            return _LOOP_BLOCKING_DOTTED[dotted]
        if leaf2 in _LOOP_BLOCKING_DOTTED:
            return _LOOP_BLOCKING_DOTTED[leaf2]
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOOP_BLOCKING_ATTRS:
        return _LOOP_BLOCKING_ATTRS[fn.attr]
    return None


class LockOrderChecker(Checker):
    name = "lock-order"

    def finalize(self, modules) -> list[Finding]:
        idx = self.session.index
        # (held, acquired) -> (path, line, via) witness, first occurrence wins
        edges: dict[tuple[str, str], tuple[str, int, str]] = {}
        for fn in idx.functions.values():
            for acq in fn.acquires:
                for held in acq.held_before:
                    if held != acq.lock_id:
                        edges.setdefault(
                            (held, acq.lock_id),
                            (fn.module.path, acq.line, f"in {fn.short}()"),
                        )
            for call in fn.calls:
                if call.callee is None or not call.held:
                    continue
                for lid in idx.trans_acquires(call.callee):
                    for held in call.held:
                        if held != lid:
                            edges.setdefault(
                                (held, lid),
                                (
                                    fn.module.path,
                                    call.line,
                                    f"in {fn.short}() via {call.callee.rsplit('.', 1)[-1]}()",
                                ),
                            )
        cycle_nodes = self._nodes_on_cycles(edges)
        out: list[Finding] = []
        for (a, b), (path, line, via) in sorted(edges.items(), key=lambda kv: kv[1][:2]):
            if a not in cycle_nodes or b not in cycle_nodes:
                continue
            if not self._on_common_cycle(a, b, edges):
                continue
            back = edges.get((b, a))
            opposite = (
                f"; inverse order at {back[0]}:{back[1]} {back[2]}"
                if back is not None
                else ""
            )
            out.append(
                Finding(
                    self.name,
                    path,
                    line,
                    f"lock-order inversion: {_short_lock(b)} acquired while holding "
                    f"{_short_lock(a)} {via}{opposite} — cycle means potential deadlock",
                )
            )
        return out

    @staticmethod
    def _nodes_on_cycles(edges) -> set[str]:
        """Locks that sit inside a non-trivial SCC of the acquisition graph."""
        graph: dict[str, set[str]] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        counter = [0]
        sccs: list[list[str]] = []

        def strongconnect(v: str):
            # iterative Tarjan (recursion depth is unbounded on big graphs)
            work = [(v, iter(sorted(graph[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(comp)

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        return {v for comp in sccs if len(comp) > 1 for v in comp}

    @staticmethod
    def _on_common_cycle(a: str, b: str, edges) -> bool:
        """True when b can reach a through the edge set (so a->b closes a
        cycle) — keeps cross-SCC edges between two cyclic locks out."""
        graph: dict[str, set[str]] = {}
        for x, y in edges:
            graph.setdefault(x, set()).add(y)
        seen = {b}
        frontier = [b]
        while frontier:
            n = frontier.pop()
            if n == a:
                return True
            for m in graph.get(n, ()):  # BFS over lock ids
                if m not in seen:
                    seen.add(m)
                    frontier.append(m)
        return False


class BlockingUnderLockChecker(Checker):
    name = "blocking-under-lock"

    def finalize(self, modules) -> list[Finding]:
        idx = self.session.index
        out: list[Finding] = []
        seen: set[tuple] = set()
        for fn in idx.functions.values():
            for op in fn.blocking:
                if op.loop_only:
                    continue  # event-loop-safety's set, not this checker's
                held = set(op.held)
                if op.releases is not None:
                    held.discard(op.releases)  # Condition.wait releases its lock
                if not held:
                    continue
                key = (fn.module.path, op.line, op.desc)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    Finding(
                        self.name,
                        fn.module.path,
                        op.line,
                        f"{op.desc} while holding {_locks_phrase(held)} in {fn.short}() — "
                        "blocked thread convoys every waiter of the lock",
                    )
                )
            for call in fn.calls:
                if call.callee is None or not call.held:
                    continue
                wit = idx.block_witness(call.callee)
                if wit is None:
                    continue
                path, line, desc, chain = wit
                key = (fn.module.path, call.line, call.callee)
                if key in seen:
                    continue
                seen.add(key)
                out.append(
                    Finding(
                        self.name,
                        fn.module.path,
                        call.line,
                        f"call under {_locks_phrase(call.held)} in {fn.short}() can block: "
                        f"{' -> '.join(chain)} reaches {desc} at {path}:{line}",
                    )
                )
        return out


def _short_lock(lock_id: str) -> str:
    """'pinot_tpu_torch.query.scheduler.QueryScheduler._lock' -> 'QueryScheduler._lock'."""
    parts = lock_id.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else lock_id


def _locks_phrase(held) -> str:
    names = sorted(_short_lock(h) for h in held)
    return "lock " + names[0] if len(names) == 1 else "locks " + ", ".join(names)
