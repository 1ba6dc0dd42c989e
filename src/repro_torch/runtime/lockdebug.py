"""Lock-order cycle detection behind ``REPRO_LOCK_DEBUG=1`` (the port's own
copy of the JAX package's ``runtime/lockdebug.py``).

Prove the runtime's locks are acquired in a consistent *order*.
``make_lock`` / ``make_rlock`` / ``make_condition`` return plain
``threading`` primitives unless ``REPRO_LOCK_DEBUG=1`` is set when the lock
is created: no overhead in production, full tracking in debug runs.  The
variable is the reference's, so one setting turns on both packages'
checkers; each package keeps its own acquisition graph (``GRAPH`` here).

Tracking model: a per-thread stack of currently held locks plus one
process-global acquisition graph.  Acquiring ``B`` while holding ``A`` adds
the edge ``A -> B``; an edge that closes a cycle (``B ... -> A`` already
reachable) raises ``LockOrderError`` *before* blocking, so the deadlock is
reported at the first inconsistent acquisition, not when two threads
finally interleave into it.

Reentrant acquires of the same RLock add no edge.  Condition variables wrap
a tracked lock, so waiting and notifying follow the same discipline.
"""

from __future__ import annotations

import os
import threading

_ENV = "REPRO_LOCK_DEBUG"


class LockOrderError(RuntimeError):
    """Two locks were acquired in both orders: a latent deadlock."""


class _Graph:
    """The process-global acquisition graph (edges lock name -> lock name)."""

    def __init__(self):
        self._edges: dict[str, set] = {}
        self._mu = threading.Lock()
        self._held = threading.local()

    def held_stack(self) -> list:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def edges(self) -> dict:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def clear(self) -> None:
        with self._mu:
            self._edges.clear()

    def before_acquire(self, name: str) -> None:
        stack = self.held_stack()
        if not stack:
            return
        holder = stack[-1]
        if holder == name:  # reentrant RLock acquire
            return
        with self._mu:
            self._edges.setdefault(holder, set()).add(name)
            path = self._find_path(name, holder)
        if path is not None:
            raise LockOrderError(
                f"lock-order cycle: acquiring {name!r} while holding "
                f"{holder!r}, but {holder!r} is already acquired after "
                f"{name!r} elsewhere (path: {' -> '.join(path + [name])})"
            )

    def _find_path(self, src: str, dst: str):
        """DFS path src -> dst in the edge graph (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def did_acquire(self, name: str) -> None:
        self.held_stack().append(name)

    def did_release(self, name: str) -> None:
        stack = self.held_stack()
        # Remove the most recent entry (locks are not always released LIFO:
        # with-blocks are, manual acquire/release may not be).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return


GRAPH = _Graph()


class _TrackedLock:
    """Proxy over Lock/RLock feeding the acquisition graph.

    Duck-types the whole lock protocol (``acquire``/``release``/context
    manager/``locked``), so it drops in anywhere a real lock is used,
    including as the underlying lock of ``threading.Condition``.
    """

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name
        # RLock reentrancy: count our own nesting so release pops the held
        # stack only when the outermost hold ends.
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._depth() == 0:
            GRAPH.before_acquire(self._name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._depth() == 0:
                GRAPH.did_acquire(self._name)
            self._local.depth = self._depth() + 1
        return ok

    def release(self) -> None:
        self._inner.release()
        self._local.depth = self._depth() - 1
        if self._depth() == 0:
            GRAPH.did_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") else False

    # Condition uses these when present to save and restore the recursion
    # state around wait(); delegate so RLock-backed conditions keep working.
    def _release_save(self):
        saved = (self._depth(), self._name)
        if hasattr(self._inner, "_release_save"):
            inner_state = self._inner._release_save()
        else:
            self._inner.release()
            inner_state = None
        self._local.depth = 0
        GRAPH.did_release(self._name)
        return (saved, inner_state)

    def _acquire_restore(self, state):
        (depth, _name), inner_state = state
        GRAPH.before_acquire(self._name)
        if inner_state is not None and hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        GRAPH.did_acquire(self._name)
        self._local.depth = depth

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return self._depth() > 0


def _enabled() -> bool:
    return os.environ.get(_ENV, "") == "1"


def make_lock(name: str):
    """A ``threading.Lock``, tracked when REPRO_LOCK_DEBUG=1."""
    lock = threading.Lock()
    return _TrackedLock(lock, name) if _enabled() else lock


def make_rlock(name: str):
    """A ``threading.RLock``, tracked when REPRO_LOCK_DEBUG=1."""
    lock = threading.RLock()
    return _TrackedLock(lock, name) if _enabled() else lock


def make_condition(name: str):
    """A ``threading.Condition`` over a fresh (tracked when enabled) lock."""
    if not _enabled():
        return threading.Condition()
    return threading.Condition(_TrackedLock(threading.Lock(), name))
