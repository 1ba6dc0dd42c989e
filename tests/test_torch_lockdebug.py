"""The port's lock-order cycle detector (``repro_torch.runtime.lockdebug``,
on under ``REPRO_LOCK_DEBUG=1``), mirroring ``tests/test_lockdebug.py``.

The unit tests drive the port's acquisition graph directly; the
integration tests run one real round trip through the port's RPC client and
server and one contended telemetry workload with tracking on: the port's
runtime locks are made by ``lockdebug.make_*``, so these exercise its real
lock graph.  The last test holds the port's graph apart from the JAX
package's: one variable turns both checkers on, each keeps its own graph.
Nothing here needs JAX or a card.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import rpc  # noqa: E402
from repro_torch.runtime import lockdebug, telemetry  # noqa: E402


@pytest.fixture
def lock_debug(monkeypatch):
    monkeypatch.setenv("REPRO_LOCK_DEBUG", "1")
    lockdebug.GRAPH.clear()
    yield
    lockdebug.GRAPH.clear()


# ---------------------------------------------------------------------------
# unit: the graph itself
# ---------------------------------------------------------------------------


def test_plain_locks_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_LOCK_DEBUG", raising=False)
    assert isinstance(lockdebug.make_lock("x"), type(threading.Lock()))
    assert not isinstance(lockdebug.make_lock("x"), lockdebug._TrackedLock)


def test_consistent_order_is_fine(lock_debug):
    a, b = lockdebug.make_lock("A"), lockdebug.make_lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockdebug.GRAPH.edges() == {"A": {"B"}}


def test_cycle_raises_before_blocking(lock_debug):
    a, b = lockdebug.make_lock("A"), lockdebug.make_lock("B")
    with a:
        with b:
            pass
    with pytest.raises(lockdebug.LockOrderError, match="A -> B -> A"):
        with b:
            with a:
                pass


def test_three_lock_cycle(lock_debug):
    a, b, c = lockdebug.make_lock("A"), lockdebug.make_lock("B"), lockdebug.make_lock("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(lockdebug.LockOrderError):
        with c:
            with a:
                pass


def test_rlock_reentrancy_adds_no_edge(lock_debug):
    r = lockdebug.make_rlock("R")
    with r:
        with r:  # reentrant: no self-edge, no false cycle
            pass
    assert lockdebug.GRAPH.edges() == {}


def test_condition_wait_releases_for_order_purposes(lock_debug):
    """While cond.wait() sleeps the underlying lock is not held: an
    acquisition of another lock meanwhile must not see it."""
    cond = lockdebug.make_condition("C")
    other = lockdebug.make_lock("O")
    woke = []

    def waiter():
        with cond:
            cond.wait(timeout=5.0)
            woke.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)  # let the waiter enter wait()
    with other:
        pass  # would add C -> O if wait() leaked the hold
    with cond:
        cond.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive() and woke
    assert "O" not in lockdebug.GRAPH.edges().get("C", set())


# ---------------------------------------------------------------------------
# integration: the port's rpc and telemetry under REPRO_LOCK_DEBUG=1
# ---------------------------------------------------------------------------


def _drain(handle, want=1, timeout_s=10.0):
    out = []
    deadline = time.monotonic() + timeout_s
    while len(out) < want and time.monotonic() < deadline:
        out += handle.poll(0)
        time.sleep(1e-3)
    return out


def test_rpc_roundtrip_under_lock_debug(lock_debug):
    server = rpc.LabelServer(n_out=4).start()
    try:
        assert isinstance(server._tlock, lockdebug._TrackedLock)
        feats = torch.zeros((2, 4))
        mask = np.ones(2, bool)
        with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                  batch_window_s=1e-3) as client:
            # The client's condition and reconnect lock are tracked proxies.
            assert isinstance(client._cond._lock, lockdebug._TrackedLock)
            assert isinstance(client._reconnect_lock, lockdebug._TrackedLock)
            assert isinstance(client._conn.wlock, lockdebug._TrackedLock)
            t = client.tenant("a")
            ticket = t.ask(feats, mask, tick=1)
            replies = _drain(t)
        assert [r.ticket for r in replies] == [ticket]
        assert replies[0].labels.tolist() == [rpc.expected_label(1, s, 4) for s in range(2)]
    finally:
        server.close()
    # The round trip raised no LockOrderError and left no lock held.
    assert lockdebug.GRAPH.held_stack() == []


def test_telemetry_contention_under_lock_debug(lock_debug):
    tel = telemetry.Telemetry(span_capacity=256, span_sample=2)
    assert isinstance(tel.registry._lock, lockdebug._TrackedLock)
    assert isinstance(tel.tracer._lock, lockdebug._TrackedLock)
    n_threads, n_iter = 4, 200
    errs = []

    def hammer(k):
        try:
            for _ in range(n_iter):
                tel.registry.count("odl_test_total", tenant=str(k))
                tok = tel.tracer.begin("test.span")
                tel.tracer.end(tok, k=k)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads) and not errs
    # sample=2 drops exactly half of each name's begins (the increment is
    # under the lock, so it is exact under contention).
    assert tel.tracer.dropped == n_threads * n_iter // 2
    total = sum(tel.registry.get_counter("odl_test_total", tenant=str(k))
                for k in range(n_threads))
    assert total == n_threads * n_iter
    assert lockdebug.GRAPH.held_stack() == []


def test_one_variable_two_graphs(lock_debug):
    """``REPRO_LOCK_DEBUG=1`` turns on both packages' checkers, and each
    records into its own graph: the port's order never trips the
    reference's detector, nor the other way round."""
    from repro.runtime import lockdebug as ref_lockdebug

    ref_lockdebug.GRAPH.clear()
    try:
        a, b = lockdebug.make_lock("A"), lockdebug.make_lock("B")
        ra, rb = ref_lockdebug.make_lock("A"), ref_lockdebug.make_lock("B")
        assert isinstance(ra, ref_lockdebug._TrackedLock)
        with a:
            with b:
                pass
        with rb:
            with ra:  # the opposite order, in the other package: no cycle
                pass
        assert lockdebug.GRAPH.edges() == {"A": {"B"}}
        assert ref_lockdebug.GRAPH.edges() == {"B": {"A"}}
        assert lockdebug.GRAPH is not ref_lockdebug.GRAPH
    finally:
        ref_lockdebug.GRAPH.clear()
