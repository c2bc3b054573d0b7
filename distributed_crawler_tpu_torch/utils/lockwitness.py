"""Runtime lock-order witness — the race-detector half of crawlint.

The port's copy of the reference's `distributed_crawler_tpu/utils/
lockwitness.py`: the same graph, findings, gauges, report schema and
switches, keyed on this package's own files.

- **Creation-site interposition.**  :func:`install` replaces
  ``threading.Lock/RLock/Condition`` with factories that inspect the
  *caller's* frame: locks created by files under
  ``distributed_crawler_tpu_torch/`` come back wrapped in a witness proxy;
  everything else (stdlib, torch, tests, the reference package) gets the
  original object.  Nothing is patched until install() runs, so the off
  path is exactly zero overhead.
- **Lock-order graph.**  Each proxy is keyed by its creation site
  (``file.py:line``).  On every acquire the witness records an edge
  held-site → acquired-site for each lock the thread already holds,
  with both witness stacks captured on the edge's first occurrence.  A
  new edge that closes a directed cycle is a potential deadlock
  (LKW001).
- **Blocking-under-lock.**  ``time.sleep``, ``Thread.join``,
  ``subprocess.Popen.wait``, ``queue.Queue.get``, ``socket.recv/accept``
  and ``Condition.wait`` on a *different* lock record a finding (LKW002)
  when called with an instrumented lock held.
- **Hold-time accounting.**  Per-site count/total/max hold times; a
  budget (``CRAWLINT_LOCKWITNESS_BUDGET_MS``) turns outliers into
  LKW003 breaches.  All three surface as ``lockwitness_*`` gauges.

**Two witnesses in one process.**  The reference's witness patches the
same callables.  Whichever installs first, this one places itself
*beneath* the other: when a callable is already a witness wrapper of
this design, it wraps the original under that wrapper's chain (the
wrapper's inner reference and its saved original both point at this
witness's wrapper), so the other witness's ``uninstall`` restores this
one, not the bare original, and this ``uninstall`` splices itself out
without dropping the other's patch.  Its factories skip the other
witness's factory frames when they look for the creating caller.

Enable with ``CRAWLINT_LOCKWITNESS=1`` (read by :func:`env_enabled`) or
the ``forbid_lock_cycles`` gate key (`loadgen/gate.py`).  Findings dump
as JSON (:meth:`LockWitness.dump`, env ``CRAWLINT_LOCKWITNESS_OUT``) in
the reference's schema, rendered by ``python -m tools.analyze
--lock-report <file>``.

Witness internals use raw ``_thread.allocate_lock()`` plus a thread-local
reentrancy guard: the metrics registry's own locks are instrumented too,
and the witness must never recurse through itself while recording them.

Selfcheck::

    python -m distributed_crawler_tpu_torch.utils.lockwitness --selfcheck
"""

from __future__ import annotations

import _thread
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("dct.lockwitness")

REPORT_SCHEMA_VERSION = 1

# Package root: locks created by files under this directory get witnessed.
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)

_STACK_LIMIT = 12           # frames kept per witness stack
_MAX_FINDINGS = 200         # bound per finding list (blocking/breaches)


def _site_of(frame) -> str:
    """repo-relative ``file.py:line`` for a creation/acquire frame."""
    fn = frame.f_code.co_filename
    try:
        rel = os.path.relpath(fn, _REPO_DIR)
    except ValueError:      # different drive (windows) — keep absolute
        rel = fn
    return f"{rel.replace(os.sep, '/')}:{frame.f_lineno}"


def _in_package(frame) -> bool:
    fn = frame.f_code.co_filename
    return fn.startswith(_PKG_DIR + os.sep) or fn == __file__


def _creator(frame):
    """The frame that asked for a lock: ``frame`` itself, or, when another
    witness's factory sits between the caller and this one, the frame
    above that factory."""
    while frame is not None and frame.f_code.co_name == "factory" \
            and frame.f_code.co_filename != __file__ \
            and os.path.basename(frame.f_code.co_filename) \
            == "lockwitness.py":
        frame = frame.f_back
    return frame


def _wrapped_by(fn) -> Optional[Tuple[Any, Any]]:
    """``(cell, witness)`` when ``fn`` is a witness wrapper of this
    module's design (this one's or the reference's): the closure cell that
    holds the callable it wraps, and the witness that made it."""
    code = getattr(fn, "__code__", None)
    cells = getattr(fn, "__closure__", None)
    if code is None or not cells:
        return None
    cellmap = dict(zip(code.co_freevars, cells))
    inner = cellmap.get("ctor") or cellmap.get("fn")
    owner = cellmap.get("witness")
    if inner is None or owner is None:
        return None
    try:
        witness = owner.cell_contents
    except ValueError:
        return None
    if not isinstance(getattr(witness, "_originals", None), dict):
        return None
    return inner, witness


def _patch_points() -> List[Tuple[str, Any, str]]:
    """(key, owner, attribute) of every callable the witness patches; the
    keys are the reference's ``_originals`` keys."""
    import queue
    import socket
    import subprocess

    return [("Lock", threading, "Lock"), ("RLock", threading, "RLock"),
            ("Condition", threading, "Condition"),
            ("time.sleep", time, "sleep"),
            ("Thread.join", threading.Thread, "join"),
            ("Queue.get", queue.Queue, "get"),
            ("Popen.wait", subprocess.Popen, "wait"),
            ("socket.recv", socket.socket, "recv"),
            ("socket.accept", socket.socket, "accept")]


def _stack_of(frame) -> List[str]:
    """Formatted witness stack (innermost last), bounded."""
    summary = traceback.extract_stack(frame, limit=_STACK_LIMIT)
    return [ln.rstrip() for ln in traceback.format_list(summary)]


class _Held:
    """One (lock, thread) hold: identity, site, reentry count, frame."""

    __slots__ = ("ident", "site", "count", "t0", "frame")

    def __init__(self, ident: int, site: str, frame) -> None:
        self.ident = ident
        self.site = site
        self.count = 1
        self.t0 = time.monotonic()
        self.frame = frame      # acquire frame, for lazy stack capture


class LockWitness:
    """Global lock-order graph + blocking/hold-time findings."""

    def __init__(self) -> None:
        self._mu = _thread.allocate_lock()   # NEVER an instrumented lock
        self._tl = threading.local()
        self._enabled = False
        self._originals: Dict[str, Any] = {}
        self._patched: Dict[str, Any] = {}
        self._budget_s: Optional[float] = None
        self._sites: Dict[str, int] = {}     # creation site -> locks made
        # (held_site, acquired_site) -> witness record
        self._edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._adj: Dict[str, set] = {}       # site -> successor sites
        self._cycles: List[Dict[str, Any]] = []
        self._cycle_keys: set = set()
        self._blocking: List[Dict[str, Any]] = []
        self._breaches: List[Dict[str, Any]] = []
        self._hold: Dict[str, List[float]] = {}  # site -> [n, total, max]
        self._acquisitions = 0

    # -- state -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def cycle_count(self) -> int:
        return len(self._cycles)

    def blocking_count(self) -> int:
        return len(self._blocking)

    def breach_count(self) -> int:
        return len(self._breaches)

    def _held_list(self) -> List[_Held]:
        held = getattr(self._tl, "held", None)
        if held is None:
            held = self._tl.held = []
        return held

    def _guarded(self) -> bool:
        """True while this thread is already inside witness bookkeeping
        (or bookkeeping is being entered now) — nested acquires by the
        witness itself (e.g. the metrics histogram's own instrumented
        lock) must pass through unrecorded."""
        return getattr(self._tl, "busy", False)

    # -- install / uninstall ----------------------------------------------

    def install(self, budget_s: Optional[float] = None) -> None:
        """Patch the threading constructors + blocking calls, beneath any
        witness already installed.  Idempotent."""
        if self._enabled:
            if budget_s is not None:
                self._budget_s = budget_s
            return
        if budget_s is not None:
            self._budget_s = budget_s
        elif self._budget_s is None:
            ms = os.environ.get("CRAWLINT_LOCKWITNESS_BUDGET_MS", "")
            try:
                self._budget_s = float(ms) / 1000.0 if ms else None
            except ValueError:
                self._budget_s = None
        self._originals = {}
        self._patched: Dict[str, Any] = {}
        for key, owner, attr in _patch_points():
            current = getattr(owner, attr)
            above = None            # the lowest other witness's wrapper
            while True:
                found = _wrapped_by(current)
                if found is None or found[1] is self:
                    break
                above = found
                current = found[0].cell_contents
            ours = self._make_patch(key, current)
            self._originals[key] = current
            self._patched[key] = ours
            if above is None:
                setattr(owner, attr, ours)
            else:
                cell, other = above
                cell.cell_contents = ours
                if key in other._originals:
                    other._originals[key] = ours
        self._enabled = True
        self._register_metrics()

    def _make_patch(self, key: str, original):
        if key in ("Lock", "RLock"):
            return self._lock_factory(original, key)
        if key == "Condition":
            return self._condition_factory(original)
        return self._blocking_wrapper(original, key)

    def uninstall(self) -> None:
        """Restore every patched callable: put the original back where
        this witness's wrapper is the attribute, or splice the wrapper out
        from under the witness installed above it.  Existing proxies keep
        working (they delegate) but stop recording."""
        if not self._enabled:
            return
        self._enabled = False
        for key, owner, attr in _patch_points():
            ours = self._patched.get(key)
            original = self._originals.get(key)
            if ours is None:
                continue
            current = getattr(owner, attr)
            if current is ours:
                setattr(owner, attr, original)
                continue
            while True:
                found = _wrapped_by(current)
                if found is None:
                    break           # already dropped by another witness
                cell, other = found
                if cell.cell_contents is ours:
                    cell.cell_contents = original
                    if other._originals.get(key) is ours:
                        other._originals[key] = original
                    break
                current = cell.cell_contents
        self._originals = {}
        self._patched = {}

    def _register_metrics(self) -> None:
        """Expose counts as lockwitness_* compute-at-read gauges.  Late
        import: metrics' own module-level locks must already exist (they
        are created at metrics import, possibly pre-install, which is
        fine — only locks created AFTER install are witnessed)."""
        try:
            from .metrics import REGISTRY
            REGISTRY.gauge(
                "lockwitness_cycles",
                "lock-order cycles (potential deadlocks) witnessed by the "
                "runtime lock witness").set_fn(self.cycle_count)
            REGISTRY.gauge(
                "lockwitness_blocking_under_lock",
                "blocking calls observed while holding an instrumented "
                "lock").set_fn(self.blocking_count)
            REGISTRY.gauge(
                "lockwitness_hold_budget_breaches",
                "lock holds exceeding CRAWLINT_LOCKWITNESS_BUDGET_MS"
            ).set_fn(self.breach_count)
            REGISTRY.gauge(
                "lockwitness_instrumented_sites",
                "distinct lock creation sites under witness"
            ).set_fn(lambda: len(self._sites))
        except Exception as e:
            # Metrics unavailable: the witness still records.
            logger.debug("lockwitness: metrics gauges not registered: %s",
                         e)

    # -- factories ---------------------------------------------------------

    def _lock_factory(self, ctor, kind: str):
        witness = self

        def factory(*args, **kwargs):
            inner = ctor(*args, **kwargs)
            frame = _creator(sys._getframe(1))
            if not witness._enabled or frame is None \
                    or not _in_package(frame):
                return inner
            site = _site_of(frame)
            with witness._mu:
                witness._sites[site] = witness._sites.get(site, 0) + 1
            return _WitnessLock(inner, site, witness)

        factory.__name__ = kind
        return factory

    def _condition_factory(self, ctor):
        witness = self

        def factory(lock=None):
            frame = _creator(sys._getframe(1))
            if lock is not None and isinstance(lock, _WitnessLock):
                # Share the wrapped lock's witness identity: `with lock:`
                # and `with cond:` are the same underlying mutex and must
                # be one graph node, not an artificial AB pair.
                inner = ctor(lock._inner)
                return _WitnessCondition(inner, lock._site, witness,
                                         id(lock._inner))
            inner = ctor(lock)
            if not witness._enabled or frame is None \
                    or not _in_package(frame):
                return inner
            site = _site_of(frame)
            with witness._mu:
                witness._sites[site] = witness._sites.get(site, 0) + 1
            return _WitnessCondition(inner, site, witness,
                                     id(getattr(inner, "_lock", inner)))

        factory.__name__ = "Condition"
        return factory

    def _blocking_wrapper(self, fn, label: str):
        witness = self

        def wrapper(*args, **kwargs):
            witness._note_blocking(label)
            return fn(*args, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", label)
        wrapper.__wrapped__ = fn
        return wrapper

    # -- bookkeeping -------------------------------------------------------

    def _on_acquire(self, ident: int, site: str, frame) -> None:
        if not self._enabled or self._guarded():
            return
        self._tl.busy = True
        try:
            held = self._held_list()
            for h in held:
                if h.ident == ident:
                    h.count += 1        # RLock reentry: no new edge
                    return
            if held:
                self._record_edges(held, site, frame)
            entry = _Held(ident, site, frame)
            # Unlocked: a GIL race can drop a count, which is fine for a
            # diagnostic — taking the global mutex HERE would serialize
            # every lock acquisition in the process through one lock and
            # measurably perturb the SLO-gated scenarios the witness is
            # meant to observe.
            self._acquisitions += 1
            held.append(entry)
        finally:
            self._tl.busy = False

    def _on_release(self, ident: int) -> None:
        if self._guarded():
            return
        self._tl.busy = True
        try:
            held = self._held_list()
            for i in range(len(held) - 1, -1, -1):
                h = held[i]
                if h.ident != ident:
                    continue
                h.count -= 1
                if h.count > 0:
                    return
                held.pop(i)
                h.frame = None
                dur = time.monotonic() - h.t0
                # Aggregate updates are unlocked on purpose (see
                # _on_acquire): GIL races can lose a sample, never
                # corrupt the [count, total, max] shape.  Only the
                # first-seen-site insert and the (rare) breach append
                # take the mutex.
                agg = self._hold.get(h.site)
                if agg is None:
                    with self._mu:
                        agg = self._hold.setdefault(h.site,
                                                    [0, 0.0, 0.0])
                agg[0] += 1
                agg[1] += dur
                if dur > agg[2]:
                    agg[2] = dur
                if self._budget_s is not None and dur > self._budget_s:
                    with self._mu:
                        if len(self._breaches) < _MAX_FINDINGS:
                            self._breaches.append({
                                "site": h.site,
                                "held_s": round(dur, 6),
                                "budget_s": self._budget_s,
                                "thread":
                                    threading.current_thread().name,
                            })
                return
        finally:
            self._tl.busy = False

    def _record_edges(self, held: List[_Held], site: str, frame) -> None:
        """Add held→acquired edges; a new edge closing a directed cycle
        is a potential deadlock.  Caller already holds the reentrancy
        guard; the graph mutates under the raw mutex."""
        thread = threading.current_thread().name
        for h in held:
            if h.site == site:
                # Same creation site (reentry is filtered earlier, so
                # this is a different instance — e.g. two shard locks
                # from one constructor line).  Ordering within one
                # site is invisible to a site-keyed graph; skip
                # rather than fabricate a self-cycle.
                continue
            key = (h.site, site)
            # Fast path unlocked: after warm-up every nested acquire is
            # a known edge, and a GIL-raced count bump only loses a
            # diagnostic tick.  Graph MUTATION stays under the mutex.
            rec = self._edges.get(key)
            if rec is not None:
                rec["count"] += 1
                continue
            with self._mu:
                rec = self._edges.get(key)
                if rec is not None:
                    rec["count"] += 1
                    continue
                self._edges[key] = {
                    "held_site": h.site,
                    "acquire_site": site,
                    "thread": thread,
                    "count": 1,
                    "held_stack": _stack_of(h.frame) if h.frame else [],
                    "acquire_stack": _stack_of(frame),
                }
                self._adj.setdefault(h.site, set()).add(site)
                self._check_cycle(h.site, site)

    def _check_cycle(self, a: str, b: str) -> None:
        """After adding a→b: a path b→…→a in the existing graph closes a
        cycle.  BFS under self._mu (edge count is small)."""
        if a == b:
            return
        prev: Dict[str, str] = {b: b}
        queue = [b]
        while queue:
            cur = queue.pop(0)
            if cur == a:
                break
            for nxt in self._adj.get(cur, ()):
                if nxt not in prev:
                    prev[nxt] = cur
                    queue.append(nxt)
        if a not in prev:
            return
        # Reconstruct b → … → a, then close with the new edge a → b.
        path = [a]
        while path[-1] != b:
            path.append(prev[path[-1]])
        path.reverse()                       # [b, …, a]
        sites = [a] + path                   # a → b → … → a
        key = frozenset(sites)
        if key in self._cycle_keys:
            return
        self._cycle_keys.add(key)
        edges = []
        for x, y in zip(sites, sites[1:]):
            rec = self._edges.get((x, y))
            if rec:
                edges.append(dict(rec))
        self._cycles.append({
            "sites": sites,
            "threads": sorted({e["thread"] for e in edges}),
            "edges": edges,
        })

    def _note_blocking(self, label: str) -> None:
        if not self._enabled or self._guarded():
            return
        held = getattr(self._tl, "held", None)
        if not held:
            return
        self._tl.busy = True
        try:
            try:
                # 0=_note_blocking, 1=wrapper/wait, 2=the blocking caller.
                frame = sys._getframe(2)
            except ValueError:
                frame = sys._getframe(1)
            with self._mu:
                if len(self._blocking) >= _MAX_FINDINGS:
                    return
                self._blocking.append({
                    "call": label,
                    "held_sites": [h.site for h in held],
                    "held_s": round(time.monotonic() - held[0].t0, 6),
                    "thread": threading.current_thread().name,
                    "stack": _stack_of(frame),
                })
        finally:
            self._tl.busy = False

    # -- reporting ---------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """JSON-ready snapshot (`tools/analyze --lock-report` input)."""
        with self._mu:
            hold = {
                site: {"count": int(agg[0]),
                       "total_s": round(agg[1], 6),
                       "max_s": round(agg[2], 6)}
                for site, agg in sorted(self._hold.items())
            }
            return {
                "schema_version": REPORT_SCHEMA_VERSION,
                "enabled": self._enabled,
                "budget_s": self._budget_s,
                "instrumented_sites": len(self._sites),
                "acquisitions": self._acquisitions,
                "edge_count": len(self._edges),
                "cycle_count": len(self._cycles),
                "blocking_count": len(self._blocking),
                "breach_count": len(self._breaches),
                "cycles": [dict(c) for c in self._cycles],
                "blocking": [dict(b) for b in self._blocking],
                "breaches": [dict(b) for b in self._breaches],
                "hold": hold,
            }

    def dump(self, path: str) -> None:
        """Atomic JSON dump (tmp + fsync + rename — the ATM discipline)."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def summary_line(self) -> str:
        return (f"lockwitness: {len(self._sites)} sites, "
                f"{self._acquisitions} acquisitions, "
                f"{len(self._edges)} edges, "
                f"{len(self._cycles)} cycle(s), "
                f"{len(self._blocking)} blocking-under-lock, "
                f"{len(self._breaches)} budget breach(es)")


class _WitnessLock:
    """Proxy around a real Lock/RLock: records acquire/release into the
    witness, delegates everything else."""

    __slots__ = ("_inner", "_site", "_witness")

    def __init__(self, inner, site: str, witness: LockWitness) -> None:
        self._inner = inner
        self._site = site
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness._on_acquire(id(self._inner), self._site,
                                      sys._getframe(1))
        return ok

    def release(self):
        self._witness._on_release(id(self._inner))
        return self._inner.release()

    def __enter__(self):
        self._inner.acquire()
        self._witness._on_acquire(id(self._inner), self._site,
                                  sys._getframe(1))
        return self

    def __exit__(self, exc_type, exc, tb):
        self._witness._on_release(id(self._inner))
        self._inner.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<WitnessLock {self._site} {self._inner!r}>"


class _WitnessCondition:
    """Proxy around a real Condition sharing the witness identity of its
    underlying mutex.  ``wait`` keeps the held marker (lock order is
    about program structure: code after wait still runs under the lock)
    and records blocking when OTHER witnessed locks are held."""

    __slots__ = ("_cond", "_site", "_witness", "_ident")

    def __init__(self, cond, site: str, witness: LockWitness,
                 ident: int) -> None:
        self._cond = cond
        self._site = site
        self._witness = witness
        self._ident = ident

    def acquire(self, *args, **kwargs):
        ok = self._cond.acquire(*args, **kwargs)
        if ok:
            self._witness._on_acquire(self._ident, self._site,
                                      sys._getframe(1))
        return ok

    def release(self):
        self._witness._on_release(self._ident)
        return self._cond.release()

    def __enter__(self):
        self._cond.acquire()
        self._witness._on_acquire(self._ident, self._site,
                                  sys._getframe(1))
        return self

    def __exit__(self, exc_type, exc, tb):
        self._witness._on_release(self._ident)
        return self._cond.__exit__(exc_type, exc, tb)

    def wait(self, timeout: Optional[float] = None):
        w = self._witness
        held = getattr(w._tl, "held", None) or []
        if w._enabled and any(h.ident != self._ident for h in held):
            w._note_blocking(f"Condition.wait[{self._site}]")
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        w = self._witness
        held = getattr(w._tl, "held", None) or []
        if w._enabled and any(h.ident != self._ident for h in held):
            w._note_blocking(f"Condition.wait_for[{self._site}]")
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        return self._cond.notify(n)

    def notify_all(self):
        return self._cond.notify_all()

    def __getattr__(self, name):
        return getattr(self._cond, name)

    def __repr__(self):
        return f"<WitnessCondition {self._site} {self._cond!r}>"


#: Process-wide witness.  The gate runner and the selfcheck install into
#: the same instance — one graph per process.
WITNESS = LockWitness()


def install(budget_s: Optional[float] = None) -> None:
    WITNESS.install(budget_s=budget_s)


def uninstall() -> None:
    WITNESS.uninstall()


def enabled() -> bool:
    return WITNESS.enabled


def env_enabled() -> bool:
    return os.environ.get("CRAWLINT_LOCKWITNESS", "") == "1"


# -- witnessed-lock fabrication seams ---------------------------------------
# The factories only wrap locks CREATED inside the package tree; test
# code and `python -c` probes live outside it, so these helpers exist to
# mint witnessed locks on their behalf (the selfcheck uses them too).
# Pass a distinct ``label`` per lock: the graph is keyed by creation
# site, and every call through one helper shares this file's line, so
# unlabeled fabricated locks would collapse into a single node (and
# same-site edges are deliberately skipped).

def _relabel(obj, label: Optional[str]):
    if label is None \
            or not isinstance(obj, (_WitnessLock, _WitnessCondition)):
        return obj
    w = obj._witness
    with w._mu:
        old = obj._site
        n = w._sites.get(old, 0) - 1
        if n > 0:
            w._sites[old] = n
        else:
            w._sites.pop(old, None)
        w._sites[label] = w._sites.get(label, 0) + 1
    obj._site = label
    return obj


def make_lock(label: Optional[str] = None):
    return _relabel(threading.Lock(), label)


def make_rlock(label: Optional[str] = None):
    return _relabel(threading.RLock(), label)


def make_condition(lock=None, label: Optional[str] = None):
    return _relabel(threading.Condition(lock), label)


# ---------------------------------------------------------------------------
# selfcheck
# ---------------------------------------------------------------------------

def _selfcheck() -> int:
    """Prove the detector fires: a two-thread AB/BA inversion must yield
    exactly one cycle with both witness stacks, a sleep under lock must
    yield a blocking finding, and a consistently-ordered nested pair must
    add no cycle.  Exit 0 on pass."""
    install()
    # make_lock creations happen inside the package (this file), so the
    # factories wrap them; labels keep the four locks distinct graph
    # nodes (one shared helper line would otherwise be one site).
    lock_a = make_lock("selfcheck:a")
    lock_b = make_lock("selfcheck:b")
    lock_c = make_lock("selfcheck:c")
    lock_d = make_lock("selfcheck:d")
    assert isinstance(lock_a, _WitnessLock), \
        "factory did not wrap a package-created lock"

    def ordered(first, second):
        with first:
            with second:
                pass

    t1 = threading.Thread(target=ordered, args=(lock_a, lock_b),
                          name="witness-ab")
    t1.start()
    t1.join()
    t2 = threading.Thread(target=ordered, args=(lock_b, lock_a),
                          name="witness-ba")
    t2.start()
    t2.join()
    rep = WITNESS.report()
    ok = True
    if rep["cycle_count"] != 1:
        print(f"selfcheck FAILED: expected 1 cycle, got "
              f"{rep['cycle_count']}", file=sys.stderr)
        ok = False
    else:
        cyc = rep["cycles"][0]
        if not all(e["held_stack"] and e["acquire_stack"]
                   for e in cyc["edges"]):
            print("selfcheck FAILED: cycle edges missing witness stacks",
                  file=sys.stderr)
            ok = False
    before_blocking = WITNESS.blocking_count()
    with lock_c:
        time.sleep(0.01)
    if WITNESS.blocking_count() != before_blocking + 1:
        print("selfcheck FAILED: sleep-under-lock not recorded",
              file=sys.stderr)
        ok = False
    before_cycles = WITNESS.cycle_count()
    for _ in range(2):
        ordered(lock_c, lock_d)     # consistent order: never a cycle
    if WITNESS.cycle_count() != before_cycles:
        print("selfcheck FAILED: consistent nesting produced a cycle",
              file=sys.stderr)
        ok = False
    out = os.environ.get("CRAWLINT_LOCKWITNESS_OUT", "")
    if out:
        WITNESS.dump(out)
    print(WITNESS.summary_line() + (" [selfcheck OK]" if ok else ""))
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--selfcheck" in argv:
        return _selfcheck()
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
