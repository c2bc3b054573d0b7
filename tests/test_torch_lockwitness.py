"""The port's runtime lock-order witness
(`distributed_crawler_tpu_torch/utils/lockwitness.py`) against the
reference's `tests/test_lockwitness.py`, plus what only the port needs:

- the reference's cases (cycles, blocking, hold budgets, uninstall, the
  off path, the dump rendered by ``tools.analyze --lock-report``, the
  selfcheck), on the port's module;
- the witness wraps the locks the port's own files create, and only
  those: not the reference package's, not a caller's;
- two witnesses in one process: whichever package installs first, and
  whichever uninstalls first, each wraps its own package's locks while it
  is installed, and both uninstalled leave every patched callable the
  original.

Every probe runs in a subprocess: installing patches process-global
constructors (``threading.Lock`` and friends), which this suite must not
leave behind in its own interpreter.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROLOGUE = """
    import json
    import sys
    import threading
    import time

    from distributed_crawler_tpu_torch.utils import lockwitness as lw
"""


def probe(script, env_extra=None):
    """Run a witness scenario in a fresh interpreter; return its last
    stdout line parsed as JSON."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    for k in ("CRAWLINT_LOCKWITNESS", "CRAWLINT_LOCKWITNESS_STRICT",
              "CRAWLINT_LOCKWITNESS_OUT", "CRAWLINT_LOCKWITNESS_BUDGET_MS"):
        env.pop(k, None)
    env.update(env_extra or {})
    src = textwrap.dedent(PROLOGUE) + textwrap.dedent(script)
    proc = subprocess.run([sys.executable, "-c", src], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


class TestCycleDetection:
    def test_ab_ba_inversion_yields_one_cycle_with_both_stacks(self):
        rep = probe("""
            lw.install()
            a = lw.make_lock("probe:a")
            b = lw.make_lock("probe:b")

            def ordered(first, second):
                with first:
                    with second:
                        pass

            t1 = threading.Thread(target=ordered, args=(a, b), name="t-ab")
            t1.start(); t1.join()
            t2 = threading.Thread(target=ordered, args=(b, a), name="t-ba")
            t2.start(); t2.join()
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["cycle_count"] == 1
        cyc = rep["cycles"][0]
        assert set(cyc["sites"]) == {"probe:a", "probe:b"}
        assert sorted(cyc["threads"]) == ["t-ab", "t-ba"]
        assert len(cyc["edges"]) == 2
        for edge in cyc["edges"]:
            assert edge["held_stack"], edge
            assert edge["acquire_stack"], edge
        assert rep["edge_count"] == 2

    def test_clean_nested_run_zero_findings(self):
        rep = probe("""
            lw.install()
            outer = lw.make_lock("probe:outer")
            inner = lw.make_lock("probe:inner")

            def worker():
                for _ in range(50):
                    with outer:
                        with inner:
                            pass

            ts = [threading.Thread(target=worker) for _ in range(4)]
            for t in ts: t.start()
            for t in ts: t.join()
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["cycle_count"] == 0
        assert rep["blocking_count"] == 0
        assert rep["breach_count"] == 0
        assert rep["edge_count"] == 1
        assert rep["acquisitions"] >= 400

    def test_rlock_reentry_is_not_an_edge(self):
        rep = probe("""
            lw.install()
            r = lw.make_rlock("probe:r")
            with r:
                with r:
                    pass
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["edge_count"] == 0
        assert rep["cycle_count"] == 0

    def test_three_lock_transitive_cycle(self):
        rep = probe("""
            lw.install()
            a = lw.make_lock("probe:a")
            b = lw.make_lock("probe:b")
            c = lw.make_lock("probe:c")

            def pair(first, second):
                with first:
                    with second:
                        pass

            for args in ((a, b), (b, c), (c, a)):
                t = threading.Thread(target=pair, args=args)
                t.start(); t.join()
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["cycle_count"] == 1
        assert set(rep["cycles"][0]["sites"]) == \
            {"probe:a", "probe:b", "probe:c"}

    def test_condition_shares_its_locks_node(self):
        rep = probe("""
            lw.install()
            a = lw.make_lock("probe:a")
            cond = lw.make_condition(a)
            b = lw.make_lock("probe:b")
            with cond:
                with b:
                    pass
            with b:
                with a:
                    pass
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["cycle_count"] == 1
        assert set(rep["cycles"][0]["sites"]) == {"probe:a", "probe:b"}


class TestBlockingAndBudget:
    def test_sleep_under_lock_recorded_with_stack(self):
        rep = probe("""
            lw.install()
            a = lw.make_lock("probe:a")
            with a:
                time.sleep(0.01)
            time.sleep(0.01)    # no lock held: not a finding
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["blocking_count"] == 1
        b = rep["blocking"][0]
        assert b["call"] == "time.sleep"
        assert b["held_sites"] == ["probe:a"]
        assert b["stack"]

    def test_hold_budget_breach(self):
        rep = probe("""
            lw.install(budget_s=0.005)
            a = lw.make_lock("probe:a")
            with a:
                t0 = time.monotonic()
                while time.monotonic() - t0 < 0.02:
                    pass
            print(json.dumps(lw.WITNESS.report()))
        """)
        assert rep["breach_count"] == 1
        assert rep["breaches"][0]["site"] == "probe:a"
        assert rep["breaches"][0]["held_s"] > 0.005
        assert rep["blocking_count"] == 0

    def test_budget_from_the_environment(self):
        rep = probe("""
            lw.install()
            print(json.dumps(lw.WITNESS.report()))
        """, env_extra={"CRAWLINT_LOCKWITNESS_BUDGET_MS": "25"})
        assert rep["budget_s"] == 0.025


class TestOverheadOffAndUninstall:
    def test_not_installed_is_a_noop(self):
        rep = probe("""
            orig = threading.Lock
            lock = lw.make_lock("probe:off")
            with lock:
                pass
            print(json.dumps({"proxy": isinstance(lock, lw._WitnessLock),
                              "patched": threading.Lock is not orig,
                              "acquisitions":
                                  lw.WITNESS.report()["acquisitions"]}))
        """)
        assert rep == {"proxy": False, "patched": False, "acquisitions": 0}

    def test_uninstall_restores_constructors(self):
        rep = probe("""
            orig_lock = threading.Lock
            lw.install()
            assert threading.Lock is not orig_lock
            wrapped = lw.make_lock("probe:w")
            lw.uninstall()
            assert threading.Lock is orig_lock
            bare = lw.make_lock()
            acqs0 = lw.WITNESS.report()["acquisitions"]
            with wrapped:
                pass
            with bare:
                pass
            rep = lw.WITNESS.report()
            print(json.dumps({
                "enabled": rep["enabled"],
                "bare_is_proxy": isinstance(bare, lw._WitnessLock),
                "acquisitions_delta": rep["acquisitions"] - acqs0,
            }))
        """)
        assert rep == {"enabled": False, "bare_is_proxy": False,
                       "acquisitions_delta": 0}

    def test_only_the_ports_files_are_witnessed(self):
        """A port module's locks are proxies keyed by the port's files; a
        caller's and the reference package's are not."""
        rep = probe("""
            lw.install()
            from distributed_crawler_tpu_torch.bus.inmemory import InMemoryBus
            from distributed_crawler_tpu.bus.inmemory import (
                InMemoryBus as RefBus)
            here = threading.Lock()
            before = set(lw.WITNESS._sites)
            InMemoryBus()
            port_sites = set(lw.WITNESS._sites) - before
            before = set(lw.WITNESS._sites)
            RefBus()
            print(json.dumps({
                "here": isinstance(here, lw._WitnessLock),
                "port_sites": sorted(port_sites),
                "ref_sites": sorted(set(lw.WITNESS._sites) - before),
            }))
        """)
        assert rep["here"] is False
        assert rep["port_sites"]
        assert all(s.startswith("distributed_crawler_tpu_torch/bus/")
                   for s in rep["port_sites"])
        assert rep["ref_sites"] == []


STACK_PROBE = """
    import itertools
    from distributed_crawler_tpu.utils import lockwitness as rw

    W = {"port": lw, "ref": rw}
    originals = {k: getattr(o, a) for k, o, a in lw._patch_points()}

    def wrapped_by(mod):
        # which witnesses wrap a lock / condition this module creates
        lock, cond = mod.make_lock(), mod.make_condition()
        return sorted(name for name, w in W.items()
                      if isinstance(lock, w._WitnessLock)
                      and isinstance(cond, w._WitnessCondition))

    first, second, un1, un2 = sys.argv[1:5]
    W[first].install()
    W[second].install()
    both = {name: wrapped_by(m) for name, m in W.items()}
    here = threading.Lock()
    blocking0 = (lw.WITNESS.blocking_count(), rw.WITNESS.blocking_count())
    with lw.make_lock():
        time.sleep(0.001)
    blocking = (lw.WITNESS.blocking_count() - blocking0[0],
                rw.WITNESS.blocking_count() - blocking0[1])
    W[un1].uninstall()
    after_one = {name: wrapped_by(m) for name, m in W.items()}
    W[un2].uninstall()
    restored = {k: getattr(o, a) for k, o, a in lw._patch_points()} \\
        == originals
    print(json.dumps({"both": both, "after_one": after_one,
                      "here": isinstance(here, (lw._WitnessLock,
                                                rw._WitnessLock)),
                      "blocking": blocking, "restored": restored,
                      "same_report_keys": set(lw.WITNESS.report())
                      == set(rw.WITNESS.report())}))
"""


@pytest.mark.parametrize("first", ["port", "ref"])
@pytest.mark.parametrize("uninstall_first", ["port", "ref"])
def test_two_witnesses_in_one_process(first, uninstall_first):
    """Either install order, either uninstall order: each witness wraps
    its own package's locks only, sleeps under the port's lock are the
    port's finding only, and both uninstalled restore every callable."""
    second = "ref" if first == "port" else "port"
    un2 = "ref" if uninstall_first == "port" else "port"
    env = {**os.environ, "PYTHONPATH": REPO}
    src = textwrap.dedent(PROLOGUE) + textwrap.dedent(STACK_PROBE)
    proc = subprocess.run(
        [sys.executable, "-c", src, first, second, uninstall_first, un2],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout.splitlines()[-1])
    assert rep["both"] == {"port": ["port"], "ref": ["ref"]}
    assert rep["after_one"] == {uninstall_first: [], un2: [un2]}
    assert rep["here"] is False
    assert rep["blocking"] == [1, 0]
    assert rep["restored"] is True
    assert rep["same_report_keys"] is True


class TestReportPipeline:
    def test_port_dump_renders_through_analyze_lock_report(self, tmp_path):
        out = tmp_path / "lockwitness.json"
        probe("""
            import os
            lw.install()
            a = lw.make_lock("pkg/x.py:1")
            b = lw.make_lock("pkg/y.py:2")

            def ordered(first, second):
                with first:
                    with second:
                        pass

            t1 = threading.Thread(target=ordered, args=(a, b))
            t1.start(); t1.join()
            t2 = threading.Thread(target=ordered, args=(b, a))
            t2.start(); t2.join()
            with a:
                time.sleep(0.001)
            lw.WITNESS.dump(os.environ["WITNESS_OUT"])
            print(json.dumps({"ok": True}))
        """, env_extra={"WITNESS_OUT": str(out)})
        assert json.loads(out.read_text())["schema_version"] == 1
        proc = subprocess.run(
            [sys.executable, "-m", "tools.analyze", "--lock-report",
             str(out), "--no-baseline", "--json"],
            cwd=REPO, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 1     # the cycle is a new finding
        rendered = json.loads(proc.stdout)
        assert [f["code"] for f in rendered["findings"]] == \
            ["LKW001", "LKW002"]

    def test_dump_schema_is_the_references(self, tmp_path):
        rep = probe("""
            from distributed_crawler_tpu.utils import lockwitness as rw
            lw.install(budget_s=0.001)
            rw.install(budget_s=0.001)
            for w in (lw, rw):
                a, b = w.make_lock("s:a"), w.make_lock("s:b")
                with a:
                    with b:
                        time.sleep(0.002)
                with b:
                    with a:
                        pass
            p, r = lw.WITNESS.report(), rw.WITNESS.report()
            same = {k: p[k] == r[k] for k in (
                "schema_version", "edge_count", "cycle_count",
                "blocking_count", "breach_count", "instrumented_sites")}
            print(json.dumps({"keys": sorted(p) == sorted(r),
                              "same": same,
                              "summary": lw.WITNESS.summary_line()}))
        """)
        assert rep["keys"] is True
        assert all(rep["same"].values()), rep["same"]
        assert rep["summary"].startswith("lockwitness: ")
        assert "1 cycle(s), 1 blocking-under-lock" in rep["summary"]

    def test_selfcheck_cli(self):
        proc = subprocess.run(
            [sys.executable, "-m",
             "distributed_crawler_tpu_torch.utils.lockwitness",
             "--selfcheck"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "[selfcheck OK]" in proc.stdout

    def test_gauges_on_the_ports_registry(self):
        rep = probe("""
            lw.install()
            a = lw.make_lock("probe:a")
            with a:
                time.sleep(0.001)
            from distributed_crawler_tpu_torch.utils.metrics import REGISTRY
            text = REGISTRY.expose()
            print(json.dumps({n: n + " " in text or n + "{" in text
                              for n in ("lockwitness_cycles",
                                        "lockwitness_blocking_under_lock",
                                        "lockwitness_hold_budget_breaches",
                                        "lockwitness_instrumented_sites")}))
        """)
        assert all(rep.values()), rep
