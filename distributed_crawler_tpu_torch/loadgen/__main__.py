"""``python -m distributed_crawler_tpu_torch.loadgen``: run a loadgen
scenario against the port and emit ONE JSON verdict line.

The port's counterpart of the reference's ``tools/loadtest.py``, with its
flags and outputs::

    python -m distributed_crawler_tpu_torch.loadgen --scenario kill-worker
    python -m distributed_crawler_tpu_torch.loadgen --scenario custom.json --seed 99
    python -m distributed_crawler_tpu_torch.loadgen --scenario kill-worker \\
        --replay dumps/postmortem_...json      # replay a bundle's workload
    python -m distributed_crawler_tpu_torch.loadgen --list

Contract (the bench.py contract): whatever happens — scenario typo,
wedged backend, assertion failure, a scenario block the port has not
ported — the LAST stdout line is one parseable JSON object with a
``status`` field ("pass" | "fail" | "error"); exit code 0 only on
"pass".  Progress goes to stderr.

Unlike the reference, which forces the CPU unless ``--device`` is given,
the port runs the engine on the card; ``--device`` is accepted and means
that default.  In-process callers (the tests) ask for the CPU with
``main(argv, device="cpu")``.  Scenarios with a ``parallel`` block (a
serving mesh) are refused, so there is no device-count forcing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_mix(text: str) -> dict:
    """"telegram=0.8,youtube=0.2" -> {"telegram": 0.8, "youtube": 0.2}."""
    out = {}
    for part in text.split(","):
        name, sep, weight = part.partition("=")
        if not sep:
            raise ValueError(f"bad platform mix entry {part!r} "
                             f"(want name=weight)")
        out[name.strip()] = float(weight)
    return out


def _parse_gate(text: str) -> dict:
    """Gate-envelope overrides: inline JSON object or @path/to/file.json
    (the job.data convention)."""
    if text.startswith("@"):
        with open(text[1:], "r", encoding="utf-8") as f:
            text = f.read()
    gate = json.loads(text)
    if not isinstance(gate, dict):
        raise ValueError("gate overrides must be a JSON object")
    return gate


def _resolve(args) -> "tuple[str, dict]":
    """(scenario name/path, scenario overrides) through the CLI's
    precedence chain — flags > environment > the config file's `loadgen:`
    block > scenario-file values (the ``loadgen_*`` `_KEY_MAP` entries of
    `cli.py`)."""
    from ..config.precedence import ConfigResolver

    flags = {
        "loadgen.scenario": args.scenario,
        "loadgen.seed": args.seed,
        "loadgen.duration_s": args.duration,
        "loadgen.arrival": args.arrival,
        "loadgen.rate_batches_per_s": args.rate,
        "loadgen.platform_mix": args.platform_mix,
        "loadgen.gate": args.gate,
    }
    r = ConfigResolver(flags=flags, config_file=args.config or None)
    # Zero/empty resolved values mean "keep the scenario's" — the
    # config.example.yaml defaults must be inert, and an explicit
    # --seed 0 from the flag layer still wins below because the flag
    # value reaches us pre-resolution via `args`.
    overrides: dict = {"load": {}}
    if args.seed is not None:
        overrides["load"]["seed"] = args.seed
    elif r.get_int("loadgen.seed", 0):
        overrides["load"]["seed"] = r.get_int("loadgen.seed")
    if r.get_float("loadgen.duration_s", 0.0) > 0:
        overrides["load"]["duration_s"] = r.get_float("loadgen.duration_s")
    if r.get_str("loadgen.arrival"):
        overrides["load"]["arrival"] = r.get_str("loadgen.arrival")
    if r.get_float("loadgen.rate_batches_per_s", 0.0) > 0:
        overrides["load"]["rate_batches_per_s"] = r.get_float(
            "loadgen.rate_batches_per_s")
    mix = r.get("loadgen.platform_mix")
    if mix:
        overrides["load"]["platform_mix"] = \
            mix if isinstance(mix, dict) else _parse_mix(str(mix))
    gate = r.get("loadgen.gate")
    if gate:
        overrides["gate"] = \
            gate if isinstance(gate, dict) else _parse_gate(str(gate))
    return r.get_str("loadgen.scenario") or "steady-state", overrides


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="loadtest",
        description="synthetic load + chaos + SLO regression gate")
    p.add_argument("--scenario", default=None,
                   help="checked-in scenario name (see --list) or a JSON "
                        "scenario file path (default steady-state; also "
                        "settable as loadgen.scenario in --config)")
    p.add_argument("--config", default="",
                   help="crawler config file; its `loadgen:` block "
                        "supplies defaults for every flag here "
                        "(config.example.yaml)")
    p.add_argument("--list", action="store_true",
                   help="list checked-in scenarios and exit")
    p.add_argument("--replay", default="",
                   help="replay the workload recorded in this "
                        "flight/postmortem bundle instead of the "
                        "scenario's synthetic load")
    p.add_argument("--seed", type=int, default=None,
                   help="override the scenario's load seed")
    p.add_argument("--duration", type=float, default=None,
                   help="override the scenario's load duration (s)")
    p.add_argument("--arrival", default=None, choices=["poisson", "ramp"],
                   help="override the arrival process")
    p.add_argument("--rate", type=float, default=None,
                   help="override rate_batches_per_s (poisson)")
    p.add_argument("--platform-mix", default=None,
                   help='override the platform mix, e.g. '
                        '"telegram=0.8,youtube=0.2"')
    p.add_argument("--gate", default=None,
                   help="gate-envelope overrides: inline JSON object or "
                        "@path/to/gate.json (merged over the scenario's "
                        "gate block)")
    p.add_argument("--dump-bundle", default="",
                   help="write a flight bundle (replayable via --replay) "
                        "to this directory after the run")
    p.add_argument("--device", action="store_true",
                   help="run on the card (the default; kept for the "
                        "reference's command lines)")
    p.add_argument("--smoke", action="store_true",
                   help="harness selfcheck: parse every checked-in "
                        "scenario + chaos timeline, run nothing")
    return p


def _list(loadgen) -> None:
    """Operator discovery: name + one-line summary + the chaos timeline
    (and fleet bounds for autoscaled scenarios)."""
    for scenario_name in loadgen.scenario_names():
        sc = loadgen.load_scenario(scenario_name)
        summary = (sc.get("description") or "").split(". ")[0]
        if len(summary) > 110:
            summary = summary[:107] + "..."
        kind = sc.get("kind", "text")
        print(f"{scenario_name}  [{kind}, bus={sc.get('bus', 'inmemory')}]")
        print(f"    {summary}")
        chaos = sc.get("chaos") or []
        if chaos:
            print(f"    chaos: {'; '.join(chaos)}")
        pools = (sc.get("autoscaler") or {}).get("pools") or []
        for pool in pools:
            print(f"    autoscaler: pool {pool.get('pool')} "
                  f"{pool.get('min_workers', 1)}.."
                  f"{pool.get('max_workers', 4)} workers")


def _smoke(loadgen) -> None:
    """Validate EVERY checked-in scenario parses end to end — load config,
    chaos timeline, a deterministic plan, the gate-key envelope, and the
    "alerts"/"autoscaler" blocks — without running any traffic."""
    for scenario_name in loadgen.scenario_names():
        sc = loadgen.load_scenario(scenario_name)
        loadgen.parse_timeline(sc.get("chaos", []))
        loadgen.validate_gate_config(sc)
        if sc.get("kind") == "asr":
            acfg = loadgen.AudioLoadConfig(**sc.get("audio_load", {}))
            acfg.validate()
            assert loadgen.AudioWorkload(acfg, "/nonexistent").plan()
            continue
        cfg = loadgen.LoadGenConfig(**sc.get("load", {}))
        cfg.validate()
        assert loadgen.SyntheticWorkload(cfg).plan()


def main(argv=None, device=None) -> int:
    """Run the entry point; returns the exit code.  ``device`` is for
    in-process callers: None is the card, ``"cpu"`` the CPU."""
    args = build_parser().parse_args(argv)
    from .. import loadgen

    if args.list:
        _list(loadgen)
        return 0

    scenario_name = args.scenario or "steady-state"
    try:
        scenario_name, overrides = _resolve(args)
        scenario = loadgen.load_scenario(scenario_name)
        if args.smoke:
            _smoke(loadgen)
            print(json.dumps({"status": "pass", "smoke": True,
                              "scenarios": loadgen.scenario_names()}))
            return 0
        workload = None
        if args.replay:
            workload = loadgen.workload_from_bundle(args.replay)
            print(f"[loadtest] replaying {workload.source}: "
                  f"{workload.totals()}", file=sys.stderr)
        print(f"[loadtest] running scenario {scenario['name']!r} "
              f"(bus={scenario.get('bus', 'inmemory')})", file=sys.stderr)
        verdict = loadgen.run_scenario(scenario, overrides=overrides,
                                       workload=workload, device=device)
        if args.dump_bundle:
            from ..utils import flight

            path = flight.RECORDER.dump(
                f"loadtest-{scenario['name']}-{os.getpid()}",
                dump_dir=args.dump_bundle)
            verdict["bundle"] = path
        print(json.dumps(verdict))
        return 0 if verdict.get("status") == "pass" else 1
    except Exception as exc:  # noqa: BLE001 — the contract: always JSON
        import traceback

        traceback.print_exc(file=sys.stderr)
        print(json.dumps({
            "status": "error",
            "scenario": scenario_name,
            "error": f"{type(exc).__name__}: {exc}",
        }))
        return 1


if __name__ == "__main__":
    sys.exit(main())
