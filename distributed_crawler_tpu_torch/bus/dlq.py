"""Dead-letter queue operator tool: list, inspect, replay.

    python -m distributed_crawler_tpu_torch.bus.dlq --spool-dir D        # list
    python -m distributed_crawler_tpu_torch.bus.dlq --url http://127.0.0.1:9102
    python -m distributed_crawler_tpu_torch.bus.dlq --spool-dir D \
        --topic tpu-inference-batches --inspect 3f9c...             # payload
    python -m distributed_crawler_tpu_torch.bus.dlq --spool-dir D \
        --topic T --replay 3f9c... --bus-address 127.0.0.1:50551    # re-drive
    python -m distributed_crawler_tpu_torch.bus.dlq --spool-dir D \
        --topic T --replay-all --bus-address 127.0.0.1:50551
    python -m distributed_crawler_tpu_torch.bus.dlq --selfcheck     # smoke

The port's copy of the repository's `tools/dlq.py`, with the same flags and
output, over the port's own spool (`bus/spool.py`) and gRPC client.  List
mode reads either a broker's spool directory (offline: it works with the
broker down) or a live broker's ``/dlq`` route on its metrics port.  Replay
re-publishes the dead frame onto its topic over the gRPC bus (it re-enters
the delivery loop with a fresh attempt budget) and marks the entry
replayed in the spool, so an entry is re-driven at most deliberately.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional
from urllib.parse import quote as _quote


def _fmt_ts(epoch: float) -> str:
    if not epoch:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(epoch)) + "Z"


def _load_url(url: str, topic: str = "", entry_id: str = "") -> Dict[str, Any]:
    query = []
    if topic:
        query.append(f"topic={_quote(topic)}")
    if entry_id:
        query.append(f"id={_quote(entry_id)}")
    full = url.rstrip("/") + "/dlq" + (("?" + "&".join(query)) if query
                                       else "")
    with urllib.request.urlopen(full, timeout=5) as resp:
        return json.loads(resp.read())


def _dlq(spool_dir: str):
    from .spool import DeadLetterSpool

    # replayed_retention=None: the tool must never compact (rewrite) a
    # spool a live broker may be appending to concurrently — only the
    # owning broker instance compacts.
    return DeadLetterSpool(spool_dir, replayed_retention=None)


def _load_spool(spool_dir: str, topic: str = "",
                entry_id: str = "") -> Dict[str, Any]:
    return _dlq(spool_dir).snapshot(topic=topic or None,
                                    fid=entry_id or None)


def render_list(body: Dict[str, Any]) -> str:
    lines: List[str] = []
    topics = body.get("topics") or {}
    if not topics:
        return "dead-letter queue is empty"
    lines.append(f"{'topic':<28} {'total':>6} {'pending':>8}")
    for topic, info in sorted(topics.items()):
        lines.append(f"{topic:<28} {info.get('count', 0):>6} "
                     f"{info.get('pending', 0):>8}")
    lines.append("")
    lines.append(f"{'id':<18} {'topic':<24} {'when':<21} {'att':>3} "
                 f"{'bytes':>8}  reason")
    for topic, info in sorted(topics.items()):
        for e in info.get("entries") or []:
            flag = " (replayed)" if e.get("replayed") else ""
            lines.append(
                f"{e.get('id', '-'):<18} {topic:<24} "
                f"{_fmt_ts(float(e.get('ts') or 0)):<21} "
                f"{e.get('attempts', 0):>3} {e.get('bytes', 0):>8}  "
                f"{(e.get('reason') or '-')[:40]}{flag}")
    return "\n".join(lines)


def render_entry(body: Dict[str, Any]) -> str:
    entry = body.get("entry")
    if not entry:
        return "entry not found"
    lines = [f"id:       {entry.get('id')}",
             f"topic:    {entry.get('topic')}",
             f"when:     {_fmt_ts(float(entry.get('ts') or 0))}",
             f"attempts: {entry.get('attempts')}",
             f"reason:   {entry.get('reason') or '-'}",
             f"replayed: {entry.get('replayed')}",
             f"bytes:    {entry.get('bytes')}"]
    payload = base64.b64decode(entry.get("payload_b64", ""))
    try:
        decoded = json.loads(payload.decode("utf-8"))
        lines.append("payload (json):")
        lines.append(json.dumps(decoded, indent=2, default=str)[:4000])
    except (ValueError, UnicodeDecodeError):
        lines.append("payload (binary, first 128 bytes hex):")
        lines.append(payload[:128].hex())
    return "\n".join(lines)


def replay(spool_dir: str, topic: str, entry_ids: List[str],
           bus_address: str) -> List[Dict[str, Any]]:
    """Re-publish dead frames onto their topic over the gRPC bus and mark
    them replayed; returns the replayed entries' metadata.

    Note: a LIVE broker's in-memory unrouted-hold cap only recounts the
    spool at restart, so offline replay of ``no_route`` entries frees
    the on-disk slots immediately but the running broker's cap window
    catches up on its next restart."""
    from .grpc_bus import GrpcBusClient

    dlq = _dlq(spool_dir)
    client = GrpcBusClient(bus_address)
    out: List[Dict[str, Any]] = []
    try:
        by_id = {e.fid: e for e in dlq.entries(topic)}
        for fid in entry_ids:
            entry = by_id.get(fid)
            if entry is None:
                raise SystemExit(f"error: no dead letter {fid!r} on "
                                 f"topic {topic!r}")
            client.publish_frame(topic, entry.payload)
            dlq.mark_replayed(topic, fid)
            out.append({**entry.meta(), "replayed": True})
    finally:
        client.close()
    return out


def selfcheck() -> int:
    """End-to-end smoke: poison a frame into the DLQ through a real
    durable broker, list it, replay it, and consume the replayed copy.
    The spool lives in a temporary directory, removed afterwards."""
    import tempfile

    from .grpc_bus import GrpcBusClient, GrpcBusServer

    tmp = tempfile.TemporaryDirectory(prefix="dct-dlq-selfcheck-")
    spool_dir = tmp.name
    server = GrpcBusServer("127.0.0.1:0", spool_dir=spool_dir,
                           max_attempts=1, ack_timeout_s=60)
    server.enable_pull("dlq-check")
    server.start()
    addr = f"127.0.0.1:{server.bound_port}"
    client = GrpcBusClient(addr)
    try:
        client.publish("dlq-check", {"poison": True, "n": 7})
        # Each ack goes out while its stream is open: a stream closed
        # first may requeue the frame uncharged, leaving the ack nothing.
        it = client.pull("dlq-check")
        delivery_id, payload = next(it)
        client.ack("dlq-check", delivery_id, ok=False)  # nack -> dead
        it.close()
        body = _load_spool(spool_dir)
        info = (body.get("topics") or {}).get("dlq-check") or {}
        assert info.get("count") == 1, body
        fid = info["entries"][0]["id"]
        detail = _load_spool(spool_dir, topic="dlq-check", entry_id=fid)
        decoded = json.loads(base64.b64decode(
            detail["entry"]["payload_b64"]))
        assert decoded.get("n") == 7, decoded
        # Replay through the live broker and consume the second life.
        replayed = replay(spool_dir, "dlq-check", [fid], addr)
        assert replayed and replayed[0]["replayed"], replayed
        it = client.pull("dlq-check")
        delivery_id, payload = next(it)
        client.ack("dlq-check", delivery_id, ok=True)
        it.close()
        assert json.loads(payload).get("n") == 7
        body = _load_spool(spool_dir)
        assert body["topics"]["dlq-check"]["pending"] == 0, body
    finally:
        client.close()
        server.close()
        tmp.cleanup()
    print("dlq selfcheck ok")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="dlq", description="bus dead-letter queue: list/inspect/replay")
    p.add_argument("--spool-dir", default="",
                   help="broker spool directory (offline; works with the "
                        "broker down)")
    p.add_argument("--url", default="",
                   help="live broker metrics endpoint base, e.g. "
                        "http://127.0.0.1:9102 (reads /dlq)")
    p.add_argument("--topic", default="", help="restrict to one topic")
    p.add_argument("--inspect", default="",
                   help="show one entry's full payload (needs --topic)")
    p.add_argument("--replay", default="",
                   help="re-drive one entry onto its topic (needs --topic, "
                        "--spool-dir and --bus-address)")
    p.add_argument("--replay-all", action="store_true",
                   help="re-drive every pending entry of --topic")
    p.add_argument("--bus-address", default="",
                   help="gRPC bus address replays publish to")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--selfcheck", action="store_true",
                   help="run the CI smoke and exit")
    args = p.parse_args(argv)

    if args.selfcheck:
        return selfcheck()
    if not args.spool_dir and not args.url:
        p.error("need --spool-dir or --url (or --selfcheck)")

    if args.replay or args.replay_all:
        if not (args.topic and args.spool_dir and args.bus_address):
            p.error("--replay/--replay-all need --topic, --spool-dir and "
                    "--bus-address")
        if args.replay_all:
            ids = [e.fid for e in _dlq(args.spool_dir).entries(args.topic)
                   if not e.replayed]
        else:
            ids = [args.replay]
        entries = replay(args.spool_dir, args.topic, ids, args.bus_address)
        if args.json:
            print(json.dumps({"replayed": entries}, default=str))
        else:
            print(f"replayed {len(entries)} entr"
                  f"{'y' if len(entries) == 1 else 'ies'} onto "
                  f"{args.topic!r}")
        return 0

    load = (lambda t="", i="": _load_url(args.url, t, i)) if args.url \
        else (lambda t="", i="": _load_spool(args.spool_dir, t, i))
    if args.inspect:
        if not args.topic:
            p.error("--inspect needs --topic")
        body = load(args.topic, args.inspect)
        print(json.dumps(body, default=str) if args.json
              else render_entry(body))
        return 0
    body = load(args.topic)
    print(json.dumps(body, default=str) if args.json else render_list(body))
    return 0


if __name__ == "__main__":
    sys.exit(main())
