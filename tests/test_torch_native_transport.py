"""The port's native client over its transports, against the reference's,
on the CPU.

The counterparts of `tests/test_native_transport.py`:

- seed-DB acquisition (`acquire_seed_db`): tarball, directory and bare
  JSON sources, ``file://``, a network URL refused, one directory per
  connection, re-extraction when the source changes, and the path-safety
  fallback for a Python without ``extractall``'s filter;
- the DCT wire against the reference's own `MockDcServer` (its
  `DcGateway`) as the peer, over plain TCP and TLS: the auth lifecycle
  (a wrong code, the password leg, an unauthorized fetch), the error
  taxonomy, a refused connect and a lost connection failing fast,
  concurrent sessions, a channel crawl, a ``PHONE_MIGRATE_X`` redirect
  through a DC table, and `setup_pool_from_config`'s gateway branch;
- the validator's ``chrome`` transport (`make_transport("chrome")`)
  against a local HTTPS server: parsing, redirects, chunked bodies, the
  header framing, and the validator pod's default transport;
- ``wire="mtproto"`` refused, naming the rest of ROADMAP Queue 1 part D.

Each scripted case runs once per package, the reference's client and the
port's, against its own peer, and compares the outcomes (TL objects field
by field, errors by class name, code and message).  Tests import both
packages; the port does not.
"""

import dataclasses
import json
import os
import re
import shutil
import socket
import tarfile
import threading
import time
import types

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from distributed_crawler_tpu.clients import http_validator as jhv  # noqa: E402
from distributed_crawler_tpu.clients import native as jnat  # noqa: E402
from distributed_crawler_tpu.clients.dc_gateway import DcGateway  # noqa: E402
from distributed_crawler_tpu.clients.mock_dc import (  # noqa: E402
    MockDcServer,
    make_self_signed_cert,
)
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.crawl import runner as jrun  # noqa: E402
from distributed_crawler_tpu.crawl import validator as jval  # noqa: E402
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu_torch.clients import http_validator as thv  # noqa: E402
from distributed_crawler_tpu_torch.clients import native as tnat  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.crawl import runner as trun  # noqa: E402
from distributed_crawler_tpu_torch.crawl import validator as tval  # noqa: E402
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402
from tests.test_torch_native_client import outcome, words  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(nat=jnat, hv=jhv, conf=jconf, run=jrun,
                                 val=jval, comp=jcomp, state=jstate),
    "port": types.SimpleNamespace(nat=tnat, hv=thv, conf=tconf, run=trun,
                                  val=tval, comp=tcomp, state=tstate),
}
HAS_OPENSSL = shutil.which("openssl") is not None


def wire_seed(seed, n=5):
    """One channel of ``n`` posts, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return json.dumps({"channels": [{
        "username": "wirechan", "id": 4242, "title": "Wire Channel",
        "member_count": int(rng.integers(100, 5000)),
        "messages": [
            {"content": {"@type": "messageText",
                         "text": {"text": f"wire message {i} "
                                          + words(rng, 1, 8)}},
             "date": 1700000000 + i,
             "view_count": int(rng.integers(1, 100))}
            for i in range(n)],
    }]})


def per_package(script):
    """``script(P)`` for each package; asserts the two results are equal
    and returns the port's."""
    got = {name: script(P) for name, P in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# -- seed-DB acquisition ----------------------------------------------------------
def _tarball(root, seed_json, name="dbs.tar.gz"):
    src = root / "src"
    src.mkdir(exist_ok=True)
    (src / "seed.json").write_text(seed_json)
    path = root / name
    with tarfile.open(path, "w:gz") as tar:
        tar.add(src / "seed.json", arcname="db/seed.json")
    return str(path)


def _acquire(P, source, base, conn):
    """`acquire_seed_db`'s outcome with the base directory masked, and the
    seed's channel names."""
    try:
        path = P.nat.acquire_seed_db(source, str(base), conn)
    except Exception as e:  # noqa: BLE001
        return ("error", type(e).__name__, getattr(e, "code", None), str(e))
    with open(path, encoding="utf-8") as f:
        names = [c["username"] for c in json.load(f)["channels"]]
    return ("ok", os.path.relpath(path, base), names)


class TestSeedDbAcquisition:
    def test_tarball_into_unique_conn_dirs(self, tmp_path):
        def script(P):
            root = tmp_path / P.nat.__name__
            root.mkdir()
            tar = _tarball(root, wire_seed(1))
            base = root / "dbs"
            return [_acquire(P, f"file://{tar}", base, "conn-a"),
                    _acquire(P, tar, base, "conn-b"),
                    _acquire(P, tar, base, "conn-a"),   # reused
                    sorted(os.listdir(base))]
        out = per_package(script)
        assert out[0][1] == f"conn_{tnat.fnv32('conn-a'):08x}/db/seed.json"
        assert out[0] == out[2] and out[1] != out[0]
        assert out[3] == sorted(f"conn_{tnat.fnv32(c):08x}"
                                for c in ("conn-a", "conn-b"))

    @pytest.mark.parametrize("kind", ["directory", "json", "tgz", "tar"])
    def test_each_source_kind(self, tmp_path, kind):
        def script(P):
            root = tmp_path / P.nat.__name__
            (root / "d" / "nested").mkdir(parents=True)
            seed = wire_seed(2)
            if kind == "directory":
                (root / "d" / "nested" / "store.json").write_text(seed)
                source = str(root / "d")
            elif kind == "json":
                (root / "store.json").write_text(seed)
                source = str(root / "store.json")
            else:
                (root / "d" / "seed.json").write_text(seed)
                source = str(root / f"db.{kind}")
                with tarfile.open(source, "w:gz" if kind == "tgz"
                                  else "w") as tar:
                    tar.add(root / "d" / "seed.json", arcname="seed.json")
            return _acquire(P, source, root / "dbs", "c1")
        out = per_package(script)
        assert out[0] == "ok" and out[2] == ["wirechan"]

    @pytest.mark.parametrize("source", [
        "http://mirror.test/dbs.tgz", "https://example.com/dbs.tgz",
        "s3://bucket/dbs.tgz", "/no/such/source.tar.gz", "{root}/db.zip",
        "{root}/two"])
    def test_refused_sources(self, tmp_path, source):
        """A network URL (mirror it locally), a missing path, an unknown
        format and a directory without one seed JSON: 400, the same
        message."""
        def script(P):
            root = tmp_path / P.nat.__name__
            (root / "two").mkdir(parents=True)
            (root / "two" / "a.json").write_text("{}")
            (root / "two" / "b.json").write_text("{}")
            (root / "db.zip").write_text("zip")
            out = _acquire(P, source.format(root=root), root / "dbs", "c1")
            return out[:3] + (out[3].replace(str(root), "<root>"),)
        out = per_package(script)
        assert out[:3] == ("error", "NativeClientError", 400)

    def test_changed_source_reextracts(self, tmp_path):
        """A replaced tarball, and an edited file in a directory source,
        are extracted again; an untouched source is reused."""
        def script(P):
            root = tmp_path / P.nat.__name__
            root.mkdir()
            tar = _tarball(root, wire_seed(3))
            base = root / "dbs"
            first = _acquire(P, tar, base, "c")
            again = _acquire(P, tar, base, "c")
            time.sleep(0.01)
            _tarball(root, wire_seed(3).replace("wirechan", "newchan"))
            os.utime(tar)
            tar_changed = _acquire(P, tar, base, "c")
            d = root / "dir"
            d.mkdir()
            (d / "seed.json").write_text(wire_seed(4))
            dir_first = _acquire(P, str(d), base, "d")
            (d / "seed.json").write_text(
                wire_seed(4).replace("wirechan", "dirchan"))
            os.utime(d / "seed.json", ns=(1, 1))
            dir_changed = _acquire(P, str(d), base, "d")
            return [first, again, tar_changed, dir_first, dir_changed]
        out = per_package(script)
        assert out[0] == out[1] and out[0][2] == ["wirechan"]
        assert out[2][2] == ["newchan"] and out[4][2] == ["dirchan"]

    @pytest.mark.parametrize("member", ["safe", "traversal", "symlink",
                                        "fifo"])
    def test_extract_without_the_filter_kwarg(self, tmp_path, monkeypatch,
                                              member):
        """A Python whose ``extractall`` takes no ``filter``: a safe
        tarball extracts, traversal paths, links and special files are
        refused before anything is extracted."""
        orig = tarfile.TarFile.extractall

        def no_filter(self, path=".", members=None, **kw):
            if "filter" in kw:
                raise TypeError("extractall() got an unexpected keyword "
                                "argument 'filter'")
            return orig(self, path=path, members=members)

        monkeypatch.setattr(tarfile.TarFile, "extractall", no_filter)

        def script(P):
            root = tmp_path / P.nat.__name__
            root.mkdir()
            if member == "safe":
                source = _tarball(root, wire_seed(5))
            else:
                source = str(root / "evil.tar.gz")
                with tarfile.open(source, "w:gz") as tar:
                    if member == "traversal":
                        (root / "payload").write_text("x")
                        tar.add(root / "payload", arcname="../escape.json")
                    else:
                        info = tarfile.TarInfo("db")
                        info.type = (tarfile.SYMTYPE if member == "symlink"
                                     else tarfile.FIFOTYPE)
                        info.linkname = "/"
                        tar.addfile(info)
            out = _acquire(P, source, root / "dbs", "c1")
            if out[0] == "error":
                out = out[:3] + (out[3].replace(str(root), "<root>"),)
            left = (sorted(os.listdir(root / "dbs"))
                    if (root / "dbs").exists() else [])
            return out, left
        out, left = per_package(script)
        if member == "safe":
            assert out[0] == "ok"
        else:
            assert out[:3] == ("error", "NativeClientError", 400)
            assert left == []

    def test_pool_preload_from_tarball(self, tmp_path):
        def script(P):
            root = tmp_path / P.nat.__name__
            root.mkdir()
            tar = _tarball(root, wire_seed(6))
            from importlib import import_module

            pool_mod = import_module(P.nat.__name__.rsplit(".", 1)[0]
                                     + ".pool")
            pool = pool_mod.ConnectionPool(
                P.nat.native_client_factory(db_source=tar,
                                            db_base_dir=str(root / "dbs")),
                database_urls=["file:///a", "file:///b"])
            try:
                n = pool.initialize()
                conn = pool.acquire()
                chat = outcome(conn.client.search_public_chat, "wirechan")
                pool.release(conn)
            finally:
                pool.close_all()
            return n, chat, sorted(os.listdir(root / "dbs"))
        n, chat, dirs = per_package(script)
        assert n == 2 and chat[0] == "ok" and len(dirs) == 2


# -- the DCT wire -------------------------------------------------------------------
@pytest.fixture
def server_pair():
    """One `MockDcServer` per package, so each sees its own counters."""
    made = {}

    def make(**kw):
        kw.setdefault("seed_json", wire_seed(9))
        kw.setdefault("expected_code", "24680")
        for name in PKGS:
            made[name] = MockDcServer(**kw).start()
        return made
    yield make
    for srv in made.values():
        srv.close()


def over_the_wire(servers, script, **client_kw):
    """``script(client, server)`` for each package's client dialing its
    own server; returns the port's outcome after comparing."""
    got = {}
    for name, P in PKGS.items():
        c = P.nat.NativeTelegramClient(server_addr=servers[name].address,
                                       conn_id=f"t-{name}", **client_kw)
        try:
            got[name] = script(c, servers[name])
        finally:
            c.close()
    assert got["port"] == got["ref"]
    return got["port"]


class TestAuthLifecycleOverSocket:
    def test_full_ladder_then_fetch(self, server_pair):
        def script(c, srv):
            c.authenticate("+15550001111", "24680")
            c.wait_ready(timeout_s=5.0)
            chat = outcome(c.search_public_chat, "wirechan")
            msgs = outcome(c.get_chat_history, 4242, limit=3)
            return chat, msgs, srv.auth_successes
        chat, msgs, auths = over_the_wire(server_pair(), script)
        assert chat[1]["id"] == 4242 and chat[1]["title"] == "Wire Channel"
        assert len(msgs[1]["messages"]) == 3 and msgs[1]["total_count"] == 5
        assert auths == 1

    def test_wrong_code_rejected_then_recovers(self, server_pair):
        def script(c, srv):
            wrong = outcome(c.authenticate, "+15550001111", "00000")
            right = outcome(c._call, {"@type": "checkAuthenticationCode",
                                      "code": "24680"})[0]
            c.wait_ready(timeout_s=5.0)
            return wrong, right, outcome(c.search_public_chat, "wirechan")
        wrong, right, chat = over_the_wire(server_pair(), script)
        assert "PHONE_CODE_INVALID" in wrong[3] and right == "ok"
        assert chat[1]["id"] == 4242

    def test_unauthorized_fetch_rejected(self, server_pair):
        out = over_the_wire(server_pair(), lambda c, s: outcome(
            c._call, {"@type": "searchPublicChat", "username": "wirechan"}))
        assert out[0] == "error" and "UNAUTHORIZED" in out[3]

    def test_password_leg(self, server_pair):
        def script(c, srv):
            wrong = outcome(c.authenticate, "+15550001111", "11111",
                            password="wrong")
            right = outcome(c._call, {"@type": "checkAuthenticationPassword",
                                      "password": "hunter2"})[0]
            c.wait_ready(timeout_s=5.0)
            return wrong, right, outcome(c.search_public_chat, "wirechan")
        wrong, right, chat = over_the_wire(
            server_pair(expected_code="11111", expected_password="hunter2"),
            script)
        assert "PASSWORD_HASH_INVALID" in wrong[3] and right == "ok"
        assert chat[0] == "ok"

    def test_connect_refused_fails_fast(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = per_package(lambda P: outcome(
            P.nat.NativeTelegramClient, server_addr=f"127.0.0.1:{port}",
            conn_id="t5"))
        assert out[:3] == ("error", "NativeClientError", 500)
        assert "failed to create" in out[3]

    @pytest.mark.parametrize("username", ["missing_channel", "ab", ""])
    def test_error_taxonomy_over_wire(self, server_pair, username):
        def script(c, srv):
            c.authenticate("+15550001111", "24680")
            c.wait_ready(timeout_s=5.0)
            return [outcome(c.search_public_chat, username),
                    outcome(c.get_chat, 1),
                    outcome(c.get_message, 4242, 99 << 20)]
        out = over_the_wire(server_pair(), script)
        assert all(o[0] == "error" for o in out)

    def test_every_method_over_the_wire(self, server_pair):
        """The 16 methods after the ladder, each as the reference's client
        gets it from the same gateway."""
        def script(c, srv):
            c.authenticate("+15550001111", "24680")
            c.wait_ready(timeout_s=5.0)
            chat = c.search_public_chat("wirechan")
            m = c.get_chat_history(chat.id, limit=1).messages[0]
            return [outcome(c.get_chat, chat.id),
                    outcome(c.get_supergroup, chat.supergroup_id),
                    outcome(c.get_supergroup_full_info, chat.supergroup_id),
                    outcome(c.get_basic_group_full_info, 1),
                    outcome(c.get_message, chat.id, m.id),
                    outcome(c.get_message_link, chat.id, m.id),
                    outcome(c.get_message_thread, chat.id, m.id),
                    outcome(c.get_message_thread_history, chat.id, m.id),
                    outcome(c.get_remote_file, "nope"),
                    outcome(c.download_file, 1),
                    outcome(c.delete_file, 1),
                    outcome(c.get_me), outcome(c.get_user, 42)]
        out = over_the_wire(server_pair(), script)
        assert out[0][0] == "ok"


@pytest.mark.skipif(not HAS_OPENSSL,
                    reason="openssl binary needed to mint the test cert")
class TestTlsTransport:
    def test_auth_and_fetch_over_tls(self, server_pair):
        def script(c, srv):
            c.authenticate("+15550002222", "33333")
            c.wait_ready(timeout_s=5.0)
            return (outcome(c.search_public_chat, "wirechan"),
                    len(c.get_chat_history(4242, limit=5).messages))
        chat, n = over_the_wire(
            server_pair(expected_code="33333", tls=True), script, tls=True,
            tls_insecure=True, sni="localhost")
        assert chat[1]["title"] == "Wire Channel" and n == 5

    def test_tls_client_hello_is_chrome_shaped(self):
        """The port's ClientHello, captured: Chrome's TLS 1.3 and 1.2
        cipher order, the SNI, ALPN h2 and http/1.1, X25519 before
        P-256."""
        captured = {}
        lis = socket.socket()
        lis.bind(("127.0.0.1", 0))
        lis.listen(1)
        port = lis.getsockname()[1]

        def capture():
            conn, _ = lis.accept()
            conn.settimeout(3.0)
            data = b""
            try:
                while len(data) < 5:
                    data += conn.recv(4096)
                rec_len = int.from_bytes(data[3:5], "big")
                while len(data) < 5 + rec_len:
                    data += conn.recv(4096)
            except OSError:
                pass
            captured["hello"] = data
            conn.close()

        t = threading.Thread(target=capture)
        t.start()
        with pytest.raises(Exception):
            tnat.NativeTelegramClient(server_addr=f"127.0.0.1:{port}",
                                      tls=True, tls_insecure=True,
                                      sni="web.telegram.org", conn_id="fp1")
        t.join(timeout=5)
        lis.close()
        hello = captured.get("hello", b"")
        assert hello[:1] == b"\x16" and hello[5:6] == b"\x01"
        body = hello[9:]
        pos = 2 + 32
        pos += 1 + body[pos]
        cs_len = int.from_bytes(body[pos:pos + 2], "big")
        pos += 2
        suites = [int.from_bytes(body[pos + i:pos + i + 2], "big")
                  for i in range(0, cs_len, 2)]
        tls13 = [s for s in suites if s in (0x1301, 0x1302, 0x1303)]
        tls12 = [s for s in suites if s not in (0x1301, 0x1302, 0x1303)
                 and s != 0x00ff]
        assert tls13 == [0x1301, 0x1302, 0x1303]
        assert tls12[:6] == [0xc02b, 0xc02f, 0xc02c, 0xc030, 0xcca9, 0xcca8]
        raw = bytes(hello)
        assert b"web.telegram.org" in raw
        assert b"\x02h2" in raw and b"http/1.1" in raw
        assert -1 < raw.find(b"\x00\x1d") < raw.find(b"\x00\x17")


class TestTransportErrorFastFail:
    def test_connection_loss_fails_calls_immediately(self, server_pair):
        """After the server dies, a call raises the transport error within
        the receive timeout, and the next one at once."""
        def script(c, srv):
            c.authenticate("+15550001111", "24680")
            c.wait_ready(timeout_s=5.0)
            srv.close()
            t0 = time.monotonic()
            first = outcome(c.search_public_chat, "wirechan")
            t1 = time.monotonic()
            second = outcome(c.search_public_chat, "wirechan")
            # The message names how the socket failed, which races the
            # server's close; its class and code do not.
            return (first[:3], second == first,
                    bool(re.search("connection|transport", first[3])),
                    t1 - t0 < c.receive_timeout_s,
                    time.monotonic() - t1 < 1.0)
        out = over_the_wire(server_pair(), script)
        assert out == (("error", "TelegramError", out[0][2]), True, True,
                       True, True)


class TestConcurrentConnections:
    def test_parallel_sessions_isolated(self, server_pair):
        """Four sessions of the port's client authenticate and fetch at
        once, each its own state."""
        srv = server_pair()["port"]
        results = {}

        def session(n):
            c = tnat.NativeTelegramClient(server_addr=srv.address,
                                          conn_id=f"cc{n}")
            try:
                c.authenticate(f"+1555000{n}", "24680")
                c.wait_ready(5.0)
                chat = c.search_public_chat("wirechan")
                results[n] = len(c.get_chat_history(chat.id,
                                                    limit=5).messages)
            finally:
                c.close()

        threads = [threading.Thread(target=session, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == {0: 5, 1: 5, 2: 5, 3: 5}
        assert srv.auth_successes == 4


CRAWL_SEED = json.dumps({"channels": [
    {"username": "natchan", "title": "Native Chan", "member_count": 500,
     "description": "desc",
     "messages": [
         {"date": 1700000000, "view_count": 9, "reply_count": 1,
          "content": {"@type": "messageText",
                      "text": {"text": "hello @linked_chan",
                               "entities": [{"type": {
                                   "@type": "textEntityTypeMention"},
                                   "offset": 6, "length": 12}]}}},
         {"date": 1700000100, "view_count": 4,
          "content": {"@type": "messageText",
                      "text": {"text": "plain post", "entities": []}}}]},
    {"username": "linked_chan", "title": "Linked", "member_count": 60,
     "messages": [{"date": 1700000050, "view_count": 2,
                   "content": {"@type": "messageText",
                               "text": {"text": "leaf",
                                        "entities": []}}}]}]})


class TestCrawlEngineOverWire:
    def test_run_for_channel_over_socket(self, server_pair, tmp_path):
        """Each package's `run_for_channel` over its remote client: the
        same page status, outlinks and posts."""
        def script(c, srv):
            P = PKGS["port" if c.__class__ is tnat.NativeTelegramClient
                     else "ref"]
            c.authenticate("+15550009999", "777")
            c.wait_ready(5.0)
            root = tmp_path / P.nat.__name__
            sm = P.comp.CompositeStateManager(P.state.StateConfig(
                crawl_id="wire1", crawl_execution_id="e1",
                storage_root=str(root), sql=P.state.SqlConfig(url=":memory:")))
            sm.initialize(["natchan"])
            cfg = P.conf.CrawlerConfig(crawl_id="wire1",
                                       skip_media_download=True)
            page = sm.get_layer_by_depth(0)[0]
            found = P.run.run_for_channel(c, page, "", sm, cfg)
            jsonl = root / "wire1" / "natchan" / "posts" / "posts.jsonl"
            posts = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
            for p in posts:
                p.pop("capture_time", None)
            return page.status, sorted(p.url for p in found), posts
        status, found, posts = over_the_wire(
            server_pair(seed_json=CRAWL_SEED, expected_code="777"), script)
        assert status == "fetched" and found == ["linked_chan"]
        assert sorted(p["view_count"] for p in posts) == [4, 9]


class TestDcMigration:
    SEED2 = json.dumps({"channels": [{
        "username": "dc2chan", "id": 2200, "title": "DC2 Channel",
        "member_count": 300,
        "messages": [{"content": {"@type": "messageText",
                                  "text": {"text": "hello from dc2"}},
                      "date": 1700000000, "view_count": 2}]}]})

    def _gateways(self, tmp_path, name):
        acct = {"+15559990000": {"code": "777", "password": "",
                                 "dc_id": 2}}
        home = {"+15559990000": {"code": "777", "password": ""}}
        gw1 = DcGateway(seed_json=wire_seed(1), accounts=acct, dc_id=1,
                        store_root=str(tmp_path / name / "dc1")).start()
        gw2 = DcGateway(seed_json=self.SEED2, accounts=home, dc_id=2,
                        store_root=str(tmp_path / name / "dc2")).start()
        return gw1, gw2

    def test_phone_migrate_followed_via_dc_table(self, tmp_path):
        """DC 1 homes the account on DC 2: the client reconnects through
        its DC table over the dct wire and is served by DC 2."""
        def script(P):
            gw1, gw2 = self._gateways(tmp_path, P.nat.__name__)
            try:
                c = P.nat.NativeTelegramClient(
                    server_addr=gw1.address, conn_id="mig1",
                    dc_table={2: {"address": gw2.address}})
                try:
                    c.authenticate("+15559990000", "777")
                    c.wait_ready(5.0)
                    out = (c.current_dc,
                           outcome(c.search_public_chat, "dc2chan"))
                finally:
                    c.close()
                return out + (gw1.status()["migrations_issued"],
                              gw1.status()["auth_successes"],
                              gw2.status()["auth_successes"])
            finally:
                gw1.close()
                gw2.close()
        dc, chat, migrations, auth1, auth2 = per_package(script)
        assert dc == 2 and chat[1]["id"] == 2200
        assert (migrations, auth1, auth2) == (1, 0, 1)

    def test_migrate_without_table_surfaces_error(self, tmp_path):
        def script(P):
            gw1, gw2 = self._gateways(tmp_path, P.nat.__name__)
            try:
                c = P.nat.NativeTelegramClient(server_addr=gw1.address,
                                               conn_id="mig2")
                try:
                    return outcome(c.authenticate, "+15559990000", "777")
                finally:
                    c.close()
            finally:
                gw1.close()
                gw2.close()
        out = per_package(script)
        assert out[0] == "error" and "PHONE_MIGRATE_2" in out[3]

    def test_dc_table_file(self, tmp_path):
        path = tmp_path / "dcs.json"
        for doc in ({"dcs": {"2": {"address": "127.0.0.1:9"}}},
                    {"3": {"address": "h:1", "pubkey_file": "k.json"}}):
            path.write_text(json.dumps(doc))
            assert tnat.load_dc_table(str(path)) == \
                jnat.load_dc_table(str(path))
        path.write_text(json.dumps({"2": {"pubkey_file": "k"}}))
        assert outcome(tnat.load_dc_table, str(path)) == \
            outcome(jnat.load_dc_table, str(path))


class TestGatewayPool:
    def test_gen_code_credentials_feed_a_gateway_pool(self, tmp_path,
                                                      server_pair):
        """`generate_pcode` over the wire writes credentials; a pool from
        `setup_pool_from_config` with ``dc_address`` reads them and dials
        ``concurrency`` authenticated connections."""
        servers = server_pair(expected_code="55555")
        env = {"TG_API_ID": "94575", "TG_API_HASH": "h",
               "TG_PHONE_NUMBER": "+15550003333", "TG_PHONE_CODE": "55555"}

        def script(P):
            name = "port" if P is PKGS["port"] else "ref"
            srv = servers[name]
            tdlib = str(tmp_path / name / ".tdlib")
            c = P.nat.NativeTelegramClient(server_addr=srv.address,
                                           conn_id="gen-code")
            try:
                P.nat.generate_pcode(tdlib_dir=tdlib, env=env, client=c)
            finally:
                c.close()
            P.run.shutdown_connection_pool()
            cfg = P.conf.CrawlerConfig(crawl_id="g1", dc_address=srv.address,
                                       tdlib_dir=tdlib, concurrency=3)
            try:
                installed = P.run.setup_pool_from_config(cfg)
                conn = P.run.get_connection_from_pool(timeout_s=5)
                chat = outcome(conn.client.search_public_chat, "wirechan")
                P.run.release_connection_to_pool(conn)
                n = len(P.run._pool._conns)
            finally:
                P.run.shutdown_connection_pool()
            return installed, n, chat, srv.auth_successes
        installed, n, chat, auths = per_package(script)
        assert installed is True and n == 3 and chat[0] == "ok"
        assert auths == 4   # gen-code's ladder and one per connection

    def test_gateway_pool_without_credentials_is_empty(self, tmp_path,
                                                       server_pair):
        servers = server_pair()

        def script(P):
            name = "port" if P is PKGS["port"] else "ref"
            P.run.shutdown_connection_pool()
            cfg = P.conf.CrawlerConfig(
                crawl_id="g2", dc_address=servers[name].address,
                tdlib_dir=str(tmp_path / "none"))
            out = outcome(P.run.setup_pool_from_config, cfg)
            return (out[:3] + (out[3].replace(servers[name].address,
                                              "<gateway>"),),
                    P.run._pool is None)
        out, empty = per_package(script)
        assert out[:2] == ("error", "PoolEmptyError") and empty


class TestMtprotoRefused:
    def test_client_factory_and_pool_name_the_next_slice(self):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 part D"):
            tnat.NativeTelegramClient(server_addr="127.0.0.1:9",
                                      wire="mtproto")
        with pytest.raises(NotImplementedError, match="mtproto_wire"):
            tnat.native_client_factory(server_addr="127.0.0.1:9",
                                       wire="mtproto")
        trun.shutdown_connection_pool()
        with pytest.raises(NotImplementedError, match="part D"):
            trun.setup_pool_from_config(tconf.CrawlerConfig(
                dc_address="127.0.0.1:9", dc_wire="mtproto"))
        assert trun._pool is None


# -- the validator's chrome transport ---------------------------------------------
HTML = ('<html><head><title>Telegram: View @wirechan</title></head>'
        '<body>ok</body></html>')


def _https(tmp_path, handler_cls):
    import http.server
    import ssl

    cert, key = make_self_signed_cert(str(tmp_path))
    srv = http.server.HTTPServer(("127.0.0.1", 0), handler_cls)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _handler(routes, seen=None, chunked=False):
    """A handler serving ``routes`` {path: (status, headers, body)}."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1" if chunked else "HTTP/1.0"

        def do_GET(self):
            if seen is not None:
                seen.append(dict(self.headers))
            status, headers, body = routes.get(
                self.path, (404, {"Content-Length": "0"}, b""))
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass
    return Handler


def _ok(body=HTML):
    data = body.encode()
    return (200, {"Content-Type": "text/html",
                  "Content-Length": str(len(data))}, data)


def _chunks(*parts, tail=b"0\r\n\r\n"):
    return b"".join(f"{len(p):x}\r\n".encode() + p + b"\r\n"
                    for p in parts) + tail


@pytest.mark.skipif(not HAS_OPENSSL,
                    reason="openssl binary needed to mint the test cert")
class TestChromeHttpTransport:
    def _fetch(self, tmp_path, routes, path="/wirechan", chunked=False,
               **kw):
        seen = []
        srv = _https(tmp_path, _handler(routes, seen, chunked))
        try:
            url = f"https://127.0.0.1:{srv.server_address[1]}{path}"
            got = per_package(lambda P: outcome(
                P.hv.chrome_transport, url,
                {"User-Agent": "Mozilla/5.0 test-chrome"}, tls_insecure=True,
                **kw))
        finally:
            srv.shutdown()
        return got, seen

    def test_fetch_and_parse(self, tmp_path):
        got, seen = self._fetch(tmp_path, {"/wirechan": _ok()})
        status, body = got[1]
        assert status == 200 and body.decode() == HTML
        assert thv.parse_channel_html(body.decode()).status == "valid"
        assert [h["User-Agent"] for h in seen] == \
            ["Mozilla/5.0 test-chrome"] * 2

    def test_make_transport_selection(self):
        assert thv.make_transport("urllib") is thv.urllib_transport
        assert thv.make_transport("") is thv.urllib_transport
        assert callable(thv.make_transport("chrome"))
        assert outcome(thv.make_transport, "curl") == \
            outcome(jhv.make_transport, "curl")

    @pytest.mark.parametrize("status", [301, 302, 303, 307, 308])
    def test_redirect_followed_like_urllib(self, tmp_path, status):
        got, _ = self._fetch(tmp_path, {
            "/wirechan": (status, {"Location": "/s/wirechan",
                                   "Content-Length": "0"}, b""),
            "/s/wirechan": _ok()})
        assert got[1][0] == 200 and b"View @wirechan" in got[1][1]

    def test_redirect_location_last_header_with_body(self, tmp_path):
        stub = b"<html>moved</html>"
        got, _ = self._fetch(tmp_path, {
            "/wirechan": (301, {"Content-Length": str(len(stub)),
                                "Location": "/s/wirechan"}, stub),
            "/s/wirechan": _ok()})
        assert got[1][0] == 200 and b"View @wirechan" in got[1][1]

    def test_redirect_loop_is_transient(self, tmp_path):
        got, _ = self._fetch(tmp_path, {
            "/wirechan": (302, {"Location": "/wirechan",
                                "Content-Length": "0"}, b"")},
            max_redirects=2)
        assert got[:2] == ("error", "ValidationHTTPError")
        assert "redirect loop" in got[3]

    def test_chunked_response_dechunked(self, tmp_path):
        data = HTML.encode()
        got, _ = self._fetch(tmp_path, {"/wirechan": (
            200, {"Transfer-Encoding": "chunked"},
            _chunks(data[:30], data[30:37], data[37:]))}, chunked=True)
        assert got[1] == (200, data)

    def test_chunked_body_containing_bare_zero_line(self, tmp_path):
        data = (HTML[:-14] + "count:\r\n0\r\nmore text after zero"
                + HTML[-14:]).encode()
        got, _ = self._fetch(tmp_path, {"/wirechan": (
            200, {"Transfer-Encoding": "chunked"}, _chunks(data))},
            chunked=True)
        assert got[1] == (200, data)

    def test_x_content_length_header_ignored(self, tmp_path):
        data = HTML.encode()
        got, _ = self._fetch(tmp_path, {"/wirechan": (
            200, {"X-Content-Length": "5",
                  "Content-Length": str(len(data))}, data)})
        assert got[1] == (200, data)

    def test_validator_uses_configured_transport(self, tmp_path):
        """`validate_channel_http` end to end through each package's
        chrome transport, t.me's URL mapped to the local server."""
        srv = _https(tmp_path, _handler({"/wirechan": _ok()}))
        port = srv.server_address[1]
        try:
            def script(P):
                def transport(url, headers):
                    name = url.rsplit("/", 1)[1]
                    return P.hv.chrome_transport(
                        f"https://127.0.0.1:{port}/{name}", headers,
                        tls_insecure=True)
                return [outcome(P.hv.validate_channel_http, n,
                                transport=transport)
                        for n in ("wirechan", "gone")]
            out = per_package(script)
        finally:
            srv.shutdown()
        assert out[0] == ("ok", {"status": "valid", "reason": ""})
        assert out[1][:2] == ("error", "ValidationHTTPError")

    def test_validator_base_url_routes_whole_pod(self, tmp_path,
                                                 monkeypatch):
        """The validator pod's default ``validate_fn`` with
        ``validator_transport="chrome"`` and a mirror base URL, in both
        packages (``tls_insecure`` injected at the transport)."""
        srv = _https(tmp_path, _handler({"/wirechan": _ok()}))
        try:
            def script(P):
                real = P.hv.chrome_transport
                monkeypatch.setattr(
                    P.hv, "chrome_transport",
                    lambda url, headers, **kw: real(
                        url, headers, **{**kw, "tls_insecure": True}))
                loop = P.val.RunValidationLoop(None, P.conf.CrawlerConfig(
                    platform="telegram", validator_transport="chrome",
                    validator_base_url=
                    f"https://127.0.0.1:{srv.server_address[1]}"))
                return dataclasses.asdict(loop.validate_fn("wirechan"))
            out = per_package(script)
        finally:
            srv.shutdown()
        assert out["status"] == "valid"

    def test_native_https_get_plain_http(self, tmp_path):
        """``plain`` GETs over TCP: the same status, body and ALPN."""
        import http.server

        srv = http.server.HTTPServer(("127.0.0.1", 0),
                                     _handler({"/x": _ok()}))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            out = per_package(lambda P: outcome(
                P.nat.native_https_get, "127.0.0.1", path="/x",
                port=srv.server_address[1], plain=True))
        finally:
            srv.shutdown()
        assert out[0] == "ok" and out[1]["status"] == 200
