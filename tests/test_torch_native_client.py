"""The port's native Telegram client (`distributed_crawler_tpu_torch/
clients/native.py`) against the reference's, on the CPU.

The counterparts of `tests/test_native_client.py`: each of the 16 methods
(history pagination, threads, the file lifecycle, users), the errors (400
for an unknown channel or message, FLOOD_WAIT, a closed client), the auth
ladder (a wrong code, a wrong password, steps out of order),
`generate_pcode` and `load_credentials`, a channel crawl over each
package's client, and pools over `native_client_factory` and over
`setup_pool_from_config`'s seed-DB branch.  Every case feeds the same seed
JSON, made with numpy from a seed, to both packages' clients, and compares
what comes back: TL objects field by field (`dataclasses.asdict`), errors
by class name, code and message.  Host code: no tolerance.

The reference loads `native/libdct_client.so`; the port builds its own
copy from `native/`'s sources under ``distributed_crawler_tpu_torch/
_build/native/``.  Both load with ctypes' default ``RTLD_LOCAL``.  The
build itself: two processes building at once get one good copy, each of
the five sources is in the key, a failed build raises with the
compiler's output, nothing is written under `native/`, and
``DCT_NATIVE_LIB`` or an explicit path comes first.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from distributed_crawler_tpu.clients import native as jnat  # noqa: E402
from distributed_crawler_tpu.clients import pool as jpool  # noqa: E402
from distributed_crawler_tpu.clients import telegram as jtel  # noqa: E402
from distributed_crawler_tpu.config import crawler as jconf  # noqa: E402
from distributed_crawler_tpu.crawl import runner as jrun  # noqa: E402
from distributed_crawler_tpu.state import composite as jcomp  # noqa: E402
from distributed_crawler_tpu.state import interface as jstate  # noqa: E402
from distributed_crawler_tpu_torch.clients import native as tnat  # noqa: E402
from distributed_crawler_tpu_torch.clients import pool as tpool  # noqa: E402
from distributed_crawler_tpu_torch.clients import telegram as ttel  # noqa: E402
from distributed_crawler_tpu_torch.config import crawler as tconf  # noqa: E402
from distributed_crawler_tpu_torch.crawl import runner as trun  # noqa: E402
from distributed_crawler_tpu_torch.state import composite as tcomp  # noqa: E402
from distributed_crawler_tpu_torch.state import interface as tstate  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "ref": types.SimpleNamespace(nat=jnat, pool=jpool, tel=jtel, conf=jconf,
                                 run=jrun, comp=jcomp, state=jstate),
    "port": types.SimpleNamespace(nat=tnat, pool=tpool, tel=ttel, conf=tconf,
                                  run=trun, comp=tcomp, state=tstate),
}
LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def words(rng, lo, hi):
    n = int(rng.integers(lo, hi + 1))
    return " ".join("".join(LETTERS[rng.integers(0, 26, int(k))])
                    for k in rng.integers(3, 9, n))


def seed_doc(seed, files_dir="", flood=()):
    """The seed store: ``natchan`` (a mention of ``linked_chan`` first, a
    thread root with two replies, reactions, forwards), ``linked_chan``,
    two files; counts and texts drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def message(text, i, **kw):
        return {"date": 1700000000 + 60 * i,
                "view_count": int(rng.integers(1, 1000)),
                "forward_count": int(rng.integers(0, 50)),
                "reply_count": int(rng.integers(0, 9)),
                "reactions": {"\U0001F44D": int(rng.integers(0, 30))},
                "content": {"@type": "messageText",
                            "text": {"text": text, "entities": []}}, **kw}

    first = message("hello @linked_chan", 0)
    first["content"]["text"]["entities"] = [
        {"type": {"@type": "textEntityTypeMention"}, "offset": 6,
         "length": 12}]
    nat = [first] + [message(words(rng, 1, 12), i) for i in range(1, 6)]
    nat[2]["message_thread_id"] = 3   # a thread rooted at message 3
    nat[3]["message_thread_id"] = 3
    nat[3]["reply_to_message_id"] = 3
    nat[4]["sender_id"] = int(rng.integers(1, 10 ** 6))
    nat[4]["sender_username"] = "someone"
    doc = {
        "channels": [
            {"username": "natchan", "title": "Native Chan",
             "member_count": int(rng.integers(100, 5000)),
             "description": words(rng, 2, 6), "messages": nat},
            {"username": "linked_chan", "title": "Linked",
             "member_count": int(rng.integers(100, 5000)),
             "messages": [message(words(rng, 1, 6), i) for i in range(2)]},
        ],
        "files": [{"remote_id": f"r{i}",
                   "size": int(rng.integers(16, 256))} for i in range(2)],
        "flood_wait": list(flood),
    }
    if files_dir:
        doc["files_dir"] = files_dir
    return json.dumps(doc)


def outcome(fn, *args, **kw):
    """A call's result as plain data: the TL object's fields, or the
    error's class name, code and message."""
    try:
        got = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("error", type(e).__name__, getattr(e, "code", None),
                getattr(e, "message", str(e)))
    if dataclasses.is_dataclass(got):
        return ("ok", dataclasses.asdict(got))
    return ("ok", got)


def relative(out, root):
    """An outcome with ``root`` (a package's files dir) masked."""
    return json.loads(json.dumps(out).replace(root, "<files>"))


@pytest.fixture
def clients(tmp_path):
    """Each package's client on one seed store, each downloading into its
    own files dir."""
    made = {}
    for name, P in PKGS.items():
        files = tmp_path / name
        files.mkdir()
        made[name] = P.nat.NativeTelegramClient(
            seed_json=seed_doc(7, files_dir=str(files)))
    yield made
    for c in made.values():
        c.close()


def both(clients, tmp_path, script):
    """``script(client)`` -> a list of outcomes, for each package, with
    its files dir masked; asserts the two are equal and returns one."""
    got = {name: relative(script(c), str(tmp_path / name))
           for name, c in clients.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def _chat(c):
    return c.search_public_chat("natchan")


def _history(c):
    return c.get_chat_history(_chat(c).id).messages


SCRIPTS = {
    "search_public_chat": lambda c: [
        outcome(c.search_public_chat, n) for n in ("natchan", "linked_chan")],
    "get_chat": lambda c: [outcome(c.get_chat, _chat(c).id),
                           outcome(c.get_chat, 999)],
    "get_supergroup": lambda c: [
        outcome(c.get_supergroup, _chat(c).supergroup_id)],
    "get_supergroup_full_info": lambda c: [
        outcome(c.get_supergroup_full_info, _chat(c).supergroup_id)],
    "get_basic_group_full_info": lambda c: [
        outcome(c.get_basic_group_full_info, 1)],
    "get_chat_history": lambda c: [
        outcome(c.get_chat_history, _chat(c).id, limit=n)
        for n in (1, 2, 100)],
    "get_message": lambda c: [outcome(c.get_message, _chat(c).id, m.id)
                              for m in _history(c)],
    "get_message_link": lambda c: [
        outcome(c.get_message_link, _chat(c).id, m.id)
        for m in _history(c)],
    "get_message_thread": lambda c: [
        outcome(c.get_message_thread, _chat(c).id, m.id)
        for m in _history(c)],
    "get_message_thread_history": lambda c: [
        outcome(c.get_message_thread_history, _chat(c).id, m.id)
        for m in _history(c)],
    "get_remote_file": lambda c: [outcome(c.get_remote_file, r)
                                  for r in ("r0", "r1")],
    "download_file": lambda c: [
        outcome(c.download_file, c.get_remote_file("r1").id)],
    "delete_file": lambda c: [
        outcome(c.delete_file, c.download_file(
            c.get_remote_file("r0").id).id),
        outcome(c.get_remote_file, "r0")],
    "get_me": lambda c: [outcome(c.get_me)],
    "get_user": lambda c: [outcome(c.get_user, u) for u in (42, 7)],
    "close": lambda c: [outcome(c.close), outcome(c.close),
                        outcome(c.search_public_chat, "natchan")],
}


class TestSixteenMethods:
    def test_protocol_conformance(self, clients):
        assert isinstance(clients["port"], ttel.TelegramClient)
        assert isinstance(clients["ref"], jtel.TelegramClient)
        assert len(SCRIPTS) == 16

    @pytest.mark.parametrize("method", sorted(SCRIPTS))
    def test_method_matches_the_references(self, clients, tmp_path, method):
        out = both(clients, tmp_path, SCRIPTS[method])
        assert out and all(o[0] in ("ok", "error") for o in out)

    def test_history_pagination(self, clients, tmp_path):
        """Pages of one message, newest first, down to the exhausted
        page."""
        def pages(c):
            chat = _chat(c)
            out, cursor = [], 0
            for _ in range(10):
                page = c.get_chat_history(chat.id, from_message_id=cursor,
                                          limit=1)
                out.append(dataclasses.asdict(page))
                if not page.messages:
                    break
                cursor = page.messages[-1].id
            return out
        out = both(clients, tmp_path, pages)
        assert [len(p["messages"]) for p in out] == [1] * 6 + [0]
        ids = [p["messages"][0]["id"] for p in out[:-1]]
        assert ids == sorted(ids, reverse=True)
        assert out[0]["total_count"] == 6

    def test_thread_replies(self, clients, tmp_path):
        def thread(c):
            chat = _chat(c)
            root = next(m for m in _history(c)
                        if m.message_thread_id and m.reply_to_message_id
                        == 0)
            return [outcome(c.get_message_thread, chat.id, root.id),
                    outcome(c.get_message_thread_history, chat.id,
                            root.id)]
        out = both(clients, tmp_path, thread)
        assert out[0][0] == "ok"

    def test_file_lifecycle(self, clients, tmp_path):
        """Downloaded into the files dir, then deleted from it."""
        for name, c in clients.items():
            f = c.get_remote_file("r1")
            assert not f.downloaded
            got = c.download_file(f.id)
            assert got.downloaded and os.path.exists(got.local_path)
            assert got.local_path.startswith(str(tmp_path / name))
            c.delete_file(f.id)
            assert not os.path.exists(got.local_path)


class TestErrors:
    def test_unknown_channel_is_400(self, clients, tmp_path):
        out = both(clients, tmp_path,
                   lambda c: [outcome(c.search_public_chat, "ghost")])
        assert out[0][:3] == ["error", "TelegramError", 400]
        assert "USERNAME_NOT_OCCUPIED" in out[0][3]

    def test_missing_message_is_400(self, clients, tmp_path):
        out = both(clients, tmp_path, lambda c: [
            outcome(c.get_message, _chat(c).id, 999999999)])
        assert out[0][:3] == ["error", "TelegramError", 400]

    @pytest.mark.parametrize("seconds", [1, 33, 301])
    def test_flood_wait_maps_to_typed_error(self, seconds):
        """The rule raises once, as FloodWaitError with its seconds; the
        next call succeeds."""
        got = {}
        for name, P in PKGS.items():
            c = P.nat.NativeTelegramClient(seed_json=seed_doc(3, flood=[
                {"method": "searchPublicChat", "seconds": seconds,
                 "count": 1}]))
            try:
                first = outcome(c.search_public_chat, "natchan")
                try:
                    c.search_public_chat("linked_chan")
                    err = None
                except Exception as e:  # noqa: BLE001
                    err = e
                got[name] = (first, repr(err),
                             outcome(c.search_public_chat, "natchan"))
            finally:
                c.close()
        assert got["port"] == got["ref"]
        assert got["port"][0] == ("error", "FloodWaitError", 429,
                                  f"FLOOD_WAIT_{seconds}")
        assert got["port"][2][0] == "ok"

    def test_raise_for_error_matches_the_references(self):
        """The error frame's mapping, frame by frame."""
        frames = [{"@type": "error", "code": 429,
                   "message": "Too Many Requests: retry after 17"},
                  {"@type": "error", "code": 429, "message": "retry after x"},
                  {"@type": "error", "code": 429, "message": "FLOOD_WAIT_3"},
                  {"@type": "error", "code": 400,
                   "message": "USERNAME_INVALID"},
                  {"@type": "error", "message": "no code"},
                  {"@type": "chat", "id": 1}]
        for frame in frames:
            assert outcome(tnat._raise_for_error, frame) == \
                outcome(jnat._raise_for_error, frame)


class TestAuthLadder:
    def _pair(self, **kw):
        return {name: P.nat.NativeTelegramClient(
            seed_json=seed_doc(5), require_auth=True, **kw)
            for name, P in PKGS.items()}

    def _close(self, made):
        for c in made.values():
            c.close()

    def test_full_ladder_to_ready(self):
        made = self._pair(expected_code="12345")
        try:
            got = {}
            for name, c in made.items():
                before = outcome(c.search_public_chat, "natchan")
                c.authenticate("+15550100", "12345", api_id="94575",
                               api_hash="abc")
                got[name] = (before, outcome(c.search_public_chat,
                                             "natchan"))
            assert got["port"] == got["ref"]
            assert got["port"][0][:3] == ("error", "TelegramError", 401)
            assert got["port"][1][0] == "ok"
        finally:
            self._close(made)

    def test_wrong_code_rejected(self):
        made = self._pair(expected_code="12345")
        try:
            got = {name: outcome(c.authenticate, "+15550100", "99999")
                   for name, c in made.items()}
            assert got["port"] == got["ref"]
            assert "PHONE_CODE_INVALID" in got["port"][3]
        finally:
            self._close(made)

    def test_wrong_password_then_the_right_one(self):
        made = self._pair(expected_code="1", expected_password="hunter2")
        try:
            got = {}
            for name, c in made.items():
                wrong = outcome(c.authenticate, "+1555", "1",
                                password="wrong")
                right = outcome(c._call, {
                    "@type": "checkAuthenticationPassword",
                    "password": "hunter2"})
                got[name] = (wrong, right[0],
                             outcome(c.search_public_chat, "natchan"))
            assert got["port"] == got["ref"]
            assert "PASSWORD_HASH_INVALID" in got["port"][0][3]
            assert got["port"][1:] == ("ok", got["port"][2])
        finally:
            self._close(made)

    @pytest.mark.parametrize("step", [
        {"@type": "checkAuthenticationCode", "code": "123"},
        {"@type": "checkAuthenticationPassword", "password": "x"},
        {"@type": "setAuthenticationPhoneNumber", "phone_number": "+1"}])
    def test_out_of_order_auth_rejected(self, step):
        made = self._pair()
        try:
            got = {name: outcome(c._call, step) for name, c in made.items()}
            assert got["port"] == got["ref"]
            assert got["port"][0] == "error" and "not expected" in \
                got["port"][3]
        finally:
            self._close(made)

    ENV = {"TG_API_ID": "94575", "TG_API_HASH": "h",
           "TG_PHONE_NUMBER": "+15550100", "TG_PHONE_CODE": "00000"}

    @pytest.mark.parametrize("password", ["", "pw2"])
    def test_generate_pcode_writes_credentials(self, tmp_path, password):
        """Equal files, mode 0600, read back by `load_credentials`."""
        env = dict(self.ENV, **({"TG_PASSWORD": password} if password
                                else {}))
        files = {}
        for name, P in PKGS.items():
            client = P.nat.NativeTelegramClient(
                seed_json=seed_doc(5), require_auth=True,
                expected_password=password)
            try:
                path = P.nat.generate_pcode(
                    tdlib_dir=str(tmp_path / name / ".tdlib"), env=env,
                    client=client)
            finally:
                client.close()
            assert oct(os.stat(path).st_mode & 0o777) == "0o600"
            with open(path, encoding="utf-8") as f:
                files[name] = (os.path.relpath(path, tmp_path / name),
                               f.read(), P.nat.load_credentials(
                                   str(tmp_path / name / ".tdlib"), env={}))
        assert files["port"] == files["ref"]
        assert json.loads(files["port"][1])["phone_number"] == "+15550100"
        assert files["port"][2]["password"] == password

    @pytest.mark.parametrize("env", [
        {}, {"TG_API_ID": "1"}, {"TG_PHONE_NUMBER": "+1"},
        {"TG_API_ID": "x1", "TG_PHONE_NUMBER": "+1"}])
    def test_generate_pcode_requires_env(self, tmp_path, env):
        got = {name: outcome(P.nat.generate_pcode,
                             tdlib_dir=str(tmp_path / name), env=env)
               for name, P in PKGS.items()}
        assert got["port"] == got["ref"]
        assert got["port"][:2] == ("error", "ValueError")

    def test_load_credentials_order(self, tmp_path):
        """The file first, then the TG_* environment, else None."""
        env = {"TG_PHONE_NUMBER": "+1999", "TG_API_ID": "7"}
        (tmp_path / "creds").mkdir()
        (tmp_path / "creds" / "credentials.json").write_text(json.dumps(
            {"phone_number": "+1222", "api_id": "3", "phone_code": "9"}))
        (tmp_path / "bad").mkdir()
        (tmp_path / "bad" / "credentials.json").write_text("{not json")
        cases = [(str(tmp_path / "creds"), env), (str(tmp_path / "bad"), env),
                 (str(tmp_path / "none"), env), (str(tmp_path / "none"), {})]
        for d, e in cases:
            assert tnat.load_credentials(d, env=e) == \
                jnat.load_credentials(d, env=e)

    def test_fnv32_matches_the_references(self):
        rng = np.random.default_rng(1)
        for s in ["", "conn_0", "conn-a", "été"] + [
                words(rng, 1, 3) for _ in range(16)]:
            assert tnat.fnv32(s) == jnat.fnv32(s)


def _crawl(P, tmp_path, client):
    sm = P.comp.CompositeStateManager(P.state.StateConfig(
        crawl_id="native1", crawl_execution_id="e1",
        storage_root=str(tmp_path), sql=P.state.SqlConfig(url=":memory:")))
    sm.initialize(["natchan"])
    cfg = P.conf.CrawlerConfig(crawl_id="native1", skip_media_download=True)
    page = sm.get_layer_by_depth(0)[0]
    discovered = P.run.run_for_channel(client, page, "", sm, cfg)
    jsonl = tmp_path / "native1" / "natchan" / "posts" / "posts.jsonl"
    posts = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    for p in posts:
        p.pop("capture_time", None)   # the wall clock at parse time
    return page.status, sorted(p.url for p in discovered), posts


class TestCrawlEngineOverNative:
    def test_full_channel_crawl(self, tmp_path):
        """`run_for_channel` over each package's native client: the same
        status, outlinks and stored posts."""
        got = {}
        for name, P in PKGS.items():
            client = P.nat.NativeTelegramClient(seed_json=seed_doc(11))
            try:
                got[name] = _crawl(P, tmp_path / name, client)
            finally:
                client.close()
        assert got["port"] == got["ref"]
        status, discovered, posts = got["port"]
        assert status == "fetched" and discovered == ["linked_chan"]
        assert len(posts) == 6

    def test_pool_with_native_factory(self):
        got = {}
        for name, P in PKGS.items():
            pool = P.pool.ConnectionPool(
                factory=P.nat.native_client_factory(seed_json=seed_doc(2)),
                database_urls=["db0", "db1"])
            try:
                n = pool.initialize()
                conn = pool.acquire(timeout_s=5)
                got[name] = (n, conn.conn_id, outcome(
                    conn.client.search_public_chat, "natchan"))
                pool.release(conn)
            finally:
                pool.close_all()
        assert got["port"] == got["ref"]
        assert got["port"][0] == 2

    def test_setup_pool_from_seed_db_urls(self, tmp_path):
        """Three connections over two tarballs: ``conn_<i>`` serves URL
        ``i mod 2`` from its own directory under
        ``<storage-root>/.tdlib/databases``, at the config's rate
        limits."""
        import tarfile

        urls = []
        for i in range(2):
            src = tmp_path / f"src{i}"
            src.mkdir()
            doc = json.loads(seed_doc(20 + i))
            doc["channels"][0]["title"] = f"Store {i}"
            (src / "seed.json").write_text(json.dumps(doc))
            path = tmp_path / f"db{i}.tar.gz"
            with tarfile.open(path, "w:gz") as tar:
                tar.add(src / "seed.json", arcname="db/seed.json")
            urls.append(str(path) if i else f"file://{path}")
        got = {}
        for name, P in PKGS.items():
            P.run.shutdown_connection_pool()
            root = tmp_path / name
            cfg = P.conf.CrawlerConfig(
                crawl_id="c1", storage_root=str(root),
                tdlib_database_urls=urls + [urls[0]])
            try:
                assert P.run.setup_pool_from_config(cfg) is True
                pool = P.run._pool
                titles = {}
                for _ in range(3):
                    conn = pool.acquire(timeout_s=5)
                    titles[conn.conn_id] = conn.client.search_public_chat(
                        "natchan").title
                for cid in titles:
                    pool.release(pool._conns[cid])
                dirs = sorted(os.listdir(root / ".tdlib" / "databases"))
                got[name] = (titles, dirs, dataclasses.asdict(
                    pool.rate_limit))
            finally:
                P.run.shutdown_connection_pool()
        assert got["port"] == got["ref"]
        titles, dirs, limits = got["port"]
        assert titles == {"conn_0": "Store 0", "conn_1": "Store 1",
                          "conn_2": "Store 0"}
        assert dirs == sorted(f"conn_{tnat.fnv32(f'conn_{i}'):08x}"
                              for i in range(3))
        assert limits == dataclasses.asdict(tconf.TelegramRateLimitConfig())


# -- the library's build --------------------------------------------------------
BUILD_SCRIPT = """
import json, pathlib, sys
from distributed_crawler_tpu_torch.clients import native
native.NATIVE_DIR = pathlib.Path(sys.argv[1])
native.BUILD_DIR = pathlib.Path(sys.argv[2])
b = native.build_library()
c = native.NativeTelegramClient(seed_json=sys.argv[3])
print(json.dumps({"path": str(b.path), "cached": b.cached,
                  "title": c.search_public_chat("natchan").title}))
c.close()
"""


def _native_copy(tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    for name in tnat.SOURCES:
        shutil.copyfile(os.path.join(ROOT, "native", name), src / name)
    return src


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The port's builder pointed at a copy of `native/` and an empty
    build directory, with nothing built in this process."""
    src = _native_copy(tmp_path)
    monkeypatch.setattr(tnat, "NATIVE_DIR", src)
    monkeypatch.setattr(tnat, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnat, "_build", None)
    return src, tmp_path / "build"


class TestLibraryBuild:
    def test_two_processes_build_one_copy(self, tmp_path):
        """Started together, one process compiles under the lock and the
        other loads its library; one .so, no temporary file left."""
        src = _native_copy(tmp_path)
        build = tmp_path / "build"
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "DCT_NATIVE_LIB")}
        env["PYTHONPATH"] = ROOT
        procs = [subprocess.Popen(
            [sys.executable, "-c", BUILD_SCRIPT, str(src), str(build),
             seed_doc(1)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for _ in range(2)]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
        assert sorted(o["cached"] for o in outs) == [False, True]
        assert len({o["path"] for o in outs}) == 1
        assert {o["title"] for o in outs} == {"Native Chan"}
        left = sorted(p.name for p in build.iterdir())
        assert left == [".lock", os.path.basename(outs[0]["path"])]

    @pytest.mark.parametrize("source", tnat.SOURCES)
    def test_every_source_is_in_the_key(self, fresh_build, source):
        """An edited source gets a library of its own."""
        src, _ = fresh_build
        cxx = tnat._compiler()
        before = tnat._target(cxx)
        with open(src / source, "a", encoding="utf-8") as f:
            f.write("\n// edited\n")
        after = tnat._target(cxx)
        assert before != after and after.parent == before.parent

    def test_failed_build_raises_with_the_compilers_output(self,
                                                           fresh_build):
        src, build = fresh_build
        with open(src / "dct_client.cc", "a", encoding="utf-8") as f:
            f.write('\n#error "broken on purpose"\n')
        with pytest.raises(RuntimeError) as ei:
            tnat.build_library()
        assert "broken on purpose" in str(ei.value)
        assert "building the native client failed" in str(ei.value)
        assert [p.name for p in build.iterdir()] == [".lock"]

    def test_missing_compiler_raises(self, fresh_build, monkeypatch):
        monkeypatch.setenv("CXX", "no-such-compiler-here")
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            tnat.build_library()

    def test_missing_sources_raise(self, fresh_build, monkeypatch,
                                   tmp_path):
        monkeypatch.setattr(tnat, "NATIVE_DIR", tmp_path / "nowhere")
        with pytest.raises(FileNotFoundError, match="checkout"):
            tnat.build_library()

    def test_nothing_is_written_under_native(self):
        """The repository's `native/` is the same before and after the
        port's build and load."""
        native = os.path.join(ROOT, "native")

        def listing():
            return sorted((n, os.stat(os.path.join(native, n)).st_mtime_ns)
                          for n in os.listdir(native))
        before = listing()
        lib = tnat.build_library()
        tnat.load_library()
        assert listing() == before
        assert lib.path.parent == tnat.PACKAGE_DIR / "_build" / "native"
        assert lib.path.is_file()

    def test_an_explicit_path_and_dct_native_lib_come_first(
            self, tmp_path, monkeypatch):
        built = str(tnat.build_library().path)
        copy = str(tmp_path / "libcopy.so")
        shutil.copyfile(built, copy)
        monkeypatch.setenv("DCT_NATIVE_LIB", copy)
        assert tnat.find_library() == copy
        assert tnat.find_library(built) == built
        c = tnat.NativeTelegramClient(seed_json=seed_doc(1), lib_path=copy)
        try:
            assert c.search_public_chat("natchan").title == "Native Chan"
        finally:
            c.close()
        monkeypatch.setenv("DCT_NATIVE_LIB", str(tmp_path / "missing.so"))
        with pytest.raises(FileNotFoundError):
            tnat.find_library()
