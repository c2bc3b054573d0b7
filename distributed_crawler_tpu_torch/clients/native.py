"""The native Telegram client: the port's copy of the reference's
`distributed_crawler_tpu/clients/native.py`, a ctypes binding to the C++
client in the repository's `native/` over its td_json_client-style ABI:

    create(config_json) / send(request_json) / receive(timeout) /
    execute(request_json) / destroy

The library is built from `native/`'s sources and nothing else: at first
use ``g++`` compiles `native/dct_client.cc` with `native/Makefile`'s flags
into ``_build/native/`` (git-ignored), keyed by a hash of the five
sources, the compiler and the flags, under a file lock, to a temporary
name that `os.replace` publishes (`build_library`).  Nothing is written
under `native/`.  A failed build raises with the compiler's output.
``DCT_NATIVE_LIB`` or an explicit path is used first, as in the
reference.

Requests carry ``@type`` and an ``@extra`` correlation id; `_call` sends
and waits for the matching response and turns ``{"@type": "error"}`` into
the crawl engine's errors (`clients/errors.py`): code 429 with "retry
after N" is a FloodWaitError, any other code a TelegramError.

`NativeTelegramClient` implements the 16-method `TelegramClient` protocol
over the offline seed store (``seed_json``/``seed_db``) or, remote, over
the DCT-v1 JSON wire to a DC gateway (plain TCP or Chrome-shaped TLS),
with the auth ladder and ``PHONE_MIGRATE_X`` redirects through a DC
table.  The MTProto 2.0 wire (``wire="mtproto"``) is refused at
construction: it waits for the wire's half of ROADMAP Queue 1 part D.
`native_https_get` is the validator's Chrome-shaped HTTPS GET;
`acquire_seed_db` extracts a seed-DB tarball per connection and
`native_client_factory` makes a pool's clients.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import itertools
import json
import logging
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from .errors import FloodWaitError, TelegramError, parse_migrate_dc
from .telegram import (
    TLBasicGroupFullInfo,
    TLChat,
    TLFile,
    TLMessage,
    TLMessageLink,
    TLMessages,
    TLMessageThreadInfo,
    TLSupergroup,
    TLSupergroupFullInfo,
    TLUser,
)

logger = logging.getLogger("dct.clients.native")

PACKAGE_DIR = Path(__file__).resolve().parents[1]
NATIVE_DIR = PACKAGE_DIR.parent / "native"
BUILD_DIR = PACKAGE_DIR / "_build" / "native"
# What `native/Makefile` builds libdct_client.so from, and its flags.
SOURCES: Tuple[str, ...] = ("dct_client.cc", "json.h", "net.h", "mtproto.h",
                            "tl_api.h")
CXXFLAGS: Tuple[str, ...] = ("-O2", "-std=c++17", "-fPIC", "-Wall",
                             "-Wextra", "-pthread", "-shared")

MTPROTO_WAITS = (
    "the MTProto 2.0 wire (wire='mtproto', --dc-wire mtproto) waits for the "
    "wire's half of ROADMAP Queue 1 part D (clients/mtproto_wire.py, "
    "tl_api.py, dc_gateway.py); the port's native client speaks the dct "
    "wire")


@dataclass
class LibraryBuild:
    path: Path
    seconds: float   # the compiler's wall time; 0.0 when already built
    cached: bool


_lib_lock = threading.Lock()
_lib_cache: Dict[str, ctypes.CDLL] = {}
_build: Optional[LibraryBuild] = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"no C++ compiler ({cxx!r} not found): the "
                           f"native client is built from native/ at first "
                           f"use")
    return found


def _target(cxx: str) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0")
        h.update((NATIVE_DIR / name).read_bytes())
    h.update("\0".join((cxx,) + CXXFLAGS).encode())
    return BUILD_DIR / f"libdct_client-{h.hexdigest()[:16]}.so"


def build_library() -> LibraryBuild:
    """Compile `native/dct_client.cc` into ``_build/native/`` unless this
    version of the sources is built already.  Safe across processes: one
    builds under the lock, the others then find its library.  Raises
    RuntimeError with the compiler's output when the build fails."""
    global _build
    with _lib_lock:
        if _build is not None and _build.path.exists():
            return _build
        missing = [n for n in SOURCES if not (NATIVE_DIR / n).is_file()]
        if missing:
            raise FileNotFoundError(
                f"the native client's sources {missing} are not under "
                f"{NATIVE_DIR}: run from a checkout of the repository")
        cxx = _compiler()
        target = _target(cxx)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if target.exists():
                    _build = LibraryBuild(target, 0.0, True)
                    return _build
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [cxx, *CXXFLAGS, "-o", str(tmp),
                       str(NATIVE_DIR / "dct_client.cc")]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"building the native client failed (rc "
                        f"{proc.returncode}): {' '.join(cmd)}\n"
                        f"{proc.stderr}{proc.stdout}")
                os.replace(tmp, target)
                _build = LibraryBuild(target, seconds, False)
                return _build
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)


def find_library(path: Optional[str] = None) -> str:
    """The library to load: ``path``, else ``DCT_NATIVE_LIB``, else the one
    `build_library` builds from the repository's sources."""
    for c in (path, os.environ.get("DCT_NATIVE_LIB", "")):
        if c:
            if not os.path.exists(c):
                raise FileNotFoundError(f"native client library {c} not "
                                        f"found")
            return c
    return str(build_library().path)


def load_library(path: Optional[str] = None) -> ctypes.CDLL:
    resolved = find_library(path)
    with _lib_lock:
        lib = _lib_cache.get(resolved)
        if lib is not None:
            return lib
        # RTLD_LOCAL (ctypes' default): another copy of the library in the
        # same process keeps its own symbols.
        lib = ctypes.CDLL(resolved)
        lib.dct_client_create.restype = ctypes.c_void_p
        lib.dct_client_create.argtypes = [ctypes.c_char_p]
        lib.dct_client_send.restype = None
        lib.dct_client_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dct_client_receive.restype = ctypes.c_char_p
        lib.dct_client_receive.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.dct_client_execute.restype = ctypes.c_char_p
        lib.dct_client_execute.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dct_client_destroy.restype = None
        lib.dct_client_destroy.argtypes = [ctypes.c_void_p]
        lib.dct_https_get.restype = ctypes.c_char_p
        lib.dct_https_get.argtypes = [ctypes.c_char_p]
        _lib_cache[resolved] = lib
    logger.info("native client library loaded", extra={"path": resolved})
    return lib


def native_https_get(host: str, path: str = "/", port: int = 443,
                     headers: Optional[Dict[str, str]] = None,
                     sni: str = "", tls_insecure: bool = False,
                     plain: bool = False, max_body: int = 1 << 20,
                     lib_path: Optional[str] = None) -> Dict[str, Any]:
    """One GET through the native Chrome-shaped TLS stack
    (`native/net.h`).  Returns {"status": int, "body": bytes, "alpn": str
    [, "location": str]}; raises NativeClientError on a transport
    failure."""
    import base64

    lib = load_library(lib_path)
    cfg = {"host": host, "port": port, "path": path, "max_body": max_body}
    if headers:
        cfg["headers"] = dict(headers)
    if sni:
        cfg["sni"] = sni
    if tls_insecure:
        cfg["tls_insecure"] = True
    if plain:
        cfg["plain"] = True
    raw = lib.dct_https_get(json.dumps(cfg).encode("utf-8"))
    out = json.loads(raw.decode("utf-8"))
    if "error" in out:
        raise NativeClientError(500, out["error"])
    result = {"status": int(out["status"]),
              "body": base64.b64decode(out.get("body_b64", "")),
              "alpn": out.get("alpn", "")}
    if "location" in out:
        result["location"] = out["location"]
    return result


class NativeClientError(TelegramError):
    pass


def _raise_for_error(resp: Dict[str, Any]) -> None:
    if resp.get("@type") != "error":
        return
    code = int(resp.get("code") or 0)
    message = str(resp.get("message") or "")
    if code == 429 and "retry after" in message.lower():
        try:
            secs = int(message.lower().rsplit("retry after", 1)[1].strip())
        except (ValueError, IndexError):
            secs = 0
        raise FloodWaitError(secs)
    raise TelegramError(code, message)


class NativeTelegramClient:
    """The 16-method client over the C++ core."""

    def __init__(self, seed_db: str = "", seed_json: str = "",
                 lib_path: Optional[str] = None,
                 receive_timeout_s: float = 10.0, conn_id: str = "native0",
                 require_auth: bool = False, expected_code: str = "",
                 expected_password: str = "", server_addr: str = "",
                 tls: bool = False, tls_insecure: bool = False,
                 sni: str = "", wire: str = "",
                 server_pubkey_file: str = "",
                 dc_table: Optional[Dict[Any, Dict[str, str]]] = None):
        """Offline (the default): the C++ engine serves from a seed store.

        Remote (``server_addr="host:port"``): every request rides the DCT
        wire over a socket, plain TCP or, with ``tls=True``, TLS with a
        Chrome-shaped ClientHello; the server owns the store and the auth
        ladder, which `authenticate` walks.  ``dc_table`` maps a DC id to
        ``{"address": "host:port", "pubkey_file": "..."}``; with it,
        `authenticate` follows ``PHONE_MIGRATE_X`` to the account's home
        DC.  ``wire="mtproto"`` raises NotImplementedError."""
        if wire == "mtproto":
            raise NotImplementedError(MTPROTO_WAITS)
        self._lib = load_library(lib_path)
        self.conn_id = conn_id
        self.receive_timeout_s = receive_timeout_s
        self.dc_table = {str(k): dict(v)
                         for k, v in (dc_table or {}).items()}
        self.current_dc: Optional[int] = None
        self._remote_opts: Optional[Dict[str, Any]] = None
        config: Dict[str, Any] = {}
        if server_addr:
            self._remote_opts = dict(
                server_addr=server_addr, tls=tls,
                tls_insecure=tls_insecure, sni=sni, wire=wire,
                server_pubkey_file=server_pubkey_file)
            config = self._build_remote_config(self._remote_opts)
        elif seed_json:
            config["seed_json"] = seed_json
        elif seed_db:
            config["seed_db"] = seed_db
        if require_auth and not server_addr:
            config["require_auth"] = True
            if expected_code:
                config["expected_code"] = expected_code
            if expected_password:
                config["expected_password"] = expected_password
        self._handle = self._lib.dct_client_create(
            json.dumps(config).encode("utf-8"))
        if not self._handle:
            raise NativeClientError(
                500, "failed to create native client" +
                (f" (connect {server_addr} refused?)" if server_addr
                 else ""))
        self._extra = itertools.count(1)
        self._mu = threading.Lock()
        self._pending: Dict[str, Dict[str, Any]] = {}
        # Bounded: frames without @extra (auth state, events).
        self.updates: "collections.deque" = collections.deque(maxlen=256)
        self._transport_error: Optional[Dict[str, Any]] = None
        self._closed = False
        if not require_auth and not server_addr:
            self.wait_ready()

    @staticmethod
    def _build_remote_config(opts: Dict[str, Any]) -> Dict[str, Any]:
        config: Dict[str, Any] = {"server_addr": opts["server_addr"]}
        if opts.get("tls"):
            config["tls"] = True
        if opts.get("tls_insecure"):
            config["tls_insecure"] = True
        if opts.get("sni"):
            config["sni"] = opts["sni"]
        if opts.get("wire"):
            config["wire"] = opts["wire"]
        # server_pubkey_file is the MTProto wire's pinned key; the dct
        # wire has none to read.
        return config

    # -- the auth ladder ---------------------------------------------------
    def authenticate(self, phone_number: str, phone_code: str,
                     api_id: str = "", api_hash: str = "",
                     password: str = "",
                     database_directory: str = ".tdlib/database") -> None:
        """WaitTdlibParameters -> WaitPhoneNumber -> WaitCode
        [-> WaitPassword] -> Ready.  A ``PHONE_MIGRATE_X`` at the phone
        step reconnects to ``dc_table[X]`` and restarts the ladder there,
        at most 3 hops."""
        max_hops = 3
        for hop in range(max_hops):
            self._call({"@type": "setTdlibParameters",
                        "api_id": api_id, "api_hash": api_hash,
                        "database_directory": database_directory})
            try:
                self._call({"@type": "setAuthenticationPhoneNumber",
                            "phone_number": phone_number})
                break
            except TelegramError as e:
                dc = parse_migrate_dc(e)
                if dc is None or str(dc) not in self.dc_table:
                    raise
                if hop == max_hops - 1:
                    # Out of hops: keep the live connection.
                    raise NativeClientError(
                        500, f"too many DC migrations (last: {e.message})"
                    ) from e
                logger.info("DC migration: %s -> dc %d", e.message, dc,
                            extra={"conn_id": self.conn_id})
                self._reconnect_to_dc(dc)
        self._call({"@type": "checkAuthenticationCode",
                    "code": phone_code})
        if password:
            self._call({"@type": "checkAuthenticationPassword",
                        "password": password})

    def _reconnect_to_dc(self, dc: int) -> None:
        """A new connection to the DC table's entry (its address and
        pinned key), replacing this one and its session state."""
        if self._remote_opts is None:
            raise NativeClientError(500, "DC migration needs remote mode")
        entry = self.dc_table[str(dc)]
        opts = dict(self._remote_opts)
        opts["server_addr"] = entry["address"]
        if entry.get("pubkey_file"):
            opts["server_pubkey_file"] = entry["pubkey_file"]
        config = self._build_remote_config(opts)
        with self._mu:
            handle = self._lib.dct_client_create(
                json.dumps(config).encode("utf-8"))
            if not handle:
                raise NativeClientError(
                    500, f"failed to connect to dc {dc} "
                         f"({entry['address']} refused?)")
            self._lib.dct_client_destroy(self._handle)
            self._handle = handle
            self._pending.clear()
            self.updates.clear()
            self._transport_error = None
            self._remote_opts = opts
            self.current_dc = dc

    # -- plumbing ----------------------------------------------------------
    @staticmethod
    def _is_ready_update(resp: Dict[str, Any]) -> bool:
        return resp.get("@type") == "updateAuthorizationState" and \
            resp.get("authorization_state", {}).get("@type") == \
            "authorizationStateReady"

    def wait_ready(self, timeout_s: float = 10.0) -> None:
        """Drain updates until authorizationStateReady; the updates an
        earlier `_call` kept are checked first."""
        if any(self._is_ready_update(u) for u in self.updates):
            return
        resp = self._receive(timeout_s)
        while resp is not None:
            if self._is_ready_update(resp):
                self.updates.append(resp)
                return
            resp = self._receive(timeout_s)
        raise NativeClientError(500, "native client never became ready")

    def _receive(self, timeout_s: float) -> Optional[Dict[str, Any]]:
        raw = self._lib.dct_client_receive(self._handle,
                                           ctypes.c_double(timeout_s))
        if raw is None:
            return None
        return json.loads(raw.decode("utf-8"))

    def _call(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Send and wait for the correlated response; one call at a time
        per client."""
        extra = f"req{next(self._extra)}"
        request = dict(request)
        request["@extra"] = extra
        with self._mu:
            if self._closed:
                raise NativeClientError(500, "client is closed")
            if self._transport_error is not None:
                _raise_for_error(self._transport_error)
            self._lib.dct_client_send(self._handle,
                                      json.dumps(request).encode("utf-8"))
            deadline_attempts = max(1, int(self.receive_timeout_s / 0.5))
            for _ in range(deadline_attempts):
                resp = self._pending.pop(extra, None)
                if resp is None:
                    got = self._receive(0.5)
                    if got is None:
                        continue
                    if got.get("@extra") != extra:
                        key = got.get("@extra")
                        if key is not None:
                            self._pending[key] = got
                        elif got.get("@type") == "error" and \
                                got.get("transport"):
                            # The connection failed: this call and every
                            # later one raise at once.
                            self._transport_error = got
                            _raise_for_error(got)
                        else:
                            self.updates.append(got)
                        continue
                    resp = got
                _raise_for_error(resp)
                return resp
        raise NativeClientError(500, "timed out waiting for native response")

    # -- the 16 methods ----------------------------------------------------
    def get_message(self, chat_id: int, message_id: int) -> TLMessage:
        r = self._call({"@type": "getMessage", "chat_id": chat_id,
                        "message_id": message_id})
        return self._message(r)

    def get_message_link(self, chat_id: int, message_id: int) -> TLMessageLink:
        r = self._call({"@type": "getMessageLink", "chat_id": chat_id,
                        "message_id": message_id})
        return TLMessageLink(link=r.get("link", ""),
                             is_public=bool(r.get("is_public", True)))

    def get_message_thread_history(self, chat_id: int, message_id: int,
                                   from_message_id: int = 0,
                                   limit: int = 100) -> TLMessages:
        r = self._call({"@type": "getMessageThreadHistory",
                        "chat_id": chat_id, "message_id": message_id,
                        "from_message_id": from_message_id, "limit": limit})
        return self._messages(r)

    def get_message_thread(self, chat_id: int,
                           message_id: int) -> TLMessageThreadInfo:
        r = self._call({"@type": "getMessageThread", "chat_id": chat_id,
                        "message_id": message_id})
        return TLMessageThreadInfo(
            chat_id=int(r.get("chat_id", 0)),
            message_thread_id=int(r.get("message_thread_id", 0)),
            reply_count=int(r.get("reply_count", 0)))

    def get_remote_file(self, remote_file_id: str) -> TLFile:
        r = self._call({"@type": "getRemoteFile",
                        "remote_file_id": remote_file_id})
        return self._file(r)

    def download_file(self, file_id: int) -> TLFile:
        r = self._call({"@type": "downloadFile", "file_id": file_id})
        return self._file(r)

    def get_chat_history(self, chat_id: int, from_message_id: int = 0,
                         offset: int = 0, limit: int = 100) -> TLMessages:
        r = self._call({"@type": "getChatHistory", "chat_id": chat_id,
                        "from_message_id": from_message_id,
                        "offset": offset, "limit": limit})
        return self._messages(r)

    def search_public_chat(self, username: str) -> TLChat:
        r = self._call({"@type": "searchPublicChat", "username": username})
        return self._chat(r)

    def get_chat(self, chat_id: int) -> TLChat:
        r = self._call({"@type": "getChat", "chat_id": chat_id})
        return self._chat(r)

    def get_supergroup(self, supergroup_id: int) -> TLSupergroup:
        r = self._call({"@type": "getSupergroup",
                        "supergroup_id": supergroup_id})
        return TLSupergroup(
            id=int(r.get("id", 0)), username=r.get("username", ""),
            member_count=int(r.get("member_count", 0)),
            is_channel=bool(r.get("is_channel", True)),
            date=int(r.get("date", 0)),
            is_verified=bool(r.get("is_verified", False)))

    def get_supergroup_full_info(self,
                                 supergroup_id: int) -> TLSupergroupFullInfo:
        r = self._call({"@type": "getSupergroupFullInfo",
                        "supergroup_id": supergroup_id})
        return TLSupergroupFullInfo(
            description=r.get("description", ""),
            member_count=int(r.get("member_count", 0)),
            photo_remote_id=r.get("photo_remote_id", ""))

    def execute_raw(self, request_json: str) -> str:
        """A synchronous execute on the offline engine."""
        raw = self._lib.dct_client_execute(
            self._handle, request_json.encode("utf-8"))
        return raw.decode("utf-8") if raw else "{}"

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
        handle, self._handle = self._handle, None
        if handle:
            self._lib.dct_client_destroy(handle)

    def get_me(self) -> TLUser:
        r = self._call({"@type": "getMe"})
        return self._user(r)

    def get_basic_group_full_info(self,
                                  basic_group_id: int) -> TLBasicGroupFullInfo:
        r = self._call({"@type": "getBasicGroupFullInfo",
                        "basic_group_id": basic_group_id})
        return TLBasicGroupFullInfo(
            description=r.get("description", ""),
            members_count=int(r.get("members_count", 0)))

    def get_user(self, user_id: int) -> TLUser:
        r = self._call({"@type": "getUser", "user_id": user_id})
        return self._user(r)

    def delete_file(self, file_id: int) -> None:
        self._call({"@type": "deleteFile", "file_id": file_id})

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- converters --------------------------------------------------------
    @staticmethod
    def _message(r: Dict[str, Any]) -> TLMessage:
        return TLMessage(
            id=int(r.get("id", 0)), chat_id=int(r.get("chat_id", 0)),
            date=int(r.get("date", 0)), content=r.get("content") or {},
            view_count=int(r.get("view_count", 0)),
            forward_count=int(r.get("forward_count", 0)),
            reply_count=int(r.get("reply_count", 0)),
            reactions={k: int(v) for k, v in
                       (r.get("reactions") or {}).items()},
            message_thread_id=int(r.get("message_thread_id", 0)),
            reply_to_message_id=int(r.get("reply_to_message_id", 0)),
            sender_id=int(r.get("sender_id", 0)),
            sender_username=r.get("sender_username", ""),
            is_channel_post=bool(r.get("is_channel_post", False)))

    @classmethod
    def _messages(cls, r: Dict[str, Any]) -> TLMessages:
        return TLMessages(
            total_count=int(r.get("total_count", 0)),
            messages=[cls._message(m) for m in r.get("messages") or []])

    @staticmethod
    def _chat(r: Dict[str, Any]) -> TLChat:
        return TLChat(
            id=int(r.get("id", 0)), title=r.get("title", ""),
            type=r.get("type", "supergroup"),
            supergroup_id=int(r.get("supergroup_id", 0)),
            basic_group_id=int(r.get("basic_group_id", 0)),
            photo_remote_id=r.get("photo_remote_id", ""))

    @staticmethod
    def _file(r: Dict[str, Any]) -> TLFile:
        return TLFile(
            id=int(r.get("id", 0)), remote_id=r.get("remote_id", ""),
            local_path=r.get("local_path", ""),
            size=int(r.get("size", 0)),
            downloaded=bool(r.get("downloaded", False)))

    @staticmethod
    def _user(r: Dict[str, Any]) -> TLUser:
        return TLUser(
            id=int(r.get("id", 0)), username=r.get("username", ""),
            first_name=r.get("first_name", ""),
            last_name=r.get("last_name", ""))


def generate_pcode(tdlib_dir: str = ".tdlib",
                   env: Optional[Dict[str, str]] = None,
                   client: Optional[NativeTelegramClient] = None) -> str:
    """The auth bootstrap: reads TG_API_ID, TG_API_HASH, TG_PHONE_NUMBER,
    TG_PHONE_CODE (and TG_PASSWORD), walks the auth ladder on ``client``
    (by default the embedded engine with auth on) and writes
    ``{tdlib_dir}/credentials.json`` with mode 0600.  Returns its path."""
    env = env if env is not None else dict(os.environ)
    api_id = env.get("TG_API_ID", "")
    api_hash = env.get("TG_API_HASH", "")
    phone = env.get("TG_PHONE_NUMBER", "")
    code = env.get("TG_PHONE_CODE", "")
    password = env.get("TG_PASSWORD", "")
    if not api_id or not phone:
        raise ValueError("TG_API_ID and TG_PHONE_NUMBER are required")
    int(api_id)  # an api id is a number

    os.makedirs(tdlib_dir, exist_ok=True)
    owns_client = client is None
    if client is None:
        client = NativeTelegramClient(require_auth=True)
    try:
        client.authenticate(
            phone, code, api_id=api_id, api_hash=api_hash,
            password=password,
            database_directory=os.path.join(tdlib_dir, "database"))
        me = client.get_me()
        logger.info("authenticated", extra={
            "me": f"{me.first_name} {me.last_name}".strip()})
    finally:
        if owns_client:
            client.close()

    creds_path = os.path.join(tdlib_dir, "credentials.json")
    creds = {"api_id": api_id, "api_hash": api_hash,
             "phone_number": phone, "phone_code": code}
    if password:
        creds["password"] = password  # pools replay the 2FA leg too
    with open(creds_path, "w", encoding="utf-8") as f:
        json.dump(creds, f, indent=2)
    os.chmod(creds_path, 0o600)
    return creds_path


def load_credentials(tdlib_dir: str = ".tdlib",
                     env: Optional[Dict[str, str]] = None
                     ) -> Optional[Dict[str, str]]:
    """The auth ladder's credentials: ``{tdlib_dir}/credentials.json``
    (`generate_pcode`, ``--mode gen-code``) first, then the TG_*
    environment; None when neither has a phone number (offline stores
    need no auth)."""
    path = os.path.join(tdlib_dir, "credentials.json")
    try:
        with open(path, "r", encoding="utf-8") as f:
            creds = json.load(f)
        if creds.get("phone_number"):
            return {k: str(creds.get(k, "")) for k in
                    ("api_id", "api_hash", "phone_number", "phone_code",
                     "password")}
    except (OSError, ValueError):
        pass
    env = env if env is not None else dict(os.environ)
    if env.get("TG_PHONE_NUMBER"):
        return {"api_id": env.get("TG_API_ID", ""),
                "api_hash": env.get("TG_API_HASH", ""),
                "phone_number": env.get("TG_PHONE_NUMBER", ""),
                "phone_code": env.get("TG_PHONE_CODE", ""),
                "password": env.get("TG_PASSWORD", "")}
    return None


def fnv32(s: str) -> int:
    """FNV-1a, 32 bits: the per-connection database directory's hash."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def acquire_seed_db(source: str, base_dir: str, conn_id: str) -> str:
    """One connection's copy of a seed DB: ``source`` is a ``file://`` URL
    or a path to a ``.tar.gz``/``.tgz``/``.tar`` archive, a directory or a
    bare seed ``.json``; it is extracted or copied into
    ``{base_dir}/conn_{fnv32(conn_id):08x}/`` (so connections never share
    a directory) and the seed JSON's path inside is returned
    (``seed.json``, else the one ``*.json``).  The copy is reused while
    the source is unchanged and made again when it changes.  Any other
    URL scheme raises: mirror the tarball locally."""
    import tarfile
    from urllib.parse import urlsplit

    if "://" in source:
        parts = urlsplit(source)
        if parts.scheme != "file":
            raise NativeClientError(
                400, f"unsupported seed-db scheme {parts.scheme!r}: "
                     f"mirror the tarball locally and pass a file:// URL")
        source = parts.path
    if not os.path.exists(source):
        raise NativeClientError(400, f"seed db source not found: {source}")

    conn_dir = os.path.join(base_dir, f"conn_{fnv32(conn_id):08x}")

    # The copy is tagged with the source's identity: a directory by its
    # files' names, mtimes and sizes (a directory's own mtime does not
    # change when a file in it is edited), a file by its mtime and size.
    if os.path.isdir(source):
        entries = []
        for dirpath, _dn, filenames in os.walk(source):
            for name in sorted(filenames):
                fst = os.stat(os.path.join(dirpath, name))
                entries.append((os.path.relpath(
                    os.path.join(dirpath, name), source),
                    getattr(fst, "st_mtime_ns", int(fst.st_mtime * 1e9)),
                    fst.st_size))
        ident = {"entries": sorted(entries)}
    else:
        st = os.stat(source)
        ident = {"mtime_ns": getattr(st, "st_mtime_ns",
                                     int(st.st_mtime * 1e9)),
                 "size": st.st_size}
    source_tag = json.dumps({"source": os.path.abspath(source), **ident},
                            sort_keys=True)
    tag_path = os.path.join(conn_dir, ".seed_source.json")

    def _find_seed(root: str) -> str:
        preferred = None
        candidates = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in filenames:
                if name == "seed.json":
                    preferred = os.path.join(dirpath, name)
                elif name.endswith(".json") and not name.startswith("."):
                    candidates.append(os.path.join(dirpath, name))
        if preferred:
            return preferred
        if len(candidates) == 1:
            return candidates[0]
        raise NativeClientError(
            400, f"no unambiguous seed JSON under {root}: "
                 f"{len(candidates)} candidates")

    if os.path.isdir(conn_dir):
        try:
            with open(tag_path, "r", encoding="utf-8") as f:
                fresh = f.read() == source_tag
        except OSError:
            fresh = False  # untagged or tampered: extract again
        if fresh:
            return _find_seed(conn_dir)
        logger.info("seed db source changed for %s; re-extracting", conn_id)
        shutil.rmtree(conn_dir, ignore_errors=True)

    staging = conn_dir + ".tmp"
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging, exist_ok=True)
    try:
        if os.path.isdir(source):
            shutil.copytree(source, os.path.join(staging, "db"),
                            dirs_exist_ok=True)
        elif source.endswith((".tar.gz", ".tgz", ".tar")):
            with tarfile.open(source, "r:*") as tar:
                try:
                    tar.extractall(staging, filter="data")
                except TypeError:
                    # A Python without extractall's filter: refuse absolute
                    # and traversing paths, links and special files first.
                    members = tar.getmembers()
                    for m in members:
                        p = m.name
                        if p.startswith(("/", "..")) or "/../" in p:
                            raise NativeClientError(
                                400, f"unsafe path in seed tarball: {p}")
                        if m.issym() or m.islnk():
                            raise NativeClientError(
                                400, f"link member in seed tarball: {p}")
                        if not (m.isfile() or m.isdir()):
                            raise NativeClientError(
                                400, f"special member in seed tarball: {p}")
                    tar.extractall(staging, members=members)
        elif source.endswith(".json"):
            shutil.copyfile(source, os.path.join(staging, "seed.json"))
        else:
            raise NativeClientError(
                400, f"unrecognized seed db format: {source}")
        with open(os.path.join(staging, ".seed_source.json"), "w",
                  encoding="utf-8") as f:
            f.write(source_tag)
        os.replace(staging, conn_dir)
    except Exception:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    return _find_seed(conn_dir)


def load_dc_table(path: str) -> Dict[str, Dict[str, str]]:
    """A DC table's JSON, ``{"dcs": {...}}`` or the flat map, as
    {dc_id: {"address", "pubkey_file"}}."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    table = doc.get("dcs", doc) if isinstance(doc, dict) else None
    if not isinstance(table, dict):
        raise ValueError(f"dc table {path}: expected a {{dc_id: ...}} map")
    out: Dict[str, Dict[str, str]] = {}
    for dc, entry in table.items():
        if not isinstance(entry, dict) or not entry.get("address"):
            raise ValueError(f"dc table {path}: dc {dc} needs an address")
        out[str(dc)] = {"address": str(entry["address"]),
                        "pubkey_file": str(entry.get("pubkey_file", ""))}
    return out


def native_client_factory(seed_db: str = "", seed_json: str = "",
                          lib_path: Optional[str] = None,
                          db_source: str = "",
                          db_base_dir: str = ".tdlib/databases",
                          server_addr: str = "", tls: bool = False,
                          tls_insecure: bool = False, sni: str = "",
                          credentials: Optional[Dict[str, str]] = None,
                          tdlib_dir: str = ".tdlib", wire: str = "",
                          server_pubkey_file: str = "",
                          dc_table: Optional[Dict[Any, Dict[str,
                                                            str]]] = None):
    """A pool's factory: ``make(conn_id)`` returns a fresh client.  With
    ``db_source`` each connection serves its own extracted copy of the
    seed DB under ``{db_base_dir}/conn_<fnv32>``.  With ``server_addr``
    each client dials the DC gateway and walks the auth ladder with
    ``credentials`` (`load_credentials` of ``tdlib_dir`` by default)
    before it is handed out."""
    if wire == "mtproto":
        raise NotImplementedError(MTPROTO_WAITS)

    def make(conn_id: str) -> NativeTelegramClient:
        if server_addr:
            client = NativeTelegramClient(
                server_addr=server_addr, tls=tls,
                tls_insecure=tls_insecure, sni=sni, wire=wire,
                server_pubkey_file=server_pubkey_file,
                dc_table=dc_table,
                lib_path=lib_path, conn_id=conn_id)
            creds = credentials or load_credentials(tdlib_dir)
            if creds is None:
                client.close()
                raise NativeClientError(
                    401, "remote mode needs credentials: run `dct --mode "
                         "gen-code` or set TG_PHONE_NUMBER/TG_PHONE_CODE")
            try:
                client.authenticate(
                    creds["phone_number"], creds.get("phone_code", ""),
                    api_id=creds.get("api_id", ""),
                    api_hash=creds.get("api_hash", ""),
                    password=creds.get("password", ""))
                client.wait_ready()
            except Exception:
                client.close()
                raise
            return client
        per_conn_db = seed_db
        if db_source:
            per_conn_db = acquire_seed_db(db_source, db_base_dir, conn_id)
        return NativeTelegramClient(
            seed_db=per_conn_db, seed_json=seed_json, lib_path=lib_path,
            conn_id=conn_id)

    return make
