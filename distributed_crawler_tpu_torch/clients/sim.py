"""In-process Telegram network simulation: the port's copy of the
reference's `distributed_crawler_tpu/clients/sim.py`.

A `SimNetwork` holds channels, messages, comments and files, and any
number of `SimTelegramClient`s connect to it.  It injects faults
(FLOOD_WAIT, 400s, connection errors) and models latency, so the
reactive GetMessage limiter and the cache attribution run as they would
against a server.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .errors import FloodWaitError, TelegramError
from .rate_limiter import Clock
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


@dataclass
class SimChannel:
    """A public supergroup/channel in the simulated network."""

    username: str
    chat_id: int
    title: str = ""
    description: str = ""
    member_count: int = 1000
    is_channel: bool = True
    is_supergroup: bool = True
    messages: List[TLMessage] = field(default_factory=list)
    # Assigned by SimNetwork; always nonzero so it never collides with the
    # TLChat "no supergroup" default of 0.
    supergroup_id: int = 0


class SimNetwork:
    """Shared simulated Telegram backend."""

    def __init__(self, cache_latency_s: float = 0.001,
                 server_latency_s: float = 0.02):
        self.cache_latency_s = cache_latency_s
        self.server_latency_s = server_latency_s
        self._lock = threading.RLock()
        self.channels: Dict[str, SimChannel] = {}
        self.by_chat_id: Dict[int, SimChannel] = {}
        self.files: Dict[str, bytes] = {}
        self.comments: Dict[Tuple[int, int], List[TLMessage]] = {}
        # method -> list of pending injected errors (popped per call)
        self._faults: Dict[str, List[BaseException]] = {}
        self._next_chat_id = 1_000_000_000_000
        self._next_supergroup_id = 1

    # --- topology ---------------------------------------------------------
    def add_channel(self, username: str, messages: Optional[List[TLMessage]] = None,
                    **kw) -> SimChannel:
        with self._lock:
            chat_id = kw.pop("chat_id", None)
            if chat_id is None:
                while self._next_chat_id in self.by_chat_id:
                    self._next_chat_id += 1
                chat_id = self._next_chat_id
                self._next_chat_id += 1
            supergroup_id = kw.pop("supergroup_id", None)
            if supergroup_id is None:
                used = {c.supergroup_id for c in self.channels.values()}
                while self._next_supergroup_id in used:
                    self._next_supergroup_id += 1
                supergroup_id = self._next_supergroup_id
                self._next_supergroup_id += 1
            ch = SimChannel(username=username.lower(), chat_id=chat_id,
                            title=kw.pop("title", username),
                            supergroup_id=supergroup_id, **kw)
            for i, m in enumerate(messages or []):
                m.chat_id = chat_id
                if not m.id:
                    m.id = (i + 1) * 1048576  # TDLib-style message IDs
            ch.messages = list(messages or [])
            self.channels[ch.username] = ch
            self.by_chat_id[chat_id] = ch
            return ch

    def add_file(self, remote_id: str, content: bytes) -> None:
        with self._lock:
            self.files[remote_id] = content

    def add_comments(self, chat_id: int, message_id: int,
                     comments: List[TLMessage]) -> None:
        with self._lock:
            self.comments[(chat_id, message_id)] = list(comments)

    # --- fault injection --------------------------------------------------
    def inject_fault(self, method: str, error: BaseException, count: int = 1) -> None:
        with self._lock:
            self._faults.setdefault(method, []).extend([error] * count)

    def inject_flood_wait(self, method: str, seconds: int, count: int = 1) -> None:
        self.inject_fault(method, FloodWaitError(seconds), count)

    def _check_fault(self, method: str) -> None:
        with self._lock:
            pending = self._faults.get(method)
            if pending:
                raise pending.pop(0)


class SimTelegramClient:
    """A client connected to a SimNetwork, implementing the 16-method surface.

    Maintains a per-client local message cache: the first fetch of a message
    is a "server" call (server latency), repeats are cache hits — mirroring
    TDLib's local SQLite DB and driving the reactive GetMessage limiter.
    """

    def __init__(self, network: SimNetwork, conn_id: str = "conn0",
                 clock: Optional[Clock] = None):
        self.network = network
        self.conn_id = conn_id
        self.clock = clock
        self.closed = False
        self.calls: List[Tuple[str, tuple]] = []
        self._message_cache: Set[Tuple[int, int]] = set()
        self._downloaded: Dict[int, TLFile] = {}
        self._next_file_id = 1

    # --- internals --------------------------------------------------------
    def _call(self, method: str, *args, server: bool = True) -> None:
        if self.closed:
            raise TelegramError(500, "client closed")
        self.calls.append((method, args))
        self.network._check_fault(method)
        if self.clock is not None:
            self.clock.sleep(self.network.server_latency_s if server
                             else self.network.cache_latency_s)

    def _chat(self, chat_id: int) -> "SimChannel":
        ch = self.network.by_chat_id.get(chat_id)
        if ch is None:
            raise TelegramError(400, "CHANNEL_INVALID")
        return ch

    # --- the 16 methods ---------------------------------------------------
    def get_message(self, chat_id: int, message_id: int) -> TLMessage:
        cached = (chat_id, message_id) in self._message_cache
        self._call("GetMessage", chat_id, message_id, server=not cached)
        ch = self._chat(chat_id)
        for m in ch.messages:
            if m.id == message_id:
                self._message_cache.add((chat_id, message_id))
                return m
        raise TelegramError(404, "message not found")

    def get_message_link(self, chat_id: int, message_id: int) -> TLMessageLink:
        self._call("GetMessageLink", chat_id, message_id, server=False)
        ch = self._chat(chat_id)
        return TLMessageLink(link=f"https://t.me/{ch.username}/{message_id // 1048576}",
                             is_public=True)

    def get_message_thread_history(self, chat_id: int, message_id: int,
                                   from_message_id: int = 0,
                                   limit: int = 100) -> TLMessages:
        self._call("GetMessageThreadHistory", chat_id, message_id)
        comments = self.network.comments.get((chat_id, message_id), [])
        return TLMessages(total_count=len(comments), messages=comments[:limit])

    def get_message_thread(self, chat_id: int, message_id: int) -> TLMessageThreadInfo:
        self._call("GetMessageThread", chat_id, message_id)
        comments = self.network.comments.get((chat_id, message_id), [])
        if not comments:
            raise TelegramError(400, "message thread not found")
        return TLMessageThreadInfo(chat_id=chat_id, message_thread_id=message_id,
                                   reply_count=len(comments))

    def get_remote_file(self, remote_file_id: str) -> TLFile:
        self._call("GetRemoteFile", remote_file_id, server=False)
        if remote_file_id not in self.network.files:
            raise TelegramError(400, "file not found")
        file_id = self._next_file_id
        self._next_file_id += 1
        f = TLFile(id=file_id, remote_id=remote_file_id,
                   size=len(self.network.files[remote_file_id]))
        self._downloaded[file_id] = f
        return f

    def download_file(self, file_id: int) -> TLFile:
        self._call("DownloadFile", file_id)
        f = self._downloaded.get(file_id)
        if f is None:
            raise TelegramError(400, "unknown file id")
        import os
        import tempfile
        fd, path = tempfile.mkstemp(prefix=f"sim_{self.conn_id}_")
        with os.fdopen(fd, "wb") as out:
            out.write(self.network.files[f.remote_id])
        f.local_path = path
        f.downloaded = True
        return f

    def get_chat_history(self, chat_id: int, from_message_id: int = 0,
                         offset: int = 0, limit: int = 100) -> TLMessages:
        self._call("GetChatHistory", chat_id, from_message_id, limit)
        ch = self._chat(chat_id)
        # TDLib returns newest-first, strictly older than from_message_id
        # (0 = from the latest).
        ordered = sorted(ch.messages, key=lambda m: -m.id)
        if from_message_id:
            ordered = [m for m in ordered if m.id < from_message_id]
        page = ordered[:limit]
        for m in page:
            self._message_cache.add((chat_id, m.id))
        return TLMessages(total_count=len(ch.messages), messages=page)

    def search_public_chat(self, username: str) -> TLChat:
        self._call("SearchPublicChat", username)
        ch = self.network.channels.get(username.lower())
        if ch is None:
            raise TelegramError(400, "USERNAME_NOT_OCCUPIED")
        return TLChat(id=ch.chat_id, title=ch.title,
                      type="supergroup" if ch.is_supergroup else "private",
                      supergroup_id=ch.supergroup_id)

    def get_chat(self, chat_id: int) -> TLChat:
        self._call("GetChat", chat_id, server=False)
        ch = self._chat(chat_id)
        return TLChat(id=ch.chat_id, title=ch.title,
                      type="supergroup" if ch.is_supergroup else "private",
                      supergroup_id=ch.supergroup_id)

    def get_supergroup(self, supergroup_id: int) -> TLSupergroup:
        self._call("GetSupergroup", supergroup_id, server=False)
        for ch in self.network.channels.values():
            if ch.supergroup_id == supergroup_id:
                return TLSupergroup(id=supergroup_id, username=ch.username,
                                    member_count=ch.member_count,
                                    is_channel=ch.is_channel)
        raise TelegramError(400, "SUPERGROUP_INVALID")

    def get_supergroup_full_info(self, supergroup_id: int) -> TLSupergroupFullInfo:
        self._call("GetSupergroupFullInfo", supergroup_id)
        for ch in self.network.channels.values():
            if ch.supergroup_id == supergroup_id:
                return TLSupergroupFullInfo(description=ch.description,
                                            member_count=ch.member_count)
        raise TelegramError(400, "SUPERGROUP_INVALID")

    def close(self) -> None:
        self.closed = True

    def get_me(self) -> TLUser:
        self._call("GetMe", server=False)
        return TLUser(id=1, username=f"sim_{self.conn_id}")

    def get_basic_group_full_info(self, basic_group_id: int) -> TLBasicGroupFullInfo:
        self._call("GetBasicGroupFullInfo", basic_group_id)
        raise TelegramError(400, "BASIC_GROUP_INVALID")

    def get_user(self, user_id: int) -> TLUser:
        self._call("GetUser", user_id, server=False)
        return TLUser(id=user_id, username=f"user{user_id}")

    def delete_file(self, file_id: int) -> None:
        self._call("DeleteFile", file_id, server=False)
        f = self._downloaded.pop(file_id, None)
        if f is not None and f.local_path:
            import os
            try:
                os.remove(f.local_path)
            except OSError:
                pass
