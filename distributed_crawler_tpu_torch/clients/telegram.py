"""The Telegram client boundary: the port's copy of the reference's
`distributed_crawler_tpu/clients/telegram.py`, the light TL dataclasses
(only the fields the crawl engine reads) and the 16-method
`TelegramClient` protocol.  `sim.SimTelegramClient` and
`native.NativeTelegramClient` implement it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Protocol, runtime_checkable


@dataclass
class TLFile:
    """A file handle (local + remote state)."""

    id: int = 0
    remote_id: str = ""
    local_path: str = ""
    size: int = 0
    downloaded: bool = False


@dataclass
class TLMessage:
    """A message.  `content` is a tagged dict, {"@type": "messageText",
    "text": ..., ...}, after TDLib's content-type union."""

    id: int = 0
    chat_id: int = 0
    date: int = 0  # unix seconds
    content: Dict[str, Any] = field(default_factory=dict)
    view_count: int = 0
    forward_count: int = 0
    reply_count: int = 0
    reactions: Dict[str, int] = field(default_factory=dict)
    message_thread_id: int = 0
    reply_to_message_id: int = 0
    sender_id: int = 0
    sender_username: str = ""
    is_channel_post: bool = False


@dataclass
class TLMessages:
    total_count: int = 0
    messages: List[TLMessage] = field(default_factory=list)


@dataclass
class TLChat:
    id: int = 0
    title: str = ""
    type: str = "supergroup"  # supergroup | basic_group | private | secret
    supergroup_id: int = 0
    basic_group_id: int = 0
    photo_remote_id: str = ""


@dataclass
class TLSupergroup:
    id: int = 0
    username: str = ""
    member_count: int = 0
    is_channel: bool = True
    date: int = 0
    is_verified: bool = False


@dataclass
class TLSupergroupFullInfo:
    description: str = ""
    member_count: int = 0
    photo_remote_id: str = ""


@dataclass
class TLBasicGroupFullInfo:
    description: str = ""
    members_count: int = 0


@dataclass
class TLUser:
    id: int = 0
    username: str = ""
    first_name: str = ""
    last_name: str = ""


@dataclass
class TLMessageLink:
    link: str = ""
    is_public: bool = True


@dataclass
class TLMessageThreadInfo:
    chat_id: int = 0
    message_thread_id: int = 0
    reply_count: int = 0


@runtime_checkable
class TelegramClient(Protocol):
    """The 16-method client surface."""

    def get_message(self, chat_id: int, message_id: int) -> TLMessage: ...

    def get_message_link(self, chat_id: int, message_id: int) -> TLMessageLink: ...

    def get_message_thread_history(self, chat_id: int, message_id: int,
                                   from_message_id: int = 0,
                                   limit: int = 100) -> TLMessages: ...

    def get_message_thread(self, chat_id: int, message_id: int) -> TLMessageThreadInfo: ...

    def get_remote_file(self, remote_file_id: str) -> TLFile: ...

    def download_file(self, file_id: int) -> TLFile: ...

    def get_chat_history(self, chat_id: int, from_message_id: int = 0,
                         offset: int = 0, limit: int = 100) -> TLMessages: ...

    def search_public_chat(self, username: str) -> TLChat: ...

    def get_chat(self, chat_id: int) -> TLChat: ...

    def get_supergroup(self, supergroup_id: int) -> TLSupergroup: ...

    def get_supergroup_full_info(self, supergroup_id: int) -> TLSupergroupFullInfo: ...

    def close(self) -> None: ...

    def get_me(self) -> TLUser: ...

    def get_basic_group_full_info(self, basic_group_id: int) -> TLBasicGroupFullInfo: ...

    def get_user(self, user_id: int) -> TLUser: ...

    def delete_file(self, file_id: int) -> None: ...
