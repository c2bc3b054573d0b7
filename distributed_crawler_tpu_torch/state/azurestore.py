"""``azure://``: the object-store client for Azure Blob Storage.

The port's copy of the reference's `distributed_crawler_tpu/state/
azurestore.py`: the Blob service REST API over the standard library's
HTTP with Shared Key signing (`SharedKeySigner`).  Multipart uploads map
onto block blobs: ``create_multipart`` mints a client-side upload id,
``upload_part`` is Put Block with block id b64("{upload_id}:{part:06d}"),
``complete_multipart`` is Put Block List in part order, and
``abort_multipart`` does nothing (the service collects uncommitted
blocks after 7 days).

    azure://account/container/prefix?endpoint=http://127.0.0.1:10000/account

Credentials: ``AZURE_STORAGE_KEY`` (the base64 account key; the URL's
``account_key`` is for tests).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import Dict, List, Optional, Tuple

from .objectstore import KeepAliveHttpTransport

API_VERSION = "2021-08-06"
TIMEOUT_S = 30.0  # per request; the reference's default


class SharedKeySigner:
    """Azure Storage Shared Key authorization (Blob service)."""

    def __init__(self, account: str, key_b64: str):
        self.account = account
        try:
            self.key = base64.b64decode(key_b64)
        except Exception as e:
            raise ValueError(f"azure account key is not base64: {e}") from e

    def sign(self, method: str, path: str, query: List[Tuple[str, str]],
             headers: Dict[str, str], content_length: int) -> str:
        """Returns the Authorization header value.  ``headers`` must
        already contain every x-ms-* header that will be sent."""
        xms = sorted((k.lower(), v.strip()) for k, v in headers.items()
                     if k.lower().startswith("x-ms-"))
        canonical_headers = "".join(f"{k}:{v}\n" for k, v in xms)
        resource = f"/{self.account}{path}"
        canonical_resource = resource + "".join(
            f"\n{k.lower()}:{v}" for k, v in sorted(query))
        string_to_sign = "\n".join([
            method,
            "",  # Content-Encoding
            "",  # Content-Language
            str(content_length) if content_length else "",
            "",  # Content-MD5
            headers.get("Content-Type", ""),
            "",  # Date (x-ms-date is used instead)
            "",  # If-Modified-Since
            "",  # If-Match
            "",  # If-None-Match
            "",  # If-Unmodified-Since
            "",  # Range
        ]) + "\n" + canonical_headers + canonical_resource
        sig = base64.b64encode(
            hmac.new(self.key, string_to_sign.encode("utf-8"),
                     hashlib.sha256).digest()).decode("ascii")
        return f"SharedKey {self.account}:{sig}"


class AzureBlobObjectClient:
    """`ObjectStoreClient` over the Azure Blob REST API."""

    def __init__(self, account: str, container: str, prefix: str = "",
                 endpoint: str = "", account_key: str = ""):
        self.account = account
        self.container = container
        self.prefix = prefix.strip("/")
        account_key = account_key or os.environ.get("AZURE_STORAGE_KEY", "")
        if not account_key:
            raise ValueError(
                "azure:// needs credentials: set AZURE_STORAGE_KEY")
        self._signer = SharedKeySigner(account, account_key)
        if endpoint:
            u = urllib.parse.urlsplit(endpoint)
            tls = u.scheme == "https"
            host = u.netloc
            # Azurite-style endpoints carry the account in the path.
            self._base = u.path.rstrip("/")
        else:
            tls = True
            host = f"{account}.blob.core.windows.net"
            self._base = ""
        self._http = KeepAliveHttpTransport(host, tls, TIMEOUT_S, "azure")

    # -- transport ---------------------------------------------------------
    def _blob_path(self, key: str) -> str:
        full = f"{self.prefix}/{key}" if self.prefix else key
        return (f"{self._base}/{self.container}/" +
                urllib.parse.quote(full, safe="/-._~"))

    def _container_path(self) -> str:
        return f"{self._base}/{self.container}"

    def _request(self, method: str, path: str,
                 query: Optional[List[Tuple[str, str]]] = None,
                 body: bytes = b"",
                 extra_headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        query = query or []
        headers = {
            # formatdate: locale-independent RFC 1123 (strftime's %a/%b
            # would emit localized day/month names and real Azure would
            # 403 every request under a non-English LC_TIME).
            "x-ms-date": formatdate(usegmt=True),
            "x-ms-version": API_VERSION,
        }
        if extra_headers:
            headers.update(extra_headers)
        if body:
            headers["Content-Length"] = str(len(body))
        # CanonicalizedResource is "/" + account + FULL request URI path —
        # so for an Azurite-style endpoint (account as the first path
        # segment) the account name legitimately appears twice
        # ("/acct/acct/container/blob"); do NOT strip the base.
        headers["Authorization"] = self._signer.sign(
            method, urllib.parse.unquote(path), query, headers,
            len(body))
        qs = urllib.parse.urlencode(sorted(query))
        url = path + (f"?{qs}" if qs else "")
        return self._http.http_request(method, url, body, headers)

    def close(self) -> None:
        self._http.close()

    def _raise_for(self, status: int, method: str, what: str,
                   body: bytes) -> None:
        self._http.raise_for(status, method, what, body)

    # -- ObjectStoreClient protocol ---------------------------------------
    def put_object(self, key: str, data: bytes) -> None:
        status, _, body = self._request(
            "PUT", self._blob_path(key), body=data,
            extra_headers={"x-ms-blob-type": "BlockBlob"})
        self._raise_for(status, "PUT", key, body)

    def get_object(self, key: str) -> Optional[bytes]:
        status, _, body = self._request("GET", self._blob_path(key))
        if status == 404:
            return None
        self._raise_for(status, "GET", key, body)
        return body

    def head_object(self, key: str) -> Optional[int]:
        status, headers, body = self._request("HEAD", self._blob_path(key))
        if status == 404:
            return None
        self._raise_for(status, "HEAD", key, body)
        cl = {k.lower(): v for k, v in headers.items()}.get(
            "content-length")
        return int(cl) if cl is not None else 0

    def list_objects(self, prefix: str) -> List[str]:
        full_prefix = (f"{self.prefix}/{prefix}" if self.prefix
                       else prefix)
        keys: List[str] = []
        marker = ""
        while True:
            query = [("restype", "container"), ("comp", "list"),
                     ("prefix", full_prefix)]
            if marker:
                query.append(("marker", marker))
            status, _, body = self._request("GET", self._container_path(),
                                            query=query)
            self._raise_for(status, "LIST", prefix, body)
            root = ET.fromstring(body)
            for el in root.iter("Name"):
                k = el.text or ""
                if self.prefix and k.startswith(self.prefix + "/"):
                    k = k[len(self.prefix) + 1:]
                keys.append(k)
            nxt = root.find("NextMarker")
            if nxt is None or not (nxt.text or "").strip():
                break
            marker = nxt.text.strip()
        return sorted(keys)

    def delete_object(self, key: str) -> None:
        status, _, body = self._request("DELETE", self._blob_path(key))
        if status == 404:
            return
        self._raise_for(status, "DELETE", key, body)

    # -- multipart (block-blob mapping) ------------------------------------
    def create_multipart(self, key: str) -> str:
        # The id carries real entropy: block ids are namespaced by it, and
        # a deterministic id would let a retired-but-alive writer and its
        # replacement stage IDENTICAL block ids against the same blob —
        # last-write-wins per block id, silently interleaving the two
        # uploads.  uuid4 alone (no counter) keeps the width FIXED forever:
        # Azure requires equal-length block ids per blob, including stale
        # uncommitted blocks from crashed writers.
        return f"up{uuid.uuid4().hex[:16]}"

    @staticmethod
    def _block_id(upload_id: str, part_no: int) -> str:
        # Block ids must be base64, equal length within a blob.
        return base64.b64encode(
            f"{upload_id}:{part_no:06d}".encode("ascii")).decode("ascii")

    def upload_part(self, key: str, upload_id: str, part_no: int,
                    data: bytes) -> str:
        block_id = self._block_id(upload_id, part_no)
        status, _, body = self._request(
            "PUT", self._blob_path(key),
            query=[("comp", "block"), ("blockid", block_id)], body=data)
        self._raise_for(status, "PUT?comp=block", f"{key}#{part_no}", body)
        return block_id

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[str]) -> None:
        # ``etags`` are the block ids returned by upload_part, in part
        # order — commit exactly those (a retried part appears once).
        payload = ("<?xml version=\"1.0\" encoding=\"utf-8\"?><BlockList>"
                   + "".join(f"<Latest>{bid}</Latest>" for bid in etags)
                   + "</BlockList>").encode("utf-8")
        status, _, body = self._request(
            "PUT", self._blob_path(key),
            query=[("comp", "blocklist")], body=payload,
            extra_headers={"Content-Type": "application/xml"})
        self._raise_for(status, "PUT?comp=blocklist", key, body)

    def abort_multipart(self, key: str, upload_id: str) -> None:
        # Uncommitted blocks are GC'd by the service after 7 days; there
        # is no client-side state to drop.
        return None


def parse_azure_url(url: str) -> AzureBlobObjectClient:
    """``azure://account/container[/prefix]?endpoint=…`` → client.

    Query params: ``endpoint`` (Azurite/emulator base URL incl. the
    account path segment; empty = the public
    ``{account}.blob.core.windows.net``) and — FOR TESTS ONLY —
    ``account_key`` (production keys belong in ``AZURE_STORAGE_KEY``)."""
    u = urllib.parse.urlsplit(url)
    if u.scheme != "azure" or not u.netloc:
        raise ValueError(f"not an azure URL: {url}")
    parts = u.path.strip("/").split("/", 1)
    if not parts or not parts[0]:
        raise ValueError(f"azure URL needs a container: {url}")
    q = dict(urllib.parse.parse_qsl(u.query))
    return AzureBlobObjectClient(
        account=u.netloc,
        container=parts[0],
        prefix=parts[1] if len(parts) > 1 else "",
        endpoint=q.get("endpoint", ""),
        account_key=q.get("account_key", ""),
    )
