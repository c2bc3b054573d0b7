"""``s3://``: the object-store client for S3 and S3-compatible stores.

The port's copy of the reference's `distributed_crawler_tpu/state/
s3store.py`: the S3 REST API over the standard library's HTTP with AWS
Signature Version 4 (`SigV4Signer`), the whole `ObjectStoreClient`
surface, multipart upload included.

    s3://bucket/optional/prefix?endpoint=http://127.0.0.1:9000&region=us-east-1

Credentials come from ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY``
(the URL's ``access_key``/``secret_key`` are for tests).  An ``endpoint``
is addressed path-style (the bucket in the path), as S3-compatible
emulators expect; bare ``s3://bucket`` is AWS, virtual-host style.
5xx and connection errors raise `TransientStoreError` (the uploader
retries them); 4xx raise ``ValueError``; a 404 on get or head is None.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from .objectstore import KeepAliveHttpTransport, TransientStoreError

TIMEOUT_S = 30.0  # per request; the reference's default
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_encode(s: str, encode_slash: bool) -> str:
    """AWS SigV4 URI encoding: RFC 3986 with '~' unreserved."""
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


class SigV4Signer:
    """AWS Signature Version 4 for S3 (single-chunk payloads)."""

    def __init__(self, access_key: str, secret_key: str, region: str,
                 service: str = "s3"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service

    def sign(self, method: str, host: str, path: str,
             query: List[Tuple[str, str]], payload_sha256: str,
             now: Optional[_dt.datetime] = None) -> Dict[str, str]:
        """Returns the headers to attach (Host excluded — http.client sets
        it; it IS part of the signature)."""
        now = now or _dt.datetime.now(_dt.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        canonical_query = "&".join(
            f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
            for k, v in sorted(query))
        headers = {"host": host, "x-amz-content-sha256": payload_sha256,
                   "x-amz-date": amz_date}
        signed_names = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{k}:{headers[k].strip()}\n" for k in sorted(headers))
        canonical_request = "\n".join([
            method, _uri_encode(path, False) or "/", canonical_query,
            canonical_headers, signed_names, payload_sha256])
        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical_request.encode("utf-8")).hexdigest()])
        key = _hmac(_hmac(_hmac(_hmac(
            ("AWS4" + self.secret_key).encode("utf-8"), datestamp),
            self.region), self.service), "aws4_request")
        signature = hmac.new(key, string_to_sign.encode("utf-8"),
                             hashlib.sha256).hexdigest()
        return {
            "x-amz-content-sha256": payload_sha256,
            "x-amz-date": amz_date,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_names}, Signature={signature}"),
        }


class S3ObjectClient:
    """`ObjectStoreClient` over the S3 REST API (stdlib HTTP + SigV4)."""

    def __init__(self, bucket: str, prefix: str = "",
                 endpoint: str = "", region: str = "us-east-1",
                 access_key: str = "", secret_key: str = ""):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.region = region
        access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if not access_key or not secret_key:
            raise ValueError(
                "s3:// needs credentials: set AWS_ACCESS_KEY_ID / "
                "AWS_SECRET_ACCESS_KEY")
        self._signer = SigV4Signer(access_key, secret_key, region)
        if endpoint:
            u = urllib.parse.urlsplit(endpoint)
            tls = u.scheme == "https"
            host = u.netloc
            self._path_style = True  # the emulators' convention
        else:
            tls = True
            host = f"{bucket}.s3.{region}.amazonaws.com"
            self._path_style = False
        self._host = host
        self._http = KeepAliveHttpTransport(host, tls, TIMEOUT_S, "s3")

    # -- transport ---------------------------------------------------------
    def _object_path(self, key: str) -> str:
        full = f"{self.prefix}/{key}" if self.prefix else key
        base = f"/{self.bucket}" if self._path_style else ""
        return f"{base}/{full}"

    def _bucket_path(self) -> str:
        return f"/{self.bucket}" if self._path_style else "/"

    def _request(self, method: str, path: str,
                 query: Optional[List[Tuple[str, str]]] = None,
                 body: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        query = query or []
        payload_hash = (hashlib.sha256(body).hexdigest() if body
                        else _EMPTY_SHA256)
        headers = self._signer.sign(method, self._host, path, query,
                                    payload_hash)
        if body:
            headers["Content-Length"] = str(len(body))
        # The wire path/query must byte-match the canonical forms that were
        # signed (sorted query, SigV4 percent-encoding), or the server's
        # recomputed signature won't agree.
        qs = "&".join(f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
                      for k, v in sorted(query))
        url = _uri_encode(path, False) + (f"?{qs}" if qs else "")
        return self._http.http_request(method, url, body, headers)

    def close(self) -> None:
        self._http.close()

    def _raise_for(self, status: int, method: str, path: str,
                   body: bytes) -> None:
        self._http.raise_for(status, method, path, body)

    # -- ObjectStoreClient protocol ---------------------------------------
    def put_object(self, key: str, data: bytes) -> None:
        status, _, body = self._request("PUT", self._object_path(key),
                                        body=data)
        self._raise_for(status, "PUT", key, body)

    def get_object(self, key: str) -> Optional[bytes]:
        status, _, body = self._request("GET", self._object_path(key))
        if status == 404:
            return None
        self._raise_for(status, "GET", key, body)
        return body

    def head_object(self, key: str) -> Optional[int]:
        status, headers, body = self._request("HEAD", self._object_path(key))
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
        token = ""
        while True:
            query = [("list-type", "2"), ("prefix", full_prefix)]
            if token:
                query.append(("continuation-token", token))
            status, _, body = self._request("GET", self._bucket_path(),
                                            query=query)
            self._raise_for(status, "LIST", prefix, body)
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for el in root.iter(f"{ns}Key"):
                k = el.text or ""
                if self.prefix and k.startswith(self.prefix + "/"):
                    k = k[len(self.prefix) + 1:]
                keys.append(k)
            truncated = root.find(f"{ns}IsTruncated")
            if truncated is None or truncated.text != "true":
                break
            nxt = root.find(f"{ns}NextContinuationToken")
            if nxt is None or not nxt.text:
                break
            token = nxt.text
        return sorted(keys)

    def delete_object(self, key: str) -> None:
        status, _, body = self._request("DELETE", self._object_path(key))
        if status == 404:
            return
        self._raise_for(status, "DELETE", key, body)

    # -- multipart (the uploader's retry/resume surface) -------------------
    def create_multipart(self, key: str) -> str:
        status, _, body = self._request("POST", self._object_path(key),
                                        query=[("uploads", "")])
        self._raise_for(status, "POST?uploads", key, body)
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] if \
            root.tag.startswith("{") else ""
        el = root.find(f"{ns}UploadId")
        if el is None or not el.text:
            raise TransientStoreError(
                f"s3 create_multipart {key}: no UploadId in response")
        return el.text

    def upload_part(self, key: str, upload_id: str, part_no: int,
                    data: bytes) -> str:
        # The protocol's part_no is 0-based; S3 part numbers start at 1.
        status, headers, body = self._request(
            "PUT", self._object_path(key),
            query=[("partNumber", str(part_no + 1)),
                   ("uploadId", upload_id)], body=data)
        self._raise_for(status, "PUT?partNumber", key, body)
        etag = {k.lower(): v for k, v in headers.items()}.get("etag", "")
        if not etag:
            raise TransientStoreError(
                f"s3 upload_part {key}#{part_no}: no ETag returned")
        return etag

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[str]) -> None:
        parts_xml = "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber>"
            f"<ETag>{etag}</ETag></Part>"
            for i, etag in enumerate(etags))
        payload = (f"<CompleteMultipartUpload>{parts_xml}"
                   f"</CompleteMultipartUpload>").encode("utf-8")
        status, _, body = self._request(
            "POST", self._object_path(key),
            query=[("uploadId", upload_id)], body=payload)
        self._raise_for(status, "POST?uploadId", key, body)
        # S3 can return 200 with an <Error> body for a failed complete.
        if b"<Error>" in body:
            raise TransientStoreError(
                f"s3 complete_multipart {key}: "
                f"{body[:300].decode('utf-8', 'replace')}")

    def abort_multipart(self, key: str, upload_id: str) -> None:
        status, _, body = self._request(
            "DELETE", self._object_path(key),
            query=[("uploadId", upload_id)])
        if status == 404:
            return
        self._raise_for(status, "DELETE?uploadId", key, body)


def parse_s3_url(url: str) -> S3ObjectClient:
    """``s3://bucket[/prefix]?endpoint=...&region=...`` → client.

    Query params: ``endpoint`` (S3-compatible base URL; empty = AWS),
    ``region``, and — FOR TESTS ONLY — ``access_key``/``secret_key``
    (production credentials belong in the environment, never in a URL that
    lands in logs and config files)."""
    u = urllib.parse.urlsplit(url)
    if u.scheme != "s3" or not u.netloc:
        raise ValueError(f"not an s3 URL: {url}")
    q = dict(urllib.parse.parse_qsl(u.query))
    return S3ObjectClient(
        bucket=u.netloc,
        prefix=u.path.strip("/"),
        endpoint=q.get("endpoint", ""),
        region=q.get("region", "us-east-1"),
        access_key=q.get("access_key", ""),
        secret_key=q.get("secret_key", ""),
    )
