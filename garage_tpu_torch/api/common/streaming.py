"""aws-chunked streaming signatures
(reference src/api/common/signature/streaming.rs, 618 LoC).

For `x-amz-content-sha256: STREAMING-AWS4-HMAC-SHA256-PAYLOAD` the body is
a sequence of framed chunks, each carrying its own signature chained from
the request's seed (Authorization) signature:

    <hex size>;chunk-signature=<sig>\r\n <bytes> \r\n ...
    0;chunk-signature=<final sig>\r\n\r\n

    sig_i = HMAC(signing_key, "AWS4-HMAC-SHA256-PAYLOAD\n" + timestamp +
                 "\n" + scope + "\n" + sig_{i-1} + "\n" + sha256("") +
                 "\n" + sha256(chunk_i))

so a long upload is authenticated incrementally without buffering it.
`STREAMING-UNSIGNED-PAYLOAD-TRAILER` uses the same framing without
per-chunk signatures; trailers (e.g. `x-amz-checksum-*`) are captured by
the decoder and verified by the put path over the decoded stream.
"""

from __future__ import annotations

import hashlib
import hmac

from .error import AuthError, BadRequest

STREAMING_SIGNED = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_UNSIGNED_TRAILER = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
MAX_CHUNK_HEADER = 8 * 1024
MAX_CHUNK_SIZE = 16 * 1024 * 1024  # declared chunk cap: bound buffering


class StreamingContext:
    """Per-request signing context carried in the AuthContext."""

    def __init__(self, signing_key: bytes, timestamp: str, scope: str, seed_sig: str):
        self.signing_key = signing_key
        self.timestamp = timestamp
        self.scope = scope
        self.seed_sig = seed_sig

    def chunk_signature(self, prev_sig: str, chunk: bytes) -> str:
        sts = "\n".join(
            [
                "AWS4-HMAC-SHA256-PAYLOAD",
                self.timestamp,
                self.scope,
                prev_sig,
                EMPTY_SHA256,
                hashlib.sha256(chunk).hexdigest(),
            ]
        )
        return hmac.new(self.signing_key, sts.encode(), hashlib.sha256).hexdigest()


class ChunkedDecoder:
    """Wraps the raw body stream; `.read(n)` yields decoded payload bytes,
    verifying each chunk signature as it completes."""

    def __init__(self, raw, ctx: StreamingContext | None):
        self.raw = raw  # aiohttp StreamReader (.read(n))
        self.ctx = ctx  # None = unsigned-trailer framing
        self.prev_sig = ctx.seed_sig if ctx else ""
        self.buf = b""
        self.pending = b""  # decoded-but-undelivered payload
        self.eof = False
        self.trailers: dict[str, str] = {}  # e.g. trailing checksums

    async def _fill(self, n: int) -> None:
        while len(self.buf) < n:
            chunk = await self.raw.read(64 * 1024)
            if not chunk:
                raise BadRequest("truncated aws-chunked body")
            self.buf += chunk

    async def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            if len(self.buf) > MAX_CHUNK_HEADER:
                raise BadRequest("oversized chunk header")
            chunk = await self.raw.read(64 * 1024)
            if not chunk:
                raise BadRequest("truncated aws-chunked body")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    async def _next_chunk(self) -> bytes | None:
        header = await self._read_line()
        size_hex, _, ext = header.partition(b";")
        try:
            size = int(size_hex, 16)
        except ValueError as e:
            raise BadRequest(f"bad chunk size {size_hex!r}") from e
        if size > MAX_CHUNK_SIZE:
            raise BadRequest(
                f"chunk of {size} bytes exceeds the {MAX_CHUNK_SIZE} limit"
            )
        sig = None
        if ext.startswith(b"chunk-signature="):
            sig = ext[len(b"chunk-signature="):].decode()
        if self.ctx is not None and sig is None:
            raise AuthError("chunk without signature in signed streaming body")
        await self._fill(size)
        data, self.buf = self.buf[:size], self.buf[size:]
        if self.ctx is not None:
            expected = self.ctx.chunk_signature(self.prev_sig, data)
            if not hmac.compare_digest(expected, sig or ""):
                raise AuthError("chunk signature does not match")
            self.prev_sig = expected
        if size == 0:
            # capture trailers (e.g. x-amz-checksum-*) until blank line/EOF
            while True:
                try:
                    line = await self._read_line()
                except BadRequest:
                    break
                if line == b"":
                    break
                name, sep, value = line.decode(errors="replace").partition(":")
                if sep:
                    self.trailers[name.strip().lower()] = value.strip()
            return None
        # trailing CRLF after the data
        await self._fill(2)
        if self.buf[:2] != b"\r\n":
            raise BadRequest("missing CRLF after chunk data")
        self.buf = self.buf[2:]
        return data

    async def read(self, n: int) -> bytes:
        while not self.eof and len(self.pending) < n:
            chunk = await self._next_chunk()
            if chunk is None:
                self.eof = True
                break
            self.pending += chunk
        out, self.pending = self.pending[:n], self.pending[n:]
        return out


# --- client-side encoding (in-repo client + tests) ----------------------------


def encode_chunked(
    data: bytes, ctx: StreamingContext, chunk_size: int = 64 * 1024
) -> bytes:
    out = []
    prev = ctx.seed_sig
    for i in range(0, max(len(data), 1), chunk_size):
        chunk = data[i : i + chunk_size]
        sig = ctx.chunk_signature(prev, chunk)
        out.append(f"{len(chunk):x};chunk-signature={sig}\r\n".encode())
        out.append(chunk)
        out.append(b"\r\n")
        prev = sig
    final = ctx.chunk_signature(prev, b"")
    out.append(f"0;chunk-signature={final}\r\n\r\n".encode())
    return b"".join(out)
