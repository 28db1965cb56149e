"""Cluster wire protocol of the port: length-prefixed, checksummed frames
(DESIGN.md §8.1), byte for byte the JAX package's
(``repro.serve.cluster.protocol``), so either package's router talks to
either package's nodes.

One message = one frame::

    magic   2s   b"HC"
    op      u8   message class: 1 = request, 2 = response, 3 = error
    length  u32  payload byte count
    crc32   u32  zlib.crc32 of magic+op+length THEN the payload — header
                 fields are covered too (the WAL's framing discipline,
                 persist/wal.py), so a flipped bit anywhere in the frame is
                 a detected ``TornFrameError``, never a silently wrong
                 tensor
    payload      one JSON meta line (command name + scalar fields), b"\\n",
                 then ``checkpoint.leaves.pack_arrays`` of the named
                 tensors — the same deterministic bit-exact encoding the
                 WAL and snapshot store use, so a tensor that round-trips
                 the wire is the tensor that round-trips disk

The framing is deliberately the smallest thing that can carry named numpy
arrays with end-to-end integrity; request/response matching is one-per-
connection (a client sends a request and reads exactly one reply), which
keeps failure handling trivial: any anomaly kills the connection and the
client re-establishes it (``client.ShardClient``).
"""

from __future__ import annotations

import json
import socket
import struct
import zlib

from ...checkpoint.leaves import pack_array_parts, unpack_arrays

__all__ = ["TornFrameError", "RemoteError", "send_msg", "recv_msg",
           "build_frame", "MSG_REQUEST", "MSG_RESPONSE", "MSG_ERROR"]

MSG_REQUEST = 1
MSG_RESPONSE = 2
MSG_ERROR = 3

_MAGIC = b"HC"
_HEADER = struct.Struct("<2sBII")       # magic, op, length, crc32
_PREFIX = struct.Struct("<2sBI")        # the crc-covered header fields
_IOV_MAX = 1024                          # buffers one ``sendmsg`` takes


class TornFrameError(ConnectionError):
    """A frame failed its integrity check — short read, bad magic, or crc
    mismatch.  The connection is unusable (framing is lost): the only safe
    recovery is to drop it and reconnect, which ``client.ShardClient``
    does transparently."""


class RemoteError(RuntimeError):
    """The peer executed the request and reported an application-level
    failure (its message is the remote traceback summary).  Distinct from
    ``TornFrameError``: the wire worked, the command did not — retrying on
    a fresh connection will not help."""


def _frame_crc(op: int, payload: bytes) -> int:
    return zlib.crc32(payload,
                      zlib.crc32(_PREFIX.pack(_MAGIC, op, len(payload))))


def _frame_parts(cmd: str, meta: dict | None, arrays: dict | None,
                 op: int) -> list:
    """One message's wire frame as a list of buffers in order: the
    header, the meta line, then ``pack_array_parts``; the tensors' bytes
    are views of the arrays, and the crc runs over the parts in turn."""
    head = dict(meta or {})
    head["cmd"] = cmd
    parts = [json.dumps(head).encode() + b"\n",
             *pack_array_parts(arrays or {})]
    length = sum(len(p) for p in parts)
    crc = zlib.crc32(_PREFIX.pack(_MAGIC, op, length))
    for p in parts:
        crc = zlib.crc32(p, crc)
    return [_HEADER.pack(_MAGIC, op, length, crc), *parts]


def build_frame(cmd: str, meta: dict | None = None,
                arrays: dict | None = None, *,
                op: int = MSG_REQUEST) -> bytes:
    """Serialize one message to its complete wire frame WITHOUT sending it.
    The router's fan-out uses this to pack a query batch ONCE and send the
    identical bytes to every scorer (the per-shard re-serialization was a
    measurable slice of the Q=1 RPC overhead); ``ShardClient.submit``
    accepts the pre-built frame directly."""
    return b"".join(_frame_parts(cmd, meta, arrays, op))


def send_msg(sock: socket.socket, cmd: str, meta: dict | None = None,
             arrays: dict | None = None, *, op: int = MSG_REQUEST,
             corrupt: bool = False) -> int:
    """Frame and send one message; returns the bytes written.  ``cmd`` and
    the JSON-scalar ``meta`` fields form the header line, ``arrays`` are
    named numpy tensors (bit-exact via ``pack_arrays``).  ``corrupt=True``
    flips a payload bit AFTER the crc is computed — the server-side fault
    hook the torn-frame tests drive; a real sender never sets it.  The
    frame goes out by gathered writes of its parts, so its tensors are
    never copied (the store files a follower fetches are hundreds of
    MB)."""
    parts = _frame_parts(cmd, meta, arrays, op)
    n = sum(len(p) for p in parts)
    if corrupt:
        frame = bytearray(b"".join(parts))
        frame[-1] ^= 0x40
        parts = [frame]
    views = [memoryview(p) for p in parts if len(p)]
    i = 0
    while i < len(views):
        sent = sock.sendmsg(views[i:i + _IOV_MAX])
        while i < len(views) and sent >= len(views[i]):
            sent -= len(views[i])
            i += 1
        if sent:
            views[i] = views[i][sent:]
    return n


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes into a buffer of their own, or raise:
    ``ConnectionError`` on a clean EOF at a frame boundary (peer went
    away), ``TornFrameError`` mid-frame."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            if got == 0:
                raise ConnectionError("peer closed the connection")
            raise TornFrameError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        got += k
    return buf


def recv_msg(sock: socket.socket) -> tuple[int, dict, dict]:
    """Receive one frame; returns ``(op, meta, arrays)``.  Integrity
    failures raise ``TornFrameError``; an ``op == MSG_ERROR`` frame is
    returned like any other (the client raises ``RemoteError`` from it —
    the transport layer only vouches for the bytes)."""
    header = _recv_exact(sock, _HEADER.size)
    magic, op, length, crc = _HEADER.unpack(header)
    if magic != _MAGIC:
        raise TornFrameError(f"bad frame magic {magic!r}")
    payload = _recv_exact(sock, length)
    if _frame_crc(op, payload) != crc:
        raise TornFrameError("frame checksum mismatch")
    nl = payload.index(b"\n")
    meta = json.loads(payload[:nl].decode())
    # the arrays are views of the frame's own buffer where aligned
    arrays = unpack_arrays(payload, nl + 1)
    return op, meta, arrays
