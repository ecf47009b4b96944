"""Length-prefixed JSON framing for the master <-> worker localhost sockets.

A copy of ``repro.cluster.runtime.protocol`` for the port: the same dict
encodes to the same bytes in both packages, so either package's master
serves either package's workers.

Every message is one JSON object encoded UTF-8 and prefixed with a 4-byte
big-endian length.  JSON keeps the wire debuggable (``tcpdump``/``nc`` show
readable frames) and the payloads are tiny control messages -- task
dispatches, heartbeats, cancellations -- so framing overhead is irrelevant.

Message vocabulary (the only shapes either side sends):

========== ======================================================= =========
type       fields                                                  direction
========== ======================================================= =========
register   pid                                                     w -> m
welcome    wid, heartbeat_s [, hb_seed -- heartbeat-jitter seed]   m -> w
hb         wid [, job, batch, epoch, frac -- progress when busy]   w -> m
task       job, batch, epoch, payload, costs, lease_s              m -> w
           [, chaos_factor, chaos_raise -- injected slowdown /
           mid-payload exception (chaos harness)]
finish     wid, job, batch, epoch                                  w -> m
fail       wid, job, batch, epoch, error -- the payload raised;    w -> m
           ``error`` carries the traceback text
cancel     job, batch, epoch                                       m -> w
shutdown   --                                                      m -> w
========== ======================================================= =========

The master's chaos layer (:mod:`repro_torch.cluster.runtime.chaos`) injects wire
faults *around* this framing -- dropping, duplicating, or delaying whole
frames at the master's send/receive boundary -- so the framing itself stays
byte-exact; a dropped frame is simply never processed / never written.
"""

from __future__ import annotations

import asyncio
import json
import struct

__all__ = ["MAX_FRAME", "ProtocolError", "read_msg", "send_msg", "send_nowait"]

_HEADER = struct.Struct(">I")
MAX_FRAME = 1 << 20  # 1 MiB: orders of magnitude above any control message


class ProtocolError(RuntimeError):
    """A frame violated the length-prefixed JSON protocol."""


def _encode(obj: dict) -> bytes:
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(data)} bytes exceeds MAX_FRAME")
    return _HEADER.pack(len(data)) + data


def send_nowait(writer: asyncio.StreamWriter, obj: dict) -> None:
    """Queue one frame on the transport without awaiting the drain.

    The master sends from inside event handlers whose ordering *is* the
    recorded semantics; buffering synchronously keeps send order identical
    to decision order (messages are tiny, so the kernel buffer absorbs them).
    """
    writer.write(_encode(obj))


async def send_msg(writer: asyncio.StreamWriter, obj: dict) -> None:
    """Send one frame and drain (the polite worker-side variant)."""
    writer.write(_encode(obj))
    await writer.drain()


async def read_msg(reader: asyncio.StreamReader) -> dict | None:
    """Read one frame; ``None`` on clean or torn connection loss."""
    try:
        head = await reader.readexactly(_HEADER.size)
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
        return None
    (n,) = _HEADER.unpack(head)
    if n > MAX_FRAME:
        raise ProtocolError(f"incoming frame of {n} bytes exceeds MAX_FRAME")
    try:
        data = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
        return None
    try:
        msg = json.loads(data)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"undecodable frame: {e}") from None
    if not isinstance(msg, dict) or "type" not in msg:
        raise ProtocolError(f"frame is not a typed message: {msg!r}")
    return msg
