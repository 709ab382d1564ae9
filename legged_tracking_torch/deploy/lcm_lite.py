"""Minimal LCM-compatible UDP-multicast pub/sub (pure python, no deps; a
copy of ``legged_tracking_tpu/deploy/lcm_lite.py``, its bytes the same).

The reference deployment stack rides LCM (``udpm://239.255.76.67:7667``,
lcm_traj_agent.py:10; C library).  This module implements the LCM UDP wire
protocol for small (single-fragment) messages — magic ``LC02`` header,
sequence number, null-terminated channel, payload — plus the lcm-gen type
fingerprint/encode/decode scheme, so the python side interoperates with the
stock LCM C library running in the robot's bridge process.

Only single-fragment messages (< ~64 KB) are supported; every message in the
Go1 stack is well under one MTU.

The bus is stock LCM's ``LCM_DEFAULT_URL`` (``udpm://ADDR:PORT``, options
after ``?`` ignored) when it is set, else the reference's
``239.255.76.67:7667``; the C++ bridge (``bridge/mini_lcm.hpp``) reads the
same variable, so a test can give both ends a bus of its own.
"""

from __future__ import annotations

import os
import socket
import struct
import threading

MAGIC_SHORT = 0x4C433032  # "LC02"
DEFAULT_URL = ("239.255.76.67", 7667)


def default_url() -> tuple[str, int]:
    """(address, port) of ``LCM_DEFAULT_URL``, else ``DEFAULT_URL``."""
    url = os.environ.get("LCM_DEFAULT_URL")
    if not url:
        return DEFAULT_URL
    if not url.startswith("udpm://"):
        raise ValueError(f"LCM_DEFAULT_URL={url!r}: only udpm://ADDR:PORT is supported")
    addr, _, port = url[len("udpm://"):].split("?")[0].partition(":")
    return addr, int(port or DEFAULT_URL[1])


# ------------------------------------------------------------- type hashing
def _hash_update(v: int, c: int) -> int:
    v = ((v << 8) & 0xFFFFFFFFFFFFFFFF) ^ ((v >> 55) & 0x1FF)
    return (v + c) & 0xFFFFFFFFFFFFFFFF


def _hash_string_update(v: int, s: str) -> int:
    v = _hash_update(v, len(s))
    for ch in s:
        v = _hash_update(v, ord(ch))
    return v


def base_hash(members) -> int:
    """lcm-gen struct base hash: members = [(name, type_str, dims)]."""
    v = 0x12345678
    for name, type_str, dims in members:
        v = _hash_string_update(v, name)
        v = _hash_string_update(v, type_str)  # primitive types only here
        v = _hash_update(v, len(dims))
        for d in dims:
            v = _hash_update(v, 0)            # LCM_CONST dimension mode
            v = _hash_string_update(v, str(d))
    return v


def fingerprint(members) -> int:
    h = base_hash(members)
    return ((h << 1) & 0xFFFFFFFFFFFFFFFF) + ((h >> 63) & 1)


_FMT = {"double": "d", "float": "f", "int64_t": "q", "int32_t": "i",
        "int16_t": "h", "int8_t": "b", "byte": "B", "boolean": "b"}


class LCMType:
    """Base for declarative message types: subclasses set ``MEMBERS`` as
    [(name, primitive_type, dims)] in declaration order."""

    MEMBERS: list = []

    def __init__(self, **kwargs):
        for name, type_str, dims in self.MEMBERS:
            n = 1
            for d in dims:
                n *= d
            default = [0] * n if dims else 0
            setattr(self, name, kwargs.get(name, default))

    @classmethod
    def _fingerprint(cls) -> int:
        return fingerprint(cls.MEMBERS)

    def encode(self) -> bytes:
        out = [struct.pack(">Q", self._fingerprint())]
        for name, type_str, dims in self.MEMBERS:
            fmt = _FMT[type_str]
            val = getattr(self, name)
            if dims:
                flat = list(_flatten(val))
                out.append(struct.pack(f">{len(flat)}{fmt}", *flat))
            else:
                out.append(struct.pack(f">{fmt}", val))
        return b"".join(out)

    @classmethod
    def decode(cls, data: bytes):
        (fp,) = struct.unpack_from(">Q", data, 0)
        if fp != cls._fingerprint():
            raise ValueError(f"{cls.__name__}: fingerprint mismatch "
                             f"{fp:#x} != {cls._fingerprint():#x}")
        off = 8
        msg = cls()
        for name, type_str, dims in cls.MEMBERS:
            fmt = _FMT[type_str]
            if dims:
                n = 1
                for d in dims:
                    n *= d
                vals = list(struct.unpack_from(f">{n}{fmt}", data, off))
                off += n * struct.calcsize(fmt)
                setattr(msg, name, vals)
            else:
                (v,) = struct.unpack_from(f">{fmt}", data, off)
                off += struct.calcsize(fmt)
                setattr(msg, name, v)
        return msg


def _flatten(x):
    try:
        for item in x:
            yield from _flatten(item)
    except TypeError:
        yield x


# --------------------------------------------------------------- transport
class LCMLite:
    """Single-fragment LCM over UDP multicast."""

    def __init__(self, addr: str = None, port: int = None, ttl: int = 0):
        url = default_url()
        self.addr = addr or url[0]
        self.port = port or url[1]
        self.seq = 0
        self._handlers = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM,
                                   socket.IPPROTO_UDP)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
        self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        try:
            self._sock.bind((self.addr, self.port))
        except OSError:
            self._sock.bind(("", self.port))
        mreq = socket.inet_aton(self.addr) + socket.inet_aton("0.0.0.0")
        self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        self._stop = threading.Event()
        self._thread = None

    def publish(self, channel: str, data: bytes):
        hdr = struct.pack(">II", MAGIC_SHORT, self.seq)
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        pkt = hdr + channel.encode() + b"\x00" + data
        self._sock.sendto(pkt, (self.addr, self.port))

    def subscribe(self, channel: str, handler):
        self._handlers[channel] = handler

    def handle_once(self, timeout: float = 0.1) -> bool:
        self._sock.settimeout(timeout)
        try:
            pkt, _ = self._sock.recvfrom(65536)
        except socket.timeout:
            return False
        if len(pkt) < 8:
            return False
        magic, _seq = struct.unpack_from(">II", pkt, 0)
        if magic != MAGIC_SHORT:
            return False        # fragmented messages not supported
        end = pkt.index(b"\x00", 8)
        channel = pkt[8:end].decode()
        payload = pkt[end + 1:]
        h = self._handlers.get(channel)
        if h is not None:
            h(channel, payload)
            return True
        return False

    def spin(self):
        """Background receive loop (StateEstimator.spin analogue)."""
        def loop():
            while not self._stop.is_set():
                self.handle_once(timeout=0.2)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        self._sock.close()
