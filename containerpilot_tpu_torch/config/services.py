"""Service naming and NIC/IP-selection DSL.

Capability parity with the reference's services config helpers
(reference: config/services/names.go, config/services/ips.go):

- ``validate_name``: service names must be DNS-safe
  (``^[a-z][a-zA-Z0-9-]+$``, reference: names.go:8-21).
- ``get_ip(specs)``: pick the advertised IP from an ordered list of
  interface specs — ``eth0``, ``eth0[1]``, ``eth0:inet6``, ``inet``,
  ``inet6``, a CIDR like ``10.0.0.0/16``, or ``static:<ip>`` — matching
  against interface IPs sorted by interface name then IP bytes for
  stable selection (reference: ips.go:31-66,159-223,297-310).

On cloud VMs the default spec list works as-is (the primary NIC is
``ens*``/``eth0``); ``inet`` is the portable fallback.

The port's own copy of ``containerpilot_tpu/config/services.py``.
"""
from __future__ import annotations

import ctypes
import ipaddress
import logging
import re
import socket
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

log = logging.getLogger("containerpilot.config")

_VALID_NAME = re.compile(r"^[a-z][a-zA-Z0-9\-]+$")


def validate_name(name: str) -> None:
    if not name:
        raise ValueError("'name' must not be blank")
    if not _VALID_NAME.match(name):
        raise ValueError(
            "service names must be alphanumeric with dashes to comply "
            "with service discovery"
        )


# --- interface enumeration -------------------------------------------------

IPAddr = Union[ipaddress.IPv4Address, ipaddress.IPv6Address]


@dataclass(frozen=True)
class InterfaceIP:
    name: str
    ip: IPAddr

    @property
    def is_ipv4(self) -> bool:
        return self.ip.version == 4

    def ip_string(self) -> str:
        return str(self.ip)


class _SockAddr(ctypes.Structure):
    _fields_ = [("family", ctypes.c_ushort), ("data", ctypes.c_ubyte * 22)]


class _IfAddrs(ctypes.Structure):
    pass


_IfAddrs._fields_ = [
    ("next", ctypes.POINTER(_IfAddrs)),
    ("name", ctypes.c_char_p),
    ("flags", ctypes.c_uint),
    ("addr", ctypes.POINTER(_SockAddr)),
    ("netmask", ctypes.POINTER(_SockAddr)),
    ("ifu", ctypes.c_void_p),
    ("data", ctypes.c_void_p),
]


def _gather_interface_ips() -> List[InterfaceIP]:
    """Enumerate (interface, IP) pairs, sorted by name then IP bytes
    (reference: ips.go:253-310), from libc's ``getifaddrs`` — the call
    the reference's ``psutil.net_if_addrs`` makes."""
    libc = ctypes.CDLL(None, use_errno=True)
    head = ctypes.POINTER(_IfAddrs)()
    if libc.getifaddrs(ctypes.byref(head)) != 0:
        raise OSError(ctypes.get_errno(), "getifaddrs failed")
    out: List[InterfaceIP] = []
    try:
        node = head
        while node:
            entry = node.contents
            node = entry.next
            if not entry.addr:
                continue
            family = entry.addr.contents.family
            raw = bytes(entry.addr.contents.data)
            name = entry.name.decode()
            if family == socket.AF_INET:
                # sockaddr_in: port (2 bytes), then the address
                out.append(InterfaceIP(name, ipaddress.IPv4Address(raw[2:6])))
            elif family == socket.AF_INET6:
                # sockaddr_in6: port (2), flowinfo (4), then the address
                out.append(
                    InterfaceIP(name, ipaddress.IPv6Address(raw[6:22]))
                )
    finally:
        libc.freeifaddrs(head)
    out.sort(key=lambda iip: (iip.name, iip.ip.version, int(iip.ip)))
    return out


# --- spec parsing ----------------------------------------------------------

_IFACE_SPEC = re.compile(r"^(?P<name>\w+)(?:(?:\[(?P<index>\d+)\])|(?::(?P<ver>inet6?)))?$")

MatchFn = Callable[[int, InterfaceIP], bool]


@dataclass
class _Spec:
    spec: str
    match: Optional[MatchFn]  # None for static specs
    static_ip: Optional[str] = None


def _parse_spec(spec: str) -> _Spec:
    if spec == "inet":
        return _Spec(spec, lambda i, iip: not iip.ip.is_loopback and iip.is_ipv4)
    if spec == "inet6":
        return _Spec(spec, lambda i, iip: not iip.ip.is_loopback and not iip.is_ipv4)
    if spec.startswith("static:"):
        raw = spec[len("static:"):]
        try:
            ipaddress.ip_address(raw)
        except ValueError:
            raise ValueError(f"unable to parse static ip {raw!r} in {spec!r}")
        return _Spec(spec, None, static_ip=raw)
    m = _IFACE_SPEC.match(spec)
    if m:
        name, index, ver = m.group("name"), m.group("index"), m.group("ver")
        if index is not None:
            want = int(index)
            return _Spec(
                spec,
                lambda i, iip, n=name, w=want: iip.name == n and i == w,
            )
        want_v6 = ver == "inet6"
        return _Spec(
            spec,
            lambda i, iip, n=name, v6=want_v6: iip.name == n and iip.is_ipv4 != v6,
        )
    try:
        network = ipaddress.ip_network(spec, strict=False)
        return _Spec(spec, lambda i, iip, net=network: iip.ip in net)
    except ValueError:
        pass
    raise ValueError(f"unable to parse interface spec: {spec!r}")


def get_ip(
    spec_list: Optional[Sequence[str]] = None,
    interface_ips: Optional[List[InterfaceIP]] = None,
) -> str:
    """Resolve the advertised IP from ordered interface specs
    (reference: ips.go:31-99). ``interface_ips`` is injectable for
    deterministic tests, like the reference's pure matcher."""
    if not spec_list:
        spec_list = ["eth0:inet", "inet"]
    specs = [_parse_spec(s) for s in spec_list]
    if interface_ips is None:
        interface_ips = _gather_interface_ips()

    for spec in specs:
        if spec.static_ip is not None:
            return spec.static_ip
        index = 0
        current = ""
        for iip in interface_ips:
            # index counts addresses within one interface; name changes
            # reset it (the list is sorted by interface name)
            if current != iip.name:
                index = 0
                current = iip.name
            else:
                index += 1
            assert spec.match is not None
            if spec.match(index, iip):
                return iip.ip_string()
    raise ValueError(
        "none of the interface specifications were able to match\n"
        f"specifications: {[s.spec for s in specs]}\n"
        f"interface IPs: {[(i.name, i.ip_string()) for i in interface_ips]}"
    )
