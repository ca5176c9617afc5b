"""Earthworm WaveServerV / Winston wave-server acquisition (stdlib TCP).

The port's copy of ``narrow_band_least_squares_tpu/io/earthworm.py``.  The
reference's ``waveform_collection.gather_waveforms(SOURCE, ...)``
(reference ``example.py:16,91``) also speaks Earthworm/Winston wave servers
(the AVO deployment), not only FDSN.  This module is a dependency-free
client for the WaveServerV ASCII/binary protocol that both server families
answer:

    MENU: <id> SCNL\\n                      -> one line per channel
    GETSCNLRAW: <id> S C N L <t0> <t1>\\n   -> ASCII header + TraceBuf2 bytes

TraceBuf2 packets carry a 64-byte header (pin, nsamp, start/end epoch,
sample rate, SCNL, datatype) followed by samples; datatype 'i'/'s'
prefixes select little/big endian, suffix 2/4 the integer width ('f4'/
't4' are floats).  Packets are concatenated on a common time base with
gap zero-fill, as the FDSN path merges miniSEED records.

Wave servers carry no station coordinates or responses; callers supply a
``coordinates`` mapping (station -> (lat, lon)) or a ``metadata_source``
FDSN service that is queried for coordinates (`io.fdsn.parse_station_text`).
``remove_response=True`` takes the instrument responses from a local
StationXML document (``response_xml=``) or the ``metadata_source`` FDSN
station service at ``level=response`` and deconvolves each trace with the
FDSN path's water-level division (`io.response.remove_response`); it
raises when neither source is given.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.utils.timeutils import parse_utc

_TB2_HEADER = 64

_DTYPES = {
    b"i2": "<i2", b"i4": "<i4", b"i8": "<i8",
    b"s2": ">i2", b"s4": ">i4", b"s8": ">i8",
    b"f4": "<f4", b"f8": "<f8",
    b"t4": ">f4", b"t8": ">f8",
}


def parse_tracebuf2(buf: bytes) -> List[dict]:
    """Concatenated TraceBuf2 packets -> list of sample blocks."""
    out = []
    off = 0
    n = len(buf)
    while off + _TB2_HEADER <= n:
        # datatype at bytes 57:60 decides the header's own byte order
        dt_raw = buf[off + 57 : off + 60].split(b"\x00")[0]
        dt = _DTYPES.get(dt_raw)
        if dt is None:
            raise ValueError(f"unknown tracebuf2 datatype {dt_raw!r}")
        bo = dt[0]
        pin, nsamp = struct.unpack_from(bo + "ii", buf, off)
        t0, t1, rate = struct.unpack_from(bo + "ddd", buf, off + 8)
        sta = buf[off + 32 : off + 39].split(b"\x00")[0].decode()
        net = buf[off + 39 : off + 48].split(b"\x00")[0].decode()
        chan = buf[off + 48 : off + 52].split(b"\x00")[0].decode()
        loc = buf[off + 52 : off + 55].split(b"\x00")[0].decode()
        width = int(dt[2])
        # the header's nsamp is network-supplied: a corrupt/malicious
        # value must fail loudly, not desync the offset walk (np.frombuffer
        # treats count=-1 as "read everything")
        if nsamp < 0 or off + _TB2_HEADER + nsamp * width > n:
            raise ValueError(
                f"tracebuf2 header claims nsamp={nsamp} ({nsamp * width} "
                f"bytes) but only {n - off - _TB2_HEADER} payload bytes "
                "remain"
            )
        data = np.frombuffer(
            buf, dtype=dt, count=nsamp, offset=off + _TB2_HEADER
        ).astype(np.float64)
        out.append({
            "sta": sta, "net": net, "chan": chan, "loc": loc,
            "start": t0, "rate": rate, "data": data,
        })
        off += _TB2_HEADER + nsamp * width
    return out


class EarthwormClient:
    """Minimal WaveServerV / Winston client (one TCP round trip per call)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host = host
        self.port = int(port)
        self.timeout = timeout

    # -- wire helpers ---------------------------------------------------
    def _roundtrip(self, request: str, binary_len_from_header=None) -> Tuple[str, bytes]:
        """Send one request line; read the ASCII header line (+ binary)."""
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ) as sk:
            sk.sendall(request.encode())
            header = b""
            while not header.endswith(b"\n"):
                c = sk.recv(1)
                if not c:
                    break
                header += c
            head = header.decode().strip()
            payload = b""
            nbytes = binary_len_from_header(head) if binary_len_from_header else 0
            while len(payload) < nbytes:
                chunk = sk.recv(min(65536, nbytes - len(payload)))
                if not chunk:
                    break
                payload += chunk
            return head, payload

    # -- protocol -------------------------------------------------------
    def menu(self) -> List[Dict[str, str]]:
        """Available channels: list of {sta, chan, net, loc, start, end}."""
        head, _ = self._roundtrip("MENU: 0 SCNL\n")
        toks = head.split()
        out = []
        # response: "<id>  <pin> S C N L <start> <end> <datatype>  ..."
        # Each entry is validated (pin integer, start/end floats) rather
        # than trusted at a fixed stride: a server emitting extra
        # per-entry fields would otherwise silently shift every
        # subsequent entry instead of failing.
        i = 1
        while i + 7 <= len(toks):
            try:
                int(toks[i])
                start = float(toks[i + 5])
                end = float(toks[i + 6])
            except ValueError:
                raise ValueError(
                    f"malformed MENU entry at token {i}: "
                    f"{' '.join(toks[i : i + 8])!r}"
                ) from None
            out.append({
                "sta": toks[i + 1], "chan": toks[i + 2],
                "net": toks[i + 3], "loc": toks[i + 4],
                "start": start, "end": end,
            })
            i += 8
        return out

    def get_scnl_raw(
        self, sta: str, chan: str, net: str, loc: str,
        t0: float, t1: float,
    ) -> List[dict]:
        """GETSCNLRAW one channel; returns parsed tracebuf2 blocks."""
        req = f"GETSCNLRAW: 0 {sta} {chan} {net} {loc or '--'} {t0:.4f} {t1:.4f}\n"

        def nbytes(head: str) -> int:
            # "<id> <pin> S C N L F <dtype> <start> <nbytes>"
            toks = head.split()
            if len(toks) >= 9 and toks[6].startswith("F") and len(toks[6]) == 1:
                return int(toks[-1])
            return 0      # FL/FR/FG/FN: gap, out of range, or no data

        head, payload = self._roundtrip(req, binary_len_from_header=nbytes)
        expected = nbytes(head)
        if len(payload) != expected:
            # a truncated payload could parse cleanly on a packet
            # boundary and zero-fill the tail — corrupt waveforms, not
            # an error — so reject short reads loudly
            raise RuntimeError(
                f"wave server returned {len(payload)} of {expected} "
                f"bytes for {net}.{sta}.{loc}.{chan} (connection "
                "truncated?)"
            )
        if not payload:
            return []
        return parse_tracebuf2(payload)


def _assemble(blocks: List[dict], t0: float, t1: float) -> Tuple[np.ndarray, float]:
    """Tracebuf2 blocks of ONE channel -> zero-filled common time base."""
    rate = blocks[0]["rate"]
    npts = int(round((t1 - t0) * rate))
    out = np.zeros(npts, dtype=np.float64)
    for b in blocks:
        if abs(b["rate"] - rate) > 1e-6:
            raise ValueError("sample-rate change inside request window")
        i0 = int(round((b["start"] - t0) * rate))
        d = b["data"]
        lo = max(i0, 0)
        hi = min(i0 + len(d), npts)
        if hi > lo:
            out[lo:hi] = d[lo - i0 : hi - i0]
    return out, rate


def gather_waveforms_earthworm(
    host: str,
    port: int,
    network: str,
    station_list: Sequence[str],
    location: str,
    channel: str,
    starttime,
    endtime,
    coordinates: Optional[Dict[str, Tuple[float, float]]] = None,
    metadata_source: Optional[str] = None,
    timeout: float = 30.0,
    client: Optional[EarthwormClient] = None,
    remove_response: bool = False,
    response_xml: Optional[str] = None,
    water_level_db: float = 60.0,
) -> ArrayStream:
    """Fetch one array's channels from a wave server into an ArrayStream.

    ``station_list`` enumerates the array elements explicitly (wave
    servers have no wildcard queries; use ``EarthwormClient.menu()`` to
    discover).  Coordinates come from ``coordinates`` (station -> (lat,
    lon)) or an FDSN ``metadata_source`` station query (text format).

    ``remove_response=True`` deconvolves each trace's instrument response
    (counts -> physical units), sourcing the responses from
    ``response_xml`` (a local StationXML file path, or the XML text
    itself) or, failing that, the ``metadata_source`` FDSN station
    service at ``level=response``.  Raises ``ValueError`` when neither is
    available or a requested channel has no response in the document —
    silently returning counts would be a unit change for drop-in callers
    whose downstream amplitude thresholds assume physical units.
    """
    t0 = parse_utc(starttime)
    t1 = parse_utc(endtime)
    cl = client or EarthwormClient(host, port, timeout=timeout)

    coords = dict(coordinates or {})
    if not coords and metadata_source:
        from narrow_band_least_squares_tpu_torch.io.fdsn import (
            _http_get, parse_station_text, station_url,
        )
        text = _http_get(station_url(
            metadata_source, network, ",".join(station_list), location,
            channel, t0, t1,
        )).decode()
        for ci in parse_station_text(text):
            sta = ci.sid.split(".")[1]
            coords.setdefault(sta, (ci.latitude, ci.longitude))

    rows, lats, lons, ids = [], [], [], []
    rate0 = None
    for sta in station_list:
        blocks = cl.get_scnl_raw(sta, channel, network, location, t0, t1)
        if not blocks:
            raise RuntimeError(
                f"wave server returned no data for "
                f"{network}.{sta}.{location}.{channel}"
            )
        row, rate = _assemble(blocks, t0, t1)
        if rate0 is None:
            rate0 = rate
        elif abs(rate - rate0) > 1e-6:
            raise ValueError("mixed sample rates across array elements")
        if sta not in coords:
            raise ValueError(
                f"no coordinates for station {sta}: pass coordinates= or "
                f"metadata_source="
            )
        rows.append(row)
        lats.append(coords[sta][0])
        lons.append(coords[sta][1])
        ids.append(f"{network}.{sta}.{location}.{channel}")
    data = np.stack(rows)

    if remove_response:
        from narrow_band_least_squares_tpu_torch.io.response import (
            remove_response as _deconvolve,
        )

        responses = _load_responses(
            response_xml, metadata_source, network, station_list, location,
            channel, starttime, endtime, timeout,
        )
        # wave-server location '--' means blank; StationXML keys use ''
        loc_norm = "" if location in ("--", "") else location
        for i, sta in enumerate(station_list):
            sid = f"{network}.{sta}.{loc_norm}.{channel}"
            resp = responses.get(sid)
            if resp is None or not resp.stages:
                raise ValueError(
                    f"no instrument response for {sid} in the provided "
                    "StationXML; pass response_xml=/metadata_source= with "
                    "responses for every element, or remove_response=False "
                    "for raw counts"
                )
            data[i] = _deconvolve(
                data[i], float(rate0), resp, water_level_db=water_level_db,
            )

    return ArrayStream(
        data=data, fs=float(rate0), start_epoch=t0,
        latitudes=lats, longitudes=lons, ids=ids,
    )


def _load_responses(
    response_xml, metadata_source, network, station_list, location,
    channel, starttime, endtime, timeout,
):
    """StationXML responses from a local file/text or the FDSN service."""
    from narrow_band_least_squares_tpu_torch.io.response import parse_stationxml

    if response_xml:
        text = os.fspath(response_xml) if not isinstance(
            response_xml, str
        ) else response_xml
        if "<" not in text:  # a path (str or PathLike), not XML text
            with open(text, "r") as f:
                text = f.read()
        return parse_stationxml(text)
    if metadata_source:
        from narrow_band_least_squares_tpu_torch.io.fdsn import (
            _http_get, station_response_url,
        )

        xml = _http_get(
            station_response_url(
                metadata_source, network, ",".join(station_list), location,
                channel, starttime, endtime,
            ),
            timeout,
        ).decode()
        return parse_stationxml(xml)
    raise ValueError(
        "remove_response=True on a wave-server source needs the responses "
        "from somewhere: pass response_xml= (local StationXML) or "
        "metadata_source= (FDSN station service), or pass "
        "remove_response=False explicitly to accept raw counts"
    )
