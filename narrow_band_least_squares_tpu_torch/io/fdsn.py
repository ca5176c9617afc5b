"""Dependency-free FDSN web-service client (dataselect + station).

The port's copy of ``narrow_band_least_squares_tpu/io/fdsn.py``.  The
reference's data layer drives ObsPy's FDSN client (reference
``example.py:91``: waveforms fetched from IRIS with the instrument response
removed and per-element coordinates attached).  ObsPy is optional; this
module speaks the two FDSN web services over stdlib HTTP and decodes the
returned miniSEED with the port's C++ codec (`io.ingest`):

- **dataselect**: ``query?net=..&sta=..&loc=..&cha=..&start=..&end=..``
  returns concatenated miniSEED records -> `read_mseed_records`.
- **station**:  ``query?...&level=channel&format=text`` returns a
  pipe-separated table with per-channel latitude/longitude and the overall
  instrument sensitivity (Scale / ScaleFreq / ScaleUnits columns);
  ``level=response`` returns the full StationXML response document.

``remove_response=True`` deconvolves the full multi-stage transfer function
(poles/zeros + FIR) parsed from the ``level=response`` StationXML,
water-level stabilised (`io.response`), and falls back to dividing by the
overall **sensitivity** (exact wherever the response is flat) only when the
response document cannot be fetched or parsed.
``io.stream.gather_waveforms`` still prefers ObsPy when importable.
"""

from __future__ import annotations

import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Tuple

from narrow_band_least_squares_tpu_torch.utils.timeutils import parse_utc

# Well-known FDSN data centers (base URLs without the service suffix).
DATA_CENTERS = {
    "IRIS": "https://service.iris.edu",
    "EARTHSCOPE": "https://service.iris.edu",
    "GEOFON": "https://geofon.gfz-potsdam.de",
    "ORFEUS": "https://www.orfeus-eu.org",
    "USGS": "https://earthquake.usgs.gov",
    "NCEDC": "https://service.ncedc.org",
    "SCEDC": "https://service.scedc.caltech.edu",
}


def _base_url(source: str) -> str:
    if source.upper() in DATA_CENTERS:
        return DATA_CENTERS[source.upper()]
    if source.startswith("http://") or source.startswith("https://"):
        return source.rstrip("/")
    raise ValueError(
        f"unknown FDSN source {source!r}; pass a base URL or one of "
        f"{sorted(DATA_CENTERS)}"
    )


def _iso(t) -> str:
    import datetime as dt

    e = parse_utc(t)
    return dt.datetime.fromtimestamp(e, dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%f"
    )


def dataselect_url(source: str, network: str, station: str, location: str,
                   channel: str, starttime, endtime) -> str:
    """The fdsnws-dataselect query URL for a waveform window."""
    q = urllib.parse.urlencode({
        "net": network, "sta": station, "loc": location or "--",
        "cha": channel, "start": _iso(starttime), "end": _iso(endtime),
        "format": "miniseed", "nodata": "404",
    })
    return f"{_base_url(source)}/fdsnws/dataselect/1/query?{q}"


def station_url(source: str, network: str, station: str, location: str,
                channel: str, starttime, endtime) -> str:
    """The fdsnws-station query URL (channel level, text format)."""
    q = urllib.parse.urlencode({
        "net": network, "sta": station, "loc": location or "--",
        "cha": channel, "start": _iso(starttime), "end": _iso(endtime),
        "level": "channel", "format": "text", "nodata": "404",
    })
    return f"{_base_url(source)}/fdsnws/station/1/query?{q}"


def station_response_url(source: str, network: str, station: str,
                         location: str, channel: str, starttime,
                         endtime) -> str:
    """The fdsnws-station query URL for full responses (StationXML)."""
    q = urllib.parse.urlencode({
        "net": network, "sta": station, "loc": location or "--",
        "cha": channel, "start": _iso(starttime), "end": _iso(endtime),
        "level": "response", "nodata": "404",
    })
    return f"{_base_url(source)}/fdsnws/station/1/query?{q}"


def _http_get(url: str, timeout: float = 60.0) -> bytes:
    req = urllib.request.Request(
        url, headers={"User-Agent": "narrow_band_least_squares_tpu_torch/fdsn"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


@dataclass
class ChannelInfo:
    """One row of the fdsnws-station text response (channel level)."""

    sid: str            # "NET.STA.LOC.CHA"
    latitude: float
    longitude: float
    elevation: float
    sensitivity: float  # counts per physical unit (Scale column); 0 if absent
    sample_rate: float


def parse_station_text(text: str) -> List[ChannelInfo]:
    """Parse the pipe-separated fdsnws-station ``format=text`` payload.

    Header (FDSN spec): ``#Network|Station|Location|Channel|Latitude|
    Longitude|Elevation|Depth|Azimuth|Dip|SensorDescription|Scale|
    ScaleFreq|ScaleUnits|SampleRate|StartTime|EndTime``.
    """
    out: List[ChannelInfo] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        f = [c.strip() for c in line.split("|")]
        if len(f) < 15:
            continue
        sid = f"{f[0]}.{f[1]}.{f[2]}.{f[3]}"

        def flt(s, default=0.0):
            try:
                return float(s)
            except ValueError:
                return default

        out.append(ChannelInfo(
            sid=sid,
            latitude=flt(f[4]),
            longitude=flt(f[5]),
            elevation=flt(f[6]),
            sensitivity=flt(f[11]),
            sample_rate=flt(f[14]),
        ))
    return out


def gather_waveforms_fdsn(
    source: str,
    network: str,
    station: str,
    location: str,
    channel: str,
    starttime,
    endtime,
    remove_response: bool = True,
    timeout: float = 60.0,
    water_level_db: float = 60.0,
    _fetch=_http_get,
):
    """ObsPy-free ``gather_waveforms``: stdlib HTTP + native miniSEED codec.

    Returns an ``ArrayStream`` with per-element coordinates from the station
    service.  ``remove_response=True`` performs full frequency-domain
    deconvolution of the instrument transfer function (poles/zeros + FIR
    stages from the fdsnws-station ``level=response`` StationXML, water
    level ``water_level_db`` — ObsPy ``remove_response`` semantics, see
    io.response); when the response document is unavailable it falls back
    to overall-sensitivity division.  ``_fetch`` is injectable for offline
    tests.
    """
    from narrow_band_least_squares_tpu_torch.io.ingest import (
        mseed_to_stream, read_mseed_records,
    )

    ms = _fetch(dataselect_url(source, network, station, location, channel,
                               starttime, endtime), timeout)
    records = read_mseed_records(ms)
    if not records:
        raise ValueError("dataselect returned no records")
    chans = parse_station_text(
        _fetch(station_url(source, network, station, location, channel,
                           starttime, endtime), timeout).decode()
    )
    coords: Dict[str, Tuple[float, float]] = {
        c.sid: (c.latitude, c.longitude) for c in chans
    }
    st = mseed_to_stream(records, coords)
    t0, t1 = parse_utc(starttime), parse_utc(endtime)
    i0 = max(0, int(round((t0 - st.start_epoch) * st.fs)))
    i1 = min(st.npts, int(round((t1 - st.start_epoch) * st.fs)))
    st = st.slice_samples(i0, i1)
    if remove_response:
        from narrow_band_least_squares_tpu_torch.io.response import (
            parse_stationxml, remove_response as _deconvolve,
        )

        responses = {}
        try:
            xml = _fetch(
                station_response_url(source, network, station, location,
                                     channel, starttime, endtime),
                timeout,
            ).decode()
            responses = parse_stationxml(xml)
        except Exception:
            responses = {}
        sens = {c.sid: c.sensitivity for c in chans}
        for i, sid in enumerate(st.ids):
            resp = responses.get(sid)
            if resp is not None and resp.stages:
                st.data[i] = _deconvolve(
                    st.data[i], st.fs, resp, water_level_db=water_level_db,
                )
            else:
                s = sens.get(sid, 0.0)
                if s > 0:
                    st.data[i] /= s
    return st
