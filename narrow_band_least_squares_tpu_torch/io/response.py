"""Full instrument-response deconvolution, dependency-free.

The port's copy of ``narrow_band_least_squares_tpu/io/response.py``, the
same host NumPy line for line, so the two packages give the same bits.  It
runs once per fetch on the ``ArrayStream``'s float64 data, before anything
reaches the card.  The reference's contract is ``gather_waveforms(...,
remove_response=True)`` (reference ``example.py:91``), which ObsPy fulfils
by dividing the data spectrum by the instrument transfer function with
water-level stabilisation:

- `parse_stationxml`: FDSN StationXML (fdsnws-station ``level=response``)
  -> per-channel `InstrumentResponse` (poles/zeros stages, coefficient/FIR
  stages, stage gains, overall sensitivity) via stdlib ElementTree.
- `evaluate_response`: complex counts-per-physical-unit transfer function on
  a frequency grid (Laplace rad/s / Hz and z-transform conventions, FIR
  stages with their documented delay correction).
- `remove_response`: frequency-domain deconvolution with the same
  water-level algorithm ObsPy uses (``invert_spectrum`` semantics) and an
  optional pre-filter cosine taper in the frequency domain.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class PolesZerosStage:
    """One <PolesZeros> response stage."""

    poles: np.ndarray             # complex
    zeros: np.ndarray             # complex
    normalization: float          # A0
    normalization_freq: float     # Hz
    gain: float                   # stage gain at its reference frequency
    transfer_type: str            # 'LAPLACE (RADIANS/SECOND)' | '(HERTZ)' |
    #                               'DIGITAL (Z-TRANSFORM)'
    input_sample_rate: float = 0.0  # for digital stages


@dataclass
class CoefficientsStage:
    """One <Coefficients>/<FIR> stage (digital filter)."""

    numerator: np.ndarray         # FIR taps (empty -> gain-only)
    gain: float
    input_sample_rate: float      # Hz (Decimation/InputSampleRate)
    delay_correction: float = 0.0  # seconds (Decimation/Correction)


@dataclass
class InstrumentResponse:
    """Full multi-stage response of one channel."""

    sensitivity: float            # overall counts per physical unit
    sensitivity_freq: float
    stages: List[object] = field(default_factory=list)
    input_units: str = ""

    def stage_gain_product(self) -> float:
        g = 1.0
        for s in self.stages:
            if s.gain:
                g *= s.gain
        return g


# --------------------------------------------------------------------------
# StationXML parsing
# --------------------------------------------------------------------------

def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _find(el, name):
    for c in el:
        if _local(c.tag) == name:
            return c
    return None


def _findall(el, name):
    return [c for c in el if _local(c.tag) == name]


def _text_float(el, name, default=0.0):
    c = _find(el, name)
    if c is None or c.text is None:
        return default
    try:
        return float(c.text.strip())
    except ValueError:
        return default


def _complex_list(stage_el, name) -> np.ndarray:
    vals = []
    for z in _findall(stage_el, name):
        re = _text_float(z, "Real")
        im = _text_float(z, "Imaginary")
        vals.append(complex(re, im))
    return np.asarray(vals, dtype=complex)


def _parse_stage(stage_el):
    pz = _find(stage_el, "PolesZeros")
    gain_el = _find(stage_el, "StageGain")
    gain = _text_float(gain_el, "Value", 1.0) if gain_el is not None else 1.0
    deci = _find(stage_el, "Decimation")
    in_sr = _text_float(deci, "InputSampleRate") if deci is not None else 0.0
    corr = _text_float(deci, "Correction") if deci is not None else 0.0
    if pz is not None:
        tf = _find(pz, "PzTransferFunctionType")
        return PolesZerosStage(
            poles=_complex_list(pz, "Pole"),
            zeros=_complex_list(pz, "Zero"),
            normalization=_text_float(pz, "NormalizationFactor", 1.0),
            normalization_freq=_text_float(pz, "NormalizationFrequency", 1.0),
            gain=gain,
            transfer_type=(tf.text.strip().upper() if tf is not None
                           and tf.text else "LAPLACE (RADIANS/SECOND)"),
            input_sample_rate=in_sr,
        )
    coef = _find(stage_el, "Coefficients") or _find(stage_el, "FIR")
    if coef is not None:
        num = np.asarray(
            [float(n.text) for n in _findall(coef, "Numerator")
             if n.text is not None],
            dtype=float,
        )
        if num.size == 0:
            num = np.asarray(
                [float(n.text) for n in _findall(coef, "NumeratorCoefficient")
                 if n.text is not None],
                dtype=float,
            )
        return CoefficientsStage(
            numerator=num, gain=gain, input_sample_rate=in_sr,
            delay_correction=corr,
        )
    if gain_el is not None:
        return CoefficientsStage(
            numerator=np.zeros(0), gain=gain, input_sample_rate=in_sr,
        )
    return None


def parse_stationxml(xml_text: str) -> Dict[str, InstrumentResponse]:
    """FDSN StationXML -> ``{"NET.STA.LOC.CHA": InstrumentResponse}``.

    Only the <Response> subtree is consumed; coordinates keep coming from
    the text-format station query (io.fdsn.parse_station_text).
    """
    root = ET.fromstring(xml_text)
    out: Dict[str, InstrumentResponse] = {}
    for net in _findall(root, "Network"):
        ncode = net.get("code", "")
        for sta in _findall(net, "Station"):
            scode = sta.get("code", "")
            for cha in _findall(sta, "Channel"):
                sid = ".".join([
                    ncode, scode,
                    (cha.get("locationCode") or "").strip(),
                    cha.get("code", ""),
                ])
                resp_el = _find(cha, "Response")
                if resp_el is None:
                    continue
                sens_el = _find(resp_el, "InstrumentSensitivity")
                sens = _text_float(sens_el, "Value", 0.0) if sens_el is not None else 0.0
                sens_f = _text_float(sens_el, "Frequency", 1.0) if sens_el is not None else 1.0
                units = ""
                if sens_el is not None:
                    iu = _find(sens_el, "InputUnits")
                    if iu is not None:
                        nm = _find(iu, "Name")
                        units = (nm.text or "").strip() if nm is not None else ""
                stages = []
                stage_els = sorted(
                    _findall(resp_el, "Stage"),
                    key=lambda e: int(e.get("number", "0") or 0),
                )
                for se in stage_els:
                    st = _parse_stage(se)
                    if st is not None:
                        stages.append(st)
                out[sid] = InstrumentResponse(
                    sensitivity=sens, sensitivity_freq=sens_f,
                    stages=stages, input_units=units,
                )
    return out


# --------------------------------------------------------------------------
# Response evaluation
# --------------------------------------------------------------------------

def _eval_pz(stage: PolesZerosStage, freqs: np.ndarray) -> np.ndarray:
    tt = stage.transfer_type
    if "HERTZ" in tt:
        s = 1j * freqs
    elif "Z-TRANSFORM" in tt or "DIGITAL" in tt:
        fs = stage.input_sample_rate or 1.0
        z = np.exp(1j * 2.0 * np.pi * freqs / fs)
        num = np.ones_like(z)
        for zz in stage.zeros:
            num *= (1.0 - zz / z)
        den = np.ones_like(z)
        for pp in stage.poles:
            den *= (1.0 - pp / z)
        with np.errstate(divide="ignore", invalid="ignore"):
            h = stage.normalization * num / den
        return h * stage.gain
    else:
        s = 2j * np.pi * freqs
    num = np.ones_like(s)
    for zz in stage.zeros:
        num *= (s - zz)
    den = np.ones_like(s)
    for pp in stage.poles:
        den *= (s - pp)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = stage.normalization * num / den
    h = np.where(np.isfinite(h), h, 0.0)
    return h * stage.gain


def _eval_fir(stage: CoefficientsStage, freqs: np.ndarray) -> np.ndarray:
    if stage.numerator.size == 0:
        return np.full(freqs.shape, stage.gain, dtype=complex)
    fs = stage.input_sample_rate or 1.0
    k = np.arange(stage.numerator.size)
    # H(f) = sum_k c_k e^{-i 2 pi f k / fs}; evalresp-style delay correction
    # re-centers the (linear-phase) FIR so it contributes magnitude only
    ang = -2j * np.pi * freqs[:, None] * k[None, :] / fs
    h = (stage.numerator[None, :] * np.exp(ang)).sum(axis=1)
    if stage.delay_correction:
        h = h * np.exp(2j * np.pi * freqs * stage.delay_correction)
    return h * stage.gain


def evaluate_response(
    resp: InstrumentResponse, freqs: np.ndarray,
    use_overall_sensitivity: bool = True,
) -> np.ndarray:
    """Complex transfer function (counts per physical input unit) at freqs.

    With ``use_overall_sensitivity`` the product of normalized stage shapes
    is scaled by the reported overall sensitivity (ObsPy's default); else
    the per-stage gains are used directly.
    """
    freqs = np.asarray(freqs, dtype=float)
    h = np.ones(freqs.shape, dtype=complex)
    for st in resp.stages:
        if isinstance(st, PolesZerosStage):
            h = h * _eval_pz(st, freqs)
        else:
            h = h * _eval_fir(st, freqs)
    if use_overall_sensitivity and resp.sensitivity > 0:
        gains = resp.stage_gain_product()
        if gains > 0:
            h = h * (resp.sensitivity / gains)
    return h


# --------------------------------------------------------------------------
# Deconvolution
# --------------------------------------------------------------------------

def _invert_spectrum_water_level(spec: np.ndarray, water_level_db: float):
    """ObsPy ``invert_spectrum`` semantics: clamp |spec| at
    ``max|spec| * 10^(-wl/20)`` (keeping phase), then invert."""
    wl = np.abs(spec).max() * 10.0 ** (-water_level_db / 20.0)
    mag = np.abs(spec)
    if wl <= 0:
        inv = np.zeros_like(spec)
        nz = mag > 0
        inv[nz] = 1.0 / spec[nz]
        return inv
    zero = mag == 0.0
    low = (mag < wl) & ~zero
    spec = spec.copy()
    spec[zero] = wl
    spec[low] *= wl / mag[low]
    return 1.0 / spec


def _cosine_prefilt(freqs: np.ndarray, f1, f2, f3, f4) -> np.ndarray:
    """ObsPy-style cosine taper in the frequency domain: 0 below f1 / above
    f4, 1 between f2..f3, cosine ramps in between."""
    t = np.ones_like(freqs)
    t[freqs <= f1] = 0.0
    t[freqs >= f4] = 0.0
    up = (freqs > f1) & (freqs < f2)
    t[up] = 0.5 * (1 - np.cos(np.pi * (freqs[up] - f1) / (f2 - f1)))
    dn = (freqs > f3) & (freqs < f4)
    t[dn] = 0.5 * (1 + np.cos(np.pi * (freqs[dn] - f3) / (f4 - f3)))
    return t


def remove_response(
    data: np.ndarray,
    fs: float,
    resp: InstrumentResponse,
    water_level_db: float = 60.0,
    pre_filt: Optional[Sequence[float]] = None,
    demean: bool = True,
) -> np.ndarray:
    """Deconvolve the instrument response from one trace (counts -> physical).

    Frequency-domain division with water-level stabilization — the same
    algorithm as ObsPy ``Trace.remove_response`` (reference L0 contract,
    ``example.py:91``).
    """
    x = np.asarray(data, dtype=np.float64)
    if demean:
        x = x - x.mean()
    n = x.size
    nfft = 1 << int(np.ceil(np.log2(max(2 * n, 2))))
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    h = evaluate_response(resp, freqs)
    inv = _invert_spectrum_water_level(h, water_level_db)
    spec = np.fft.rfft(x, n=nfft)
    spec = spec * inv
    if pre_filt is not None:
        spec = spec * _cosine_prefilt(freqs, *pre_filt)
    spec[0] = 0.0
    return np.fft.irfft(spec, n=nfft)[:n]
