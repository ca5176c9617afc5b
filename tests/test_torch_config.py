"""PyTorch port: `config.NBLSConfig` against the JAX package's.

Same fields, defaults and order; the same validation errors; the same
``perf_overrides``; a file written by either package loads in the other
with equal ``to_dict()`` and ``perf_overrides()``; YAML round-trips.
"""

import dataclasses
import json

import pytest

from narrow_band_least_squares_tpu.config import NBLSConfig as JConfig
from narrow_band_least_squares_tpu_torch import NBLSConfig as PkgConfig
from narrow_band_least_squares_tpu_torch.config import NBLSConfig as TConfig


def test_defaults_and_fields_equal_jax():
    assert TConfig().to_dict() == JConfig().to_dict()
    assert json.dumps(TConfig().to_dict()) == json.dumps(JConfig().to_dict())
    tf, jf = dataclasses.fields(TConfig), dataclasses.fields(JConfig)
    assert [(f.name, f.default) for f in tf] == [(f.name, f.default) for f in jf]
    assert PkgConfig is TConfig
    with pytest.raises(dataclasses.FrozenInstanceError):
        TConfig().FMIN = 0.2


BAD = [
    ("FREQ_BAND_TYPE", "decade"),
    ("FILTER_TYPE", "bessel"),
    ("WINDOW_LENGTH_TYPE", "fixed"),
    ("WINOVER", 1.0),
    ("WINOVER", -0.1),
    ("ALPHA", 0.4),
    ("ALPHA", 1.2),
    ("MDCCM_THRESH", 1.5),
    ("FMIN", 0.0),
    ("FMAX", 0.05),
]


@pytest.mark.parametrize("field,value", BAD, ids=[f"{f}={v}" for f, v in BAD])
def test_validation_errors_match_jax(field, value):
    with pytest.raises(ValueError) as jerr:
        JConfig(**{field: value})
    with pytest.raises(ValueError) as terr:
        TConfig(**{field: value})
    assert str(terr.value) == str(jerr.value)


OVERRIDES = [
    {},
    {"xcorr_method": "fused"},
    {"xcorr_method": "fft"},
    {"window_method": "gather"},
    {"max_lag_s": 5.0},
    {"matmul_precision": "highest"},
    {"lts_funnel_k": 8},
    {"lts_funnel_k": "auto"},
    {"xcorr_chunk_mb": 4.0},
    {"xcorr_lag_tile": 0},
    {"band_limit_db": "auto"},
    {"band_limit_db": 3.0},
    {"lts_c_steps": 6},
    {"max_lag_s": 5.0, "lts_funnel_k": 8, "lts_c_steps": 6},
    {"dtype": "bfloat16", "filter_method": "scan", "mesh_shape": (2, 4)},
]


@pytest.mark.parametrize("kw", OVERRIDES, ids=[json.dumps(k, sort_keys=True) for k in OVERRIDES])
def test_perf_overrides_match_jax(kw):
    t, j = TConfig(**kw), JConfig(**kw)
    assert t.perf_overrides() == j.perf_overrides()
    assert t.to_dict() == j.to_dict()
    assert t.replace(NBANDS=3).to_dict() == j.replace(NBANDS=3).to_dict()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_json_loads_across_packages(writer, tmp_path):
    kw = dict(FMIN=0.3, FMAX=2.0, NBANDS=3, ALPHA=0.75, mesh_shape=(2, 1),
              band_limit_db="auto", lts_funnel_k="auto", lts_c_steps=5,
              max_lag_s=8.0, xcorr_method="fused", START=None, END=None)
    src, dst = (JConfig, TConfig) if writer == "jax" else (TConfig, JConfig)
    path = str(tmp_path / "cfg.json")
    src(**kw).to_json(path)
    back = dst.from_json(path)
    assert back.to_dict() == src(**kw).to_dict()
    assert back.perf_overrides() == src(**kw).perf_overrides()
    assert back.mesh_shape == (2, 1)
    # unknown keys are ignored by both, as from_dict does
    with open(path) as f:
        d = json.load(f)
    d["not_a_field"] = 1
    assert TConfig.from_dict(d).to_dict() == JConfig.from_dict(d).to_dict()


def test_yaml_round_trip(tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = TConfig(FMIN=0.2, NBANDS=4, mesh_shape=(1, 2), band_limit_db="auto")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    assert TConfig.from_yaml(str(path)) == cfg
    assert TConfig.from_yaml(str(path)).to_dict() == JConfig.from_yaml(str(path)).to_dict()
