"""Tests: ProcessingParams serde compatibility with the reference's preset format."""
import pathlib

import pytest

from sarpro_tpu.params import ProcessingParams
from sarpro_tpu.types import (
    AutoscaleStrategy,
    BitDepthArg,
    OutputFormat,
    Polarization,
    PolarizationOperation,
    SyntheticRgbMode,
)


def test_defaults_match_reference():
    """reference: src/core/params.rs:26-41."""
    p = ProcessingParams()
    assert p.format is OutputFormat.TIFF
    assert p.bit_depth is BitDepthArg.U8
    assert p.polarization == Polarization.VV
    assert p.autoscale is AutoscaleStrategy.CLAHE
    assert p.synrgb_mode is SyntheticRgbMode.DEFAULT
    assert p.size is None and p.pad is False
    assert p.target_crs is None
    assert p.resample_alg == "lanczos"


def test_json_roundtrip_all_fields():
    p = ProcessingParams(
        format=OutputFormat.JPEG,
        bit_depth=BitDepthArg.U16,
        polarization=Polarization.OP(PolarizationOperation.LOG_RATIO),
        autoscale=AutoscaleStrategy.TAMED,
        synrgb_mode=SyntheticRgbMode.SAR_URBAN,
        size=1536,
        pad=True,
        target_crs="EPSG:32633",
        resample_alg="cubic",
    )
    q = ProcessingParams.from_json(p.to_json())
    assert q == p


def test_serde_spellings_match_reference():
    """serde serializes Rust variant names: TIFF/JPEG, U8/U16, Clahe, OP map."""
    d = ProcessingParams(
        polarization=Polarization.OP(PolarizationOperation.NDIFF)
    ).to_dict()
    assert d["format"] == "TIFF"
    assert d["bit_depth"] == "U8"
    assert d["autoscale"] == "Clahe"
    assert d["polarization"] == {"OP": "NDiff"}
    assert d["input_format"] == "Safe"
    assert d["synrgb_mode"] == "Default"


def test_commented_preset_header():
    """GUI presets carry a //-comment header before the JSON
    (reference: src/gui/models.rs:278-309)."""
    text = "// SARPRO preset\n// second line\n" + ProcessingParams(
        autoscale=AutoscaleStrategy.ROBUST
    ).to_json()
    p = ProcessingParams.from_json(text)
    assert p.autoscale is AutoscaleStrategy.ROBUST


def test_reference_style_preset_parses():
    """A preset as the reference GUI would write it."""
    text = """// SARPRO Processing Preset
{
  "format": "JPEG",
  "input_format": "Safe",
  "bit_depth": "U8",
  "polarization": "Multiband",
  "autoscale": "Tamed",
  "synrgb_mode": "Default",
  "size": 2048,
  "pad": true,
  "target_crs": "auto",
  "resample_alg": "cubic"
}"""
    p = ProcessingParams.from_json(text)
    assert p.format is OutputFormat.JPEG
    assert p.polarization == Polarization.MULTIBAND
    assert p.autoscale is AutoscaleStrategy.TAMED
    assert p.size == 2048 and p.pad
    assert p.target_crs == "auto"


def test_invalid_enum_rejected():
    with pytest.raises(ValueError):
        ProcessingParams.from_dict({"autoscale": "bogus"})
    with pytest.raises(ValueError):
        Polarization.from_cli("xx")


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_helper(tmp_path, monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and the helper sets nothing;
    otherwise the cache goes to the fixed in-checkout directory."""
    import jax

    from sarpro_tpu.utils import compilation_cache as cc

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        target = tmp_path / "envcache"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
        assert cc.enable_compilation_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == before
        return
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert cc.DEFAULT_DIR == repo / ".jax_cache"
    # the checkout's own cache directory is not written by the test run
    target = tmp_path / "fixed"
    monkeypatch.setattr(cc, "DEFAULT_DIR", target)
    try:
        assert cc.enable_compilation_cache() == str(target)
        assert target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
