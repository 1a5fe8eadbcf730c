"""Read-length distribution golden stats + config validation failures.

Mirrors the reference's tests/base/test_readlengthdist.py (golden lambda and
approx_ccl) and tests/base/test_config.py (broken-TOML xfail)."""
from pathlib import Path

import numpy as np
import pytest

from bossruns_tpu.config import Config
from bossruns_tpu.utils.readlen import ReadLengthDist


def test_readlen_updates_lambda_and_ccl():
    rl = ReadLengthDist()
    assert rl.lam == 6000.0 and rl.time_cost == 5300.0  # prior defaults
    rng = np.random.default_rng(0)
    lengths = rng.normal(4700, 1500, 20_000).astype(np.int64)
    lengths = lengths[lengths > 0]
    rl.update(lengths)
    kept = lengths[lengths > 800]  # < 2*mu ignored (readlengthdist.py:46)
    assert rl.lam == pytest.approx(kept.mean(), rel=1e-3)
    assert rl.time_cost == pytest.approx(rl.lam - 400 - 300)
    ccl = rl.approx_ccl
    assert ccl.shape == (10,)
    assert (np.diff(ccl) >= 0).all()  # lengths at decreasing survival probs
    # ccl[p] ~ the (1 - (p+.5)/10) quantile of the kept-length distribution
    q = np.quantile(kept, (np.arange(10) + 0.5) / 10)
    np.testing.assert_allclose(ccl, q, rtol=0.05)


def test_readlen_ignores_short_reads():
    rl = ReadLengthDist()
    rl.update(np.full(1000, 500))  # all below 2*mu = 800
    assert rl.lam == 6000.0  # unchanged


def test_config_rejects_bad_readfish_toml(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rf = tmp_path / "rf.toml"
    rf.write_text("[caller_settings]\n")  # no regions array
    toml = tmp_path / "boss.toml"
    toml.write_text(
        f'[general]\nname = "x"\nref = "r.fa"\ntoml_readfish = "{rf}"\n'
        '[live]\ndevice = "MS00001"\n'
    )
    with pytest.raises(ValueError, match="regions"):
        Config(parse=True, argv=["--toml", str(toml)])


def test_config_region_name_must_match(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rf = tmp_path / "rf.toml"
    rf.write_text('[[regions]]\nname = "other"\n')
    toml = tmp_path / "boss.toml"
    toml.write_text(
        f'[general]\nname = "x"\nref = "r.fa"\ntoml_readfish = "{rf}"\n'
        '[live]\ndevice = "MS00001"\n'
    )
    with pytest.raises(ValueError, match="same name"):
        Config(parse=True, argv=["--toml", str(toml)])


def test_config_template_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Config.write_template(tmp_path / "t.toml")
    text = (tmp_path / "t.toml").read_text()
    assert "[tpu]" in text and "batchsize = 4000" in text
    assert "# Number of reads per update" in text
    conf = Config(parse=True, argv=["--toml", str(tmp_path / "t.toml")])
    assert conf.args.optional.ploidy == 1
    assert conf.args.simulation.batchsize == 4000
    assert conf.args.general.ref is None


def test_config_reads_typed_values(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    toml = tmp_path / "boss.toml"
    toml.write_text(
        '[general]\nname = "x"\nbarcodes = ["barcode01", "barcode02"]\n'
        '[optional]\ntetra = false\nploidy = 2\n[tpu]\nmesh_genome = 4\n'
    )
    args = Config(parse=True, argv=["--toml", str(toml)]).args
    assert args.general.barcodes == ["barcode01", "barcode02"]
    assert args.optional.tetra is False and args.optional.ploidy == 2
    assert args.tpu.mesh_genome == 4 and args.tpu.mesh_barcode == 1
    assert args.simulation.batchsize == 4000  # untouched sections keep defaults


@pytest.mark.parametrize("body, message", [
    ('[general]\nnmae = "x"\n', "unknown key 'nmae'"),
    ('[genral]\nname = "x"\n', "unknown section"),
    ('[simulation]\nbatchsize = "4000"\n', "batchsize"),
    ('[optional]\nploidy = true\n', "ploidy"),
    ('[general]\nbarcodes = ["barcode01", 2]\n', "barcodes"),
    ('[optional]\ntetra = 1\n', "tetra"),
])
def test_config_rejects_invalid_toml(tmp_path, monkeypatch, capsys, body, message):
    monkeypatch.chdir(tmp_path)
    toml = tmp_path / "boss.toml"
    toml.write_text(body)
    with pytest.raises(SystemExit) as exc:
        Config(parse=True, argv=["--toml", str(toml)])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "Invalid configuration" in out and message in out
