"""TOML configuration system, schema-compatible with the reference.

Same sections/keys/defaults as the reference's boss/config.py:24-69 so a
reference user's TOML works unchanged; adds a [tpu] section for device-mesh
options that have no reference counterpart. The template generator and the
readfish-TOML cross-validation (region name must match the experiment name,
config.py:163-183) are preserved; full readfish Conf validation is gated on
readfish being importable.

Sections are plain dataclasses; ``BossConfig.from_dict`` validates a parsed
TOML (unknown sections or keys and wrongly typed values are errors).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import tomllib
import types
import typing
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

from .utils.misc import init_logger


def _opt(default, description: str):
    """A config key: its default and the description the template prints."""
    return field(default=default, metadata={"description": description})


@dataclass
class GeneralConfig:
    name: str = _opt("boss", "Experiment name. Used as output prefix and to match readfish region name")
    ref: str | None = _opt(None, "Reference file (fasta or None). Not specifying a file switches operation to AEONS")
    mmi: str | None = _opt(None, "Index of reference (will be built if not provided)")
    toml_readfish: str | None = _opt(None, "TOML config file for readfish. Not required for simulations.")
    wait: int = _opt(60, "Waiting time between updates in live version")
    barcodes: list[str] | None = _opt(None, "List of barcodes in the experiment")


@dataclass
class LiveConfig:
    device: str | None = _opt(None, "Position on sequencing device")
    host: str = _opt("localhost", "Host of sequencing device")
    port: int = _opt(9502, "Port of sequencing device")
    data_wait: int = _opt(100, "Wait for X Mb of data before first strategy update")


@dataclass
class OptionalConfig:
    reject_refs: str | None = _opt(None, "Comma-separated list of headers in reference from which to always reject")
    ploidy: int = _opt(1, "Ploidy level")
    lowcov: int = _opt(10, "[debug] Minimum coverage")
    temperature: int = _opt(60, "[debug] Temperature")
    min_seq_len: int = _opt(2500, "[debug] Minimum sequence length")
    min_contig_len: int = _opt(10_000, "[debug] Minimum contig length")
    min_s1: int = _opt(200, "[debug] Minimum S1")
    min_map_len: int = _opt(2000, "[debug] Minimum mapping length")
    tetra: bool = _opt(True, "[debug] Switch tetranucleotide frequency tests")
    filter_repeats: bool = _opt(False, "[debug] Switch repeat filtering")
    bucket_threshold: int = _opt(5, "[debug] At which coverage to switch on the strategy in a bucket")
    resume: bool = _opt(False, "Resume from the checkpoint in out_<name>/checkpoint (live + sim)")


@dataclass
class SimulationConfig:
    fq: str | None = _opt(None, "Input fastq file")
    batchsize: int = _opt(4000, "Number of reads per update")
    maxb: int = _opt(400, "Maximum number of batches")
    binit: int = _opt(5, "Initial batch size")
    dumptime: int = _opt(200000000, "Time (in units of psudo-sequencing time) between writing output fastq files")
    paf_full: str | None = _opt(None, "Mappings (PAF) of full-length reads for fast sampling")
    paf_trunc: str | None = _opt(None, "Mappings (PAF) of truncated reads for fast sampling")
    accept_unmapped: bool = _opt(False, "Accept unmapped reads")


@dataclass
class TpuConfig:
    """Device-mesh additions (no reference counterpart)."""

    mesh_genome: int = _opt(1, "Device-mesh shards along the genome axis")
    mesh_barcode: int = _opt(1, "Device-mesh shards along the barcode axis")
    dtype: str = _opt("float32", "Device compute dtype for scores/benefits")
    use_device_aligner: bool = _opt(True, "Align with the on-device seed-and-extend kernel instead of precomputed PAFs")


class ConfigError(ValueError):
    """A TOML that does not fit the schema."""


def _type_ok(value, tp) -> bool:
    """isinstance against the annotations used above (TOML values are
    already typed, so nothing is coerced; a bool is not an int)."""
    origin = typing.get_origin(tp)
    if origin in (typing.Union, types.UnionType):
        return any(_type_ok(value, a) for a in typing.get_args(tp))
    if tp is type(None):
        return value is None
    if origin is list:
        (item,) = typing.get_args(tp)
        return isinstance(value, list) and all(_type_ok(v, item) for v in value)
    if tp is int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, tp)


def _section_from_dict(cls, data, where: str):
    if not isinstance(data, dict):
        raise ConfigError(f"[{where}] must be a table, got {type(data).__name__}")
    hints = typing.get_type_hints(cls)
    for key, value in data.items():
        if key not in hints:
            raise ConfigError(f"[{where}] unknown key '{key}' (known: {', '.join(hints)})")
        if not _type_ok(value, hints[key]):
            raise ConfigError(
                f"[{where}] {key} = {value!r}: expected {hints[key]}, got {type(value).__name__}"
            )
    return cls(**data)


@dataclass
class BossConfig:
    general: GeneralConfig = field(default_factory=GeneralConfig)
    live: LiveConfig = field(default_factory=LiveConfig)
    optional: OptionalConfig = field(default_factory=OptionalConfig)
    simulation: SimulationConfig = field(default_factory=SimulationConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    @classmethod
    def from_dict(cls, conf: dict) -> "BossConfig":
        """Validated config from a parsed TOML; raises ConfigError."""
        sections = typing.get_type_hints(cls)
        unknown = sorted(set(conf) - set(sections))
        if unknown:
            raise ConfigError(f"unknown section(s) {unknown} (known: {', '.join(sections)})")
        return cls(**{
            name: _section_from_dict(sections[name], data, name)
            for name, data in conf.items()
        })


class Config:
    """Load defaults, overlay a TOML, validate readfish cross-references."""

    def __init__(self, parse: bool = False, toml_path: str | None = None, argv=None):
        self.args = BossConfig()
        if parse or toml_path:
            path = toml_path or self._parse_toml_arg(argv)
            try:
                with Path(path).open("rb") as f:
                    conf = tomllib.load(f)
                self.args = BossConfig.from_dict(conf)
            except ConfigError as e:
                print("Invalid configuration:")
                print(e)
                sys.exit(1)

        if self.args.general.toml_readfish:
            args_readfish = tomllib.loads(
                Path(self.args.general.toml_readfish).read_text(encoding="utf-8")
            )
        else:
            args_readfish = {}

        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        Path("./logs").mkdir(parents=True, exist_ok=True)
        self.logfile = f"./logs/{stamp}_boss.log"
        init_logger(self.logfile)
        logging.getLogger("bossruns").info(dataclasses.asdict(self.args))

        # device TEST dry-runs without readfish, so nothing to cross-validate
        if self.args.live.device and self.args.live.device != "TEST":
            self._verify_region_names(self.args, args_readfish)
            self._validate_readfish_conf(args_readfish)

    @staticmethod
    def _parse_toml_arg(argv=None) -> str:
        parser = argparse.ArgumentParser(prog="bossruns")
        parser.add_argument("--toml", type=str, required=True, help="TOML configuration file")
        return parser.parse_args(argv).toml

    @staticmethod
    def _verify_region_names(args: BossConfig, args_readfish: dict) -> None:
        """Experiment name must exist as a readfish region (config.py:163-183)."""
        if not isinstance(args_readfish.get("regions"), list):
            raise ValueError("Readfish regions must be specified as array")
        region_names = {r["name"] for r in args_readfish["regions"]}
        if args.general.name not in region_names:
            raise ValueError(
                "One of the regions in readfish needs the same name as the experiment in BOSS"
            )

    @staticmethod
    def _validate_readfish_conf(args_rf: dict) -> int:
        try:
            from readfish._config import Conf  # type: ignore
        except ImportError:
            logging.getLogger("bossruns").info(
                "readfish not importable; skipping readfish TOML validation"
            )
            return 0
        try:
            Conf.from_dict(args_rf, 512)
        except Exception:
            raise ValueError("Could not load TOML config for readfish")
        return 0

    @staticmethod
    def write_template(path: Path = Path("config_template.toml")) -> None:
        col = 30
        out = ""
        for section in dataclasses.fields(BossConfig):
            out += f"\n[{section.name}]"
            for key in dataclasses.fields(section.default_factory):  # type: ignore[arg-type]
                d = key.default
                if d is None:  # TOML has no null: ship unset keys commented out
                    kv = f"# {key.name} ="
                elif isinstance(d, bool):
                    kv = f"{key.name} = {str(d).lower()}"
                elif isinstance(d, str):
                    kv = f'{key.name} = "{d}"'
                else:
                    kv = f"{key.name} = {d}"
                out += f"\n{kv:<{col}}  # {key.metadata['description']}"
            out += "\n"
        path.write_text(out)
